"""Unified LM (port of ``repro.models.transformer``): every assigned
architecture, on one device.

The model is an ``nn.Module`` holding one sub-layer per layer: the
reference's scan over stacked plan periods (plus unrolled tail layers)
becomes a Python loop over layers ``0 .. n_layers - 1``, layer ``li``
running ``cfg.plan[li % cfg.period]``.  Caches are a list of one cache
per layer: a :class:`~repro_torch.models.attention.KVCache` for an
attention layer, a :class:`~repro_torch.models.ssm.SSMCache` for an SSD
layer, a :class:`~repro_torch.models.rglru.RGLRUCache` for an RG-LRU
layer.

Entry points (``params`` is the :class:`Transformer`):
  init_params(gen, cfg)                     -> Transformer
  load_jax_params(cfg, params_np, device)   -> Transformer
  init_caches(cfg, batch, max_len, dtype, device) -> [cache, ...]
  prefill(params, tokens, cfg, pctx)        -> (last_logits, caches)
  decode_step(params, token, caches, pos, cfg, pctx) -> (logits, caches)

A mixer or MLP name outside ``MIXERS`` or ``MLPS`` raises
``NotImplementedError``.  The MoE MLP's aux loss is dropped by serving, as
in the reference's ``prefill`` and ``decode_step``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.core.formats import resolve_device
from repro_torch.parallel.sharding import ParallelCtx
from . import attention, moe, rglru, ssm
from . import layers as L

MIXERS = ("attn", "attn_local", "ssd", "rglru")
MLPS = ("swiglu", "gated_mlp", "moe", "none")


def layer_plan(cfg) -> list:
    """(mixer, mlp) of every layer, checked against the names the port
    runs."""
    for mixer, mlp in cfg.plan:
        if mixer not in MIXERS or mlp not in MLPS:
            raise NotImplementedError(
                f"{cfg.name}: sub-layer ({mixer}, {mlp}) is unknown; the "
                f"port runs the mixers {MIXERS} and the MLPs {MLPS}")
    return [cfg.plan[li % cfg.period] for li in range(cfg.n_layers)]


class Transformer(nn.Module):
    """The parameters of one model: ``embed``, ``head``, ``final_norm``
    and ``layers[li]`` (``norm1``, ``mixer`` and, unless the MLP is
    ``"none"``, ``norm2`` and ``mlp``), each addressed like the
    reference's parameter dicts."""

    def __init__(self, tree: dict):
        super().__init__()
        self.embed = L.Params(tree["embed"])
        self.head = L.Params(tree["head"])
        self.final_norm = L.Params(tree["final_norm"])
        self.layers = nn.ModuleList(L.Params(p) for p in tree["layers"])


#: the mixers whose cache is a fixed-size state (conv window, recurrence)
RECURRENT = {"ssd": ssm, "rglru": rglru}


def _init_sublayer(gen, cfg, mixer: str, mlp: str) -> dict:
    p = {"norm1": L.rmsnorm_init(cfg.d_model, gen.device),
         "mixer": RECURRENT.get(mixer, attention).init(gen, cfg)}
    if mlp != "none":
        p["norm2"] = L.rmsnorm_init(cfg.d_model, gen.device)
        p["mlp"] = moe.init(gen, cfg) if mlp == "moe" else \
            L.mlp_init(gen, cfg.d_model, cfg.d_ff)
    return p


def init_params(gen: torch.Generator, cfg) -> Transformer:
    """Random weights with the reference's distributions, drawn from
    ``gen`` on its device."""
    plan = layer_plan(cfg)
    tree = {"embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model,
                                  cfg.n_codebooks),
            "head": L.head_init(gen, cfg),
            "final_norm": L.rmsnorm_init(cfg.d_model, gen.device),
            "layers": [_init_sublayer(gen, cfg, *ml) for ml in plan]}
    return Transformer(tree)


def load_jax_params(cfg, params_np, device=None) -> Transformer:
    """The reference's ``init_params`` pytree, as numpy arrays, carried
    into the port on ``device`` (``cuda`` unless named): the stacked
    ``periods`` axis is unstacked into layers, ``tail`` follows, and a
    tied head stays tied to the embedding."""
    plan = layer_plan(cfg)
    device = resolve_device(device)

    def tree(x):
        if isinstance(x, dict):
            return {k: tree(v) for k, v in x.items()}
        return torch.from_numpy(np.array(x, np.float32)).to(device)

    layers = []
    if params_np["periods"] is not None:
        for i in range(cfg.n_full_periods):
            for j in range(cfg.period):
                layers.append(_index(params_np["periods"][j], i))
    layers.extend(params_np["tail"])
    if len(layers) != len(plan):
        raise ValueError(f"{cfg.name}: {len(layers)} layers in the params, "
                         f"{len(plan)} in the config")
    return Transformer({
        "embed": tree(params_np["embed"]), "head": tree(params_np["head"]),
        "final_norm": tree(params_np["final_norm"]),
        "layers": [tree(p) for p in layers]})


def _index(x, i):
    if isinstance(x, dict):
        return {k: _index(v, i) for k, v in x.items()}
    return x[i]


def init_caches(cfg, batch: int, max_len: int, dtype, device) -> list:
    return [RECURRENT[mixer].init_cache(cfg, batch, dtype, device)
            if mixer in RECURRENT
            else attention.init_cache(cfg, batch, max_len, dtype, device)
            for mixer, _ in layer_plan(cfg)]


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def _mlp(p, x, cfg, pctx, mlp: str):
    if mlp == "none":
        return x
    h = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
    if mlp == "moe":
        y, _ = moe.apply(p["mlp"], h, cfg, pctx)     # serving drops aux
        return x + y
    return x + L.mlp_apply(p["mlp"], h,
                           act=("gelu" if mlp == "gated_mlp" else "silu"))


def prefill(params: Transformer, tokens, cfg, pctx: ParallelCtx):
    """tokens: (B, S) or (B, S, ncb).  Returns (last-position logits,
    caches at length S)."""
    x = L.embed_apply(params.embed, tokens, cfg)
    caches = []
    for p, (mixer, mlp) in zip(params.layers, layer_plan(cfg)):
        h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
        if mixer in RECURRENT:
            y, cache = RECURRENT[mixer].apply_full(p["mixer"], h, cfg)
        else:
            y, cache = attention.apply_full(p["mixer"], h, cfg, pctx,
                                            local=(mixer == "attn_local"))
        x = _mlp(p, x + y, cfg, pctx, mlp)
        caches.append(cache)
    x_last = L.rmsnorm(params.final_norm, x[:, -1:, :], cfg.norm_eps)
    return L.head_apply(params.head, params.embed, x_last, cfg), caches


def decode_step(params: Transformer, token, caches, pos, cfg,
                pctx: ParallelCtx):
    """token: (B, 1) or (B, 1, ncb); pos: scalar or (B,) write positions.

    Each layer's cache is written in place; returns (logits (B, 1, V...),
    caches)."""
    x = L.embed_apply(params.embed, token, cfg)
    for p, cache, (mixer, mlp) in zip(params.layers, caches,
                                      layer_plan(cfg)):
        h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
        if mixer in RECURRENT:
            y, _ = RECURRENT[mixer].apply_decode(p["mixer"], h, cache, cfg)
        else:
            y, _ = attention.apply_decode(p["mixer"], h, cache, pos, cfg,
                                          pctx, local=(mixer == "attn_local"))
        x = _mlp(p, x + y, cfg, pctx, mlp)
    x = L.rmsnorm(params.final_norm, x, cfg.norm_eps)
    return L.head_apply(params.head, params.embed, x, cfg), caches
