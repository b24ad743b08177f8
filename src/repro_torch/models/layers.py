"""Shared model primitives: norms, RoPE, initializers, dense MLPs, embedding
and heads (port of ``repro.models.layers``; the training losses wait for
the training slice).

Parameters are trees addressed like the reference's dicts
(``p["w_gate"]``, ``p["norm1"]["scale"]``): :class:`Params` holds one
level of such a tree as an ``nn.Module``.  Masters are float32; each use
casts them to the compute dtype (``cfg.dtype``), as the reference does,
and norms and softmax statistics accumulate in float32.  Initializers
follow the reference's distributions from an explicit ``torch.Generator``
(the bits cannot match JAX's keys: tests carry the reference's weights
across instead).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Params(nn.Module):
    """One level of a parameter tree: tensors become (frozen) parameters,
    dicts become child :class:`Params`; ``p[name]`` reads either."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, val in tree.items():
            if isinstance(val, dict):
                self.add_module(name, Params(val))
            else:
                self.register_parameter(
                    name, nn.Parameter(val, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)


def cdtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               scale: float | None = None) -> torch.Tensor:
    scale = scale if scale is not None else d_in ** -0.5
    return torch.randn((d_in, d_out), generator=gen,
                       device=gen.device) * scale


def rmsnorm_init(d: int, device) -> dict:
    return {"scale": torch.ones((d,), device=device)}


def rmsnorm(params, x, eps: float):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"]).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(hd: int, theta: float, device=None):
    return theta ** (-torch.arange(0, hd, 2, dtype=torch.float32,
                                   device=device) / hd)


def apply_rope(x, positions, theta: float):
    """x: (..., S, hd); positions: (S,) or broadcastable to x[..., :, 0]."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (hd/2,)
    ang = positions[..., :, None].float() * freqs             # (..., S, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLPs (SwiGLU / GeGLU-style)
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, d: int, f: int) -> dict:
    return {"w_gate": dense_init(gen, d, f),
            "w_in": dense_init(gen, d, f),
            "w_out": dense_init(gen, f, d)}


def mlp_apply(params, x, *, act: str = "silu"):
    dt = x.dtype
    gate = x @ params["w_gate"].to(dt)
    up = x @ params["w_in"].to(dt)
    # jax.nn.gelu's default is the tanh approximation
    actv = F.silu if act == "silu" else \
        (lambda t: F.gelu(t, approximate="tanh"))
    h = actv(gate.float()).to(dt) * up
    return h @ params["w_out"].to(dt)


# ---------------------------------------------------------------------------
# Embedding / heads
# ---------------------------------------------------------------------------

def embed_init(gen: torch.Generator, vocab: int, d: int,
               n_codebooks: int = 0) -> dict:
    shape = (n_codebooks, vocab, d) if n_codebooks else (vocab, d)
    return {"tok": torch.randn(shape, generator=gen, device=gen.device)}


def embed_apply(params, tokens, cfg):
    """tokens: (B, S) or, with codebooks, (B, S, ncb) -> (B, S, d).  Rows
    are gathered, then cast: the same bits as the reference's cast of the
    whole table before its take, without the table's copy."""
    dt = cdtype(cfg)
    tok = params["tok"]
    if cfg.n_codebooks:
        return sum(tok[c][tokens[..., c]].to(dt)
                   for c in range(cfg.n_codebooks))
    return tok[tokens].to(dt)


def head_init(gen: torch.Generator, cfg) -> dict:
    if cfg.tie_embeddings:
        return {}
    d, v = cfg.d_model, cfg.vocab_size
    shape = (cfg.n_codebooks, d, v) if cfg.n_codebooks else (d, v)
    return {"lm_head": torch.randn(shape, generator=gen, device=gen.device)
            * d ** -0.5}


def head_apply(head_params, embed_params, x, cfg):
    """x: (B, S, d) -> logits (B, S, V) or (B, S, ncb, V)."""
    dt = x.dtype
    if cfg.n_codebooks:
        w = (embed_params["tok"].transpose(1, 2) if cfg.tie_embeddings
             else head_params["lm_head"])                  # (ncb, d, V)
        logits = torch.einsum("bsd,cdv->bscv", x, w.to(dt))
    else:
        w = (embed_params["tok"].T if cfg.tie_embeddings
             else head_params["lm_head"])
        logits = x @ w.to(dt)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits.float() / c) * c
    return logits
