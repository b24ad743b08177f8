"""GQA attention: prefill (whole sequence) and decode (cache) paths (port
of ``repro.models.attention``).

Features per the assigned archs: GQA (any kv ratio incl. MQA), qk-norm
applied before RoPE (qwen3/chameleon), QKV bias (qwen1.5), RoPE,
sliding-window local attention (recurrentgemma).  One device: no
sharding constraints.

Prefill picks its attention from ``pctx.attn_impl`` (window None):
``"flash"`` runs the flash kernels' wrapper ``flash_fwd`` on any device
and at any prompt length -- a CUDA kernel on the card (bf16 at head dims
64, 128 and 256 on the tensor cores, the rest on the CUDA cores), the plain
version on the CPU; ``"full"`` runs ``attention_ref``; ``"chunked"`` and
windows run ``chunked_attention``.  (The reference's accelerator path
needs a prompt longer than 128 tokens to be a multiple of 128; off the
TPU it runs ``chunked_attention``, which serves any length, as this path
does.)
Decode is plain PyTorch, as the reference's jnp decode.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.flash_attention.kernel import flash_fwd
from repro_torch.kernels.flash_attention.ops import chunked_attention
from repro_torch.kernels.flash_attention.ref import NEG_INF, attention_ref
from repro_torch.parallel.sharding import ParallelCtx
from . import layers as L


class KVCache(NamedTuple):
    k: torch.Tensor           # (B, Hkv, S_max, hd)
    v: torch.Tensor


def init(gen: torch.Generator, cfg) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {"wq": L.dense_init(gen, d, H * hd),
         "wk": L.dense_init(gen, d, KV * hd),
         "wv": L.dense_init(gen, d, KV * hd),
         "wo": L.dense_init(gen, H * hd, d)}
    dev = gen.device
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H * hd,), device=dev)
        p["bk"] = torch.zeros((KV * hd,), device=dev)
        p["bv"] = torch.zeros((KV * hd,), device=dev)
    if cfg.qk_norm:
        p["q_scale"] = torch.ones((hd,), device=dev)
        p["k_scale"] = torch.ones((hd,), device=dev)
    return p


def _project_qkv(params, x, cfg, positions):
    """x: (B, S, d) -> q (B, H, S, hd), k/v (B, KV, S, hd), roped."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = x.dtype
    q = x @ params["wq"].to(dt)
    k = x @ params["wk"].to(dt)
    v = x @ params["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    q = q.reshape(B, S, H, hd).transpose(1, 2)
    k = k.reshape(B, S, KV, hd).transpose(1, 2)
    v = v.reshape(B, S, KV, hd).transpose(1, 2)
    if cfg.qk_norm:
        q = _headnorm(q, params["q_scale"], cfg.norm_eps)
        k = _headnorm(k, params["k_scale"], cfg.norm_eps)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _headnorm(x, scale, eps):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def apply_full(params, x, cfg, pctx: ParallelCtx, *, local: bool = False):
    """Prefill attention over the whole sequence.  Returns (out,
    KVCache)."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)
    q, k, v = _project_qkv(params, x, cfg, positions)
    window = cfg.attn_window if (local and cfg.attn_window and
                                 cfg.attn_window < S) else None
    if window is None and pctx.attn_impl == "flash":
        o = flash_fwd(q, k, v, scale=cfg.hd ** -0.5, causal=True)
    elif window is None and pctx.attn_impl == "full":
        o = attention_ref(q, k, v, causal=True)
    else:
        o = chunked_attention(q, k, v, causal=True, window=window,
                              bkv=min(512, S))
    o = o.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.hd)
    out = o @ params["wo"].to(x.dtype)
    return out, KVCache(k, v)


def init_cache(cfg, batch: int, max_len: int, dtype, device) -> KVCache:
    shape = (batch, cfg.n_kv_heads, max_len, cfg.hd)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def apply_decode(params, x_t, cache: KVCache, pos, cfg, pctx: ParallelCtx,
                 *, local: bool = False):
    """One decode step. x_t: (B, 1, d); pos: scalar or (B,) positions
    (per-slot positions support the continuous-batching engine).

    Writes each slot's new key and value into ``cache`` in place at its
    position (clamped to the cache, as ``dynamic_update_slice`` clamps)
    and returns (out (B, 1, d), cache)."""
    B = x_t.shape[0]
    pos_b = torch.as_tensor(pos, device=x_t.device).to(torch.int64) \
        .broadcast_to((B,))
    q, k_new, v_new = _project_qkv(params, x_t, cfg, pos_b[:, None, None])
    S = cache.k.shape[2]
    slots = torch.arange(B, device=x_t.device)
    at = pos_b.clamp(0, S - 1)
    cache.k[slots, :, at] = k_new[:, :, 0].to(cache.k.dtype)
    cache.v[slots, :, at] = v_new[:, :, 0].to(cache.v.dtype)
    hkv, hd = cfg.n_kv_heads, cfg.hd
    group = cfg.n_heads // hkv
    scale = 1.0 / (hd ** 0.5)
    qg = (q.float() * scale).reshape(B, hkv, group, hd)
    s = torch.einsum("bngd,bnkd->bngk", qg, cache.k.float())
    k_pos = torch.arange(S, device=x_t.device)
    valid = k_pos[None, :] <= pos_b[:, None]
    if local and cfg.attn_window:
        valid &= k_pos[None, :] > pos_b[:, None] - cfg.attn_window
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bngk,bnkd->bngd", p, cache.v.float())
    o = o.reshape(B, 1, cfg.n_heads * hd).to(x_t.dtype)
    out = o @ params["wo"].to(x_t.dtype)
    return out, cache
