"""Mamba-2 SSD (state-space duality) mixer [arXiv:2405.21060] (port of
``repro.models.ssm``).

Prefill path: the chunk scan runs through the SSD chunk kernel's wrapper
(``kernels.ssd_chunk.ops.ssd_chunk``: the CUDA kernel on the card, its
plain version on the CPU) where the reference runs the jnp
``ssd_chunked``; the two compute the same function.  Decode path is the
O(1)-state recurrence in plain PyTorch, as the reference's, and writes the
cache in place (the reference returns new arrays).  Chunk length is the
largest divisor of S up to ``cfg.ssm.chunk``, as the reference picks it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_chunk.ops import ssd_chunk
from . import layers as L


class SSMCache(NamedTuple):
    conv: torch.Tensor   # (B, d_conv-1, conv_channels) trailing inputs
    h: torch.Tensor      # (B, nh, head_dim, d_state) float32


def dims(cfg):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    conv_ch = d_in + 2 * s.n_groups * s.d_state
    return d_in, nh, conv_ch


def init(gen: torch.Generator, cfg) -> dict:
    """Random weights with the reference's distributions, from ``gen``."""
    s = cfg.ssm
    d = cfg.d_model
    d_in, nh, conv_ch = dims(cfg)
    dev = gen.device
    return {
        "in_proj": L.dense_init(gen, d, 2 * d_in + 2 * s.n_groups * s.d_state
                                + nh),
        "conv_w": torch.randn((s.d_conv, conv_ch), generator=gen, device=dev)
                  * (s.d_conv ** -0.5),
        "conv_b": torch.zeros((conv_ch,), device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, device=dev)),
        "dt_bias": torch.zeros((nh,), device=dev),
        "D": torch.ones((nh,), device=dev),
        "norm_scale": torch.ones((d_in,), device=dev),
        "out_proj": L.dense_init(gen, d_in, d),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv1d. x: (B, S, C); w: (K, C)."""
    K = w.shape[0]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + x.shape[1], :] * w[i] for i in range(K))
    return out + b


def _gated_norm(y, z, scale, eps):
    yf = y.float() * F.silu(z.float())
    var = (yf * yf).mean(dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * scale).to(y.dtype)


def _pick_chunk(s: int, chunk: int) -> int:
    """Largest divisor of s that is <= the configured chunk."""
    c = min(chunk, s)
    while s % c:
        c -= 1
    return max(c, 1)


def _split_proj(cfg, zxbcdt):
    s = cfg.ssm
    d_in, nh, _ = dims(cfg)
    gn = s.n_groups * s.d_state
    return torch.split(zxbcdt, [d_in, d_in + 2 * gn, nh], dim=-1)


def apply_full(params, x, cfg):
    """Prefill. x: (B, S, d) -> (y, SSMCache)."""
    s = cfg.ssm
    d_in, nh, conv_ch = dims(cfg)
    gn = s.n_groups * s.d_state
    dt_ = x.dtype
    B_, S_, _ = x.shape
    zxbcdt = x @ params["in_proj"].to(dt_)
    z, xbc, dt = _split_proj(cfg, zxbcdt)
    xbc = _causal_conv(xbc, params["conv_w"].to(dt_),
                       params["conv_b"].to(dt_))
    xbc = F.silu(xbc.float()).to(dt_)
    xs, Bm, Cm = torch.split(xbc, [d_in, gn, gn], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])                        # (nh,)
    xh = xs.reshape(B_, S_, nh, s.head_dim)
    xd = xh * dt[..., None].to(dt_)
    log_a = dt * A                                         # (B, S, nh)
    Bm = Bm.reshape(B_, S_, s.n_groups, s.d_state)
    Cm = Cm.reshape(B_, S_, s.n_groups, s.d_state)
    y, hT = ssd_chunk(xd, log_a, Bm, Cm, _pick_chunk(S_, s.chunk))
    y = y + params["D"].to(dt_)[None, None, :, None] * xh
    y = y.reshape(B_, S_, d_in)
    y = _gated_norm(y, z, params["norm_scale"], cfg.norm_eps)
    out = y @ params["out_proj"].to(dt_)
    # the kernel's (n, hp) state into the cache's (hp, n)
    h = hT.transpose(-1, -2).contiguous()
    return out, SSMCache(_tail_conv_inputs(cfg, x, params), h)


def _tail_conv_inputs(cfg, x, params):
    """Last (d_conv-1) pre-activation conv inputs, for decode continuation;
    a prompt shorter than that is left-padded with zeros."""
    s = cfg.ssm
    zxbcdt = x[:, -(s.d_conv - 1):, :] @ params["in_proj"].to(x.dtype)
    _, xbc, _ = _split_proj(cfg, zxbcdt)
    pad = s.d_conv - 1 - xbc.shape[1]
    if pad > 0:
        xbc = F.pad(xbc, (0, 0, pad, 0))
    return xbc


def init_cache(cfg, batch: int, dtype, device) -> SSMCache:
    s = cfg.ssm
    d_in, nh, conv_ch = dims(cfg)
    return SSMCache(
        conv=torch.zeros((batch, s.d_conv - 1, conv_ch), dtype=dtype,
                         device=device),
        h=torch.zeros((batch, nh, s.head_dim, s.d_state),
                      dtype=torch.float32, device=device))


def apply_decode(params, x_t, cache: SSMCache, cfg):
    """One step. x_t: (B, 1, d).  Writes ``cache.conv`` and ``cache.h`` in
    place and returns (y, cache)."""
    s = cfg.ssm
    d_in, nh, conv_ch = dims(cfg)
    gn = s.n_groups * s.d_state
    dt_ = x_t.dtype
    B_ = x_t.shape[0]
    zxbcdt = x_t @ params["in_proj"].to(dt_)
    z, xbc_new, dt = _split_proj(cfg, zxbcdt)
    # conv over the window [cache.conv, xbc_new]
    win = torch.cat([cache.conv, xbc_new], dim=1)          # (B, K, C)
    w = params["conv_w"].to(dt_)
    xbc = torch.einsum("bkc,kc->bc", win, w)[:, None, :] + \
        params["conv_b"].to(dt_)
    xbc = F.silu(xbc.float()).to(dt_)
    xs, Bm, Cm = torch.split(xbc, [d_in, gn, gn], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"])       # (B, 1, nh)
    A = -torch.exp(params["A_log"])
    a = torch.exp(dt * A)[:, 0]                            # (B, nh)
    xh = xs.reshape(B_, nh, s.head_dim)
    rep = nh // s.n_groups
    Bv = Bm.reshape(B_, s.n_groups, s.d_state).repeat_interleave(rep, dim=1)
    Cv = Cm.reshape(B_, s.n_groups, s.d_state).repeat_interleave(rep, dim=1)
    xd = (xh * dt[:, 0, :, None].to(dt_)).float()
    h = cache.h
    h.mul_(a[..., None, None]).add_(
        torch.einsum("bhp,bhn->bhpn", xd, Bv.float()))
    y = torch.einsum("bhpn,bhn->bhp", h, Cv.float())
    y = y.to(dt_) + params["D"].to(dt_)[None, :, None] * xh
    y = y.reshape(B_, 1, d_in)
    y = _gated_norm(y, z, params["norm_scale"], cfg.norm_eps)
    out = y @ params["out_proj"].to(dt_)
    cache.conv.copy_(win[:, 1:, :])
    return out, cache
