"""RG-LRU recurrent block (Griffin / RecurrentGemma [arXiv:2402.19427];
port of ``repro.models.rglru``).

Block: y = W_out( GeLU(W_gate x) * RG-LRU( conv4( W_rnn x ) ) )

RG-LRU cell (block-diagonal input/recurrence gates, n_blocks=NB):
  r_t = sigmoid(blockdiag(gate_a) . x_t)
  i_t = sigmoid(blockdiag(gate_x) . x_t)
  log a_t = -c * softplus(a_param) * r_t          (c = 8)
  h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill runs the recurrence as a log-depth scan over time in PyTorch ops
(:func:`linear_scan`), where the reference runs ``jax.lax.associative_scan``:
the same combine, another association, so float32 states agree within a few
ulps, not bitwise.  Decode is the single-step recurrence and writes the
(conv window, h) cache in place (the reference returns new arrays).  The
gates and the state are float32; the projections and the causal conv run in
the compute dtype, as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import layers as L

C_FACTOR = 8.0
NB = 8               # gate block-diagonal blocks
D_CONV = 4


class RGLRUCache(NamedTuple):
    conv: torch.Tensor   # (B, D_CONV-1, w) trailing conv inputs
    h: torch.Tensor      # (B, w) recurrent state (float32)


def width(cfg) -> int:
    return cfg.rnn_width or cfg.d_model


def init(gen: torch.Generator, cfg) -> dict:
    """Random weights with the reference's distributions, from ``gen``."""
    d, w = cfg.d_model, width(cfg)
    dev = gen.device
    return {
        "w_gate_in": L.dense_init(gen, d, w),
        "w_rnn_in": L.dense_init(gen, d, w),
        "conv_w": torch.randn((D_CONV, w), generator=gen, device=dev)
                  * D_CONV ** -0.5,
        "conv_b": torch.zeros((w,), device=dev),
        "gate_a": torch.randn((NB, w // NB, w // NB), generator=gen,
                              device=dev) * (w // NB) ** -0.5,
        "gate_x": torch.randn((NB, w // NB, w // NB), generator=gen,
                              device=dev) * (w // NB) ** -0.5,
        # softplus^-1 of a span of decay rates
        "a_param": torch.log(torch.expm1(
            torch.linspace(0.1, 0.5, w, device=dev))),
        "w_rnn_out": L.dense_init(gen, w, d),
    }


def _gelu(x):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


def _block_gate(g, x):
    """x: (..., w) -> sigmoid(blockdiag(g) x); g: (NB, w/NB, w/NB)."""
    shape = x.shape
    xb = x.reshape(shape[:-1] + (NB, shape[-1] // NB))
    y = torch.einsum("...bi,bij->...bj", xb.float(), g)
    return torch.sigmoid(y).reshape(shape)


def _gates(params, xr):
    r = _block_gate(params["gate_a"], xr)
    i = _block_gate(params["gate_x"], xr)
    log_a = -C_FACTOR * F.softplus(params["a_param"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) * \
        (i * xr.float())
    return a, b


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t along dim 1 from h_{-1} = 0, for every t.

    Hillis-Steele doubling over the reference's combine
    ``(a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2)``: after the step of span
    ``s`` each position holds the composition of the ``2s`` steps ending
    there, so ceil(log2 S) steps of whole-tensor ops give every h_t.  The
    association differs from ``jax.lax.associative_scan``'s tree, so the
    two agree to float32 rounding, not bitwise."""
    s_len = a.shape[1]
    span = 1
    while span < s_len:
        b = torch.cat([b[:, :span],
                       torch.addcmul(b[:, span:], a[:, span:],
                                     b[:, :-span])], dim=1)
        if 2 * span < s_len:
            a = torch.cat([a[:, :span], a[:, span:] * a[:, :-span]], dim=1)
        span *= 2
    return b


def apply_full(params, x, cfg):
    """Prefill. x: (B, S, d) -> (y, RGLRUCache)."""
    dt_ = x.dtype
    S = x.shape[1]
    gate = _gelu((x @ params["w_gate_in"].to(dt_)).float())
    xr = x @ params["w_rnn_in"].to(dt_)
    # causal depthwise conv4
    pad = F.pad(xr, (0, 0, D_CONV - 1, 0))
    xc = sum(pad[:, i:i + S, :] * params["conv_w"][i].to(dt_)
             for i in range(D_CONV)) + params["conv_b"].to(dt_)
    a, b = _gates(params, xc)                       # (B, S, w) float32
    h = linear_scan(a, b)
    y = (gate * h).to(dt_)
    out = y @ params["w_rnn_out"].to(dt_)
    conv_tail = xr[:, -(D_CONV - 1):, :]
    if S < D_CONV - 1:
        conv_tail = F.pad(xr, (0, 0, D_CONV - 1 - S, 0))
    return out, RGLRUCache(conv_tail, h[:, -1, :])


def init_cache(cfg, batch: int, dtype, device) -> RGLRUCache:
    w = width(cfg)
    return RGLRUCache(
        conv=torch.zeros((batch, D_CONV - 1, w), dtype=dtype, device=device),
        h=torch.zeros((batch, w), dtype=torch.float32, device=device))


def apply_decode(params, x_t, cache: RGLRUCache, cfg):
    """One step. x_t: (B, 1, d).  Writes ``cache.conv`` and ``cache.h`` in
    place and returns (y, cache)."""
    dt_ = x_t.dtype
    gate = _gelu((x_t @ params["w_gate_in"].to(dt_)).float())[:, 0]
    xr = (x_t @ params["w_rnn_in"].to(dt_))[:, 0]            # (B, w)
    win = torch.cat([cache.conv, xr[:, None, :]], dim=1)     # (B, 4, w)
    xc = torch.einsum("bkw,kw->bw", win, params["conv_w"].to(dt_)) + \
        params["conv_b"].to(dt_)
    a, b = _gates(params, xc)
    h = cache.h
    h.mul_(a).add_(b)
    y = (gate * h).to(dt_)
    out = (y @ params["w_rnn_out"].to(dt_))[:, None, :]
    cache.conv.copy_(win[:, 1:, :])
    return out, cache
