"""Mixture-of-Experts layer: top-k routing and capacity dispatch (port of
``repro.models.moe``, its single-device path).

The token->expert dispatch matrix is a sparse matrix in CSR-by-expert
layout: assignments sorted by expert, each ranked within its expert by a
``searchsorted`` of the sorted ids, kept while the rank is under the
expert's capacity.  The paper's C8 finding (skip the sort where order does
not matter) is the unstable dispatch sort: tokens within an expert have no
required order, so ``stable_dispatch_sort=False`` (the default) sorts
without stability.  Which assignments an overflowing expert keeps then
depends on the sort's order of ties, which need not be XLA's: the port
equals the reference bitwise under the stable sort, or where no expert
overflows.

``apply`` runs ``apply_dense`` (one device).  The reference's expert-
parallel ``apply_ep`` (``shard_map`` with all-to-alls over a mesh) is not
ported: the port has no mesh (ROADMAP.md, Queue 1 item 7).  Everything
here is plain PyTorch, as the reference computes it outside any Pallas
kernel; the expert weights are float32 masters cast at each use.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.parallel.sharding import ParallelCtx
from . import layers as L


def init(gen: torch.Generator, cfg) -> dict:
    """Random weights with the reference's distributions, from ``gen``."""
    m = cfg.moe
    d, E, fe = cfg.d_model, m.n_experts, m.d_expert
    dev = gen.device
    return {
        "router": L.dense_init(gen, d, E, scale=d ** -0.5),
        "we_gate": torch.randn((E, d, fe), generator=gen, device=dev)
                   * d ** -0.5,
        "we_in": torch.randn((E, d, fe), generator=gen, device=dev)
                 * d ** -0.5,
        "we_out": torch.randn((E, fe, d), generator=gen, device=dev)
                  * fe ** -0.5,
    }


def capacity(n_tokens: int, cfg) -> int:
    """Slots per expert for ``n_tokens`` tokens (the reference's
    ``apply_dense``)."""
    m = cfg.moe
    return max(1, int(n_tokens * m.top_k / m.n_experts * m.capacity_factor))


# ---------------------------------------------------------------------------
# Routing + sparse dispatch
# ---------------------------------------------------------------------------

def _route(params, x2, cfg):
    """x2: (T, d) -> (top_p (T, k), top_i (T, k), aux_loss scalar)."""
    m = cfg.moe
    logits = x2.float() @ params["router"]                        # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, m.top_k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch-style load-balance aux loss
    me = probs.mean(dim=0)                                         # (E,)
    ce = F.one_hot(top_i[:, 0], m.n_experts).float().mean(dim=0)
    aux = m.n_experts * (me * ce).sum()
    return top_p.to(x2.dtype), top_i, aux


def _dispatch(x2, top_i, n_experts: int, capacity: int, stable: bool):
    """Build the (E*C, d) expert input buffer -- an SpMM with the
    CSR-by-expert dispatch matrix.

    Returns (buffer, slot_of_assignment (T, k) with -1 for dropped).  A
    dropped assignment's row goes to one spare row past the E*C slots
    (the reference's out-of-range index under ``mode="drop"``), which is
    cut off: no index is out of range."""
    T, k = top_i.shape
    d = x2.shape[1]
    flat_e = top_i.reshape(-1)                                    # (T*k,)
    # C8: unstable sort -- order within an expert is irrelevant.
    order = torch.argsort(flat_e, stable=stable)
    sorted_e = flat_e[order]
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos = torch.arange(T * k, device=x2.device) - first           # rank
    keep = pos < capacity
    spare = n_experts * capacity
    dest = torch.where(keep, sorted_e * capacity + pos, spare)
    src_tok = torch.div(order, k, rounding_mode="floor")
    buf = torch.zeros((spare + 1, d), dtype=x2.dtype, device=x2.device)
    buf[dest] = x2[src_tok]
    slot = torch.full((T * k,), -1, dtype=torch.int64, device=x2.device)
    slot[order] = torch.where(keep, dest, -1)
    return buf[:spare], slot.reshape(T, k)


def _combine(ybuf, slot, top_p):
    """Inverse dispatch: gather expert outputs back and mix by gate
    probabilities."""
    T, k = slot.shape
    safe = slot.clamp_min(0)
    y = ybuf[safe.reshape(-1)].reshape(T, k, -1)
    y = torch.where((slot >= 0)[..., None], y, torch.zeros((), dtype=y.dtype,
                                                           device=y.device))
    return torch.einsum("tkd,tk->td", y, top_p.to(y.dtype))


def _expert_ffn(xb, wg, wi, wo):
    """xb: (E, C, d); weights (E, d, fe)/(E, fe, d). Grouped SwiGLU, the
    weights cast to xb's dtype here, at each use."""
    dt = xb.dtype
    g = torch.bmm(xb, wg.to(dt))
    u = torch.bmm(xb, wi.to(dt))
    h = F.silu(g.float()).to(dt) * u
    return torch.bmm(h, wo.to(dt))


# ---------------------------------------------------------------------------
# Single device
# ---------------------------------------------------------------------------

def apply_dense(params, x, cfg):
    """x: (B, S, d) -> (y (B, S, d), aux loss)."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    x2 = x.reshape(T, d)
    cap = capacity(T, cfg)
    top_p, top_i, aux = _route(params, x2, cfg)
    buf, slot = _dispatch(x2, top_i, m.n_experts, cap,
                          m.stable_dispatch_sort)
    xb = buf.reshape(m.n_experts, cap, d)
    yb = _expert_ffn(xb, params["we_gate"], params["we_in"], params["we_out"])
    y = _combine(yb.reshape(m.n_experts * cap, d), slot, top_p)
    return y.reshape(B, S, d), aux


def apply(params, x, cfg, pctx: ParallelCtx):
    """The MoE MLP on one device: ``apply_dense``."""
    return apply_dense(params, x, cfg)
