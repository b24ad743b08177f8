"""Plain PyTorch versions of the propagation-blocking kernels.

:func:`scatter_plain` and :func:`merge_plain` take the kernels' own
arguments (see ``kernel.py``) and compute the same functions with gathers
and one ``index_add_``: the CPU path runs them, and on the card they are
the yardstick the kernels are checked against.  ``index_add_`` adds in
lane order on the CPU, the TPU kernel's order; on the card it adds with
atomics in some order, so values agree bitwise on dyadic inputs and to
1 ulp per accumulated product otherwise.

:func:`pb_numeric_ref` is the general-semiring executor (port of
``repro.kernels.spgemm_pb.ref``): the kernels are plus_times only, and
``PBPlan.execute`` threads every other semiring through the same frozen
gathers here.  It is plain torch by design, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.core.semiring import (Semiring, resolve_semiring,
                                       segment_reduce)


def _live(bucket_nnz: torch.Tensor, bucket_cap: int) -> torch.Tensor:
    lane = torch.arange(bucket_cap, dtype=torch.int32,
                        device=bucket_nnz.device)
    return lane[None, :] < bucket_nnz[:, None]


def scatter_plain(bucket_nnz, src_a, src_b, a_data, b_data) -> torch.Tensor:
    """``pp[g, i] = a_data[src_a[g, i]] * b_data[src_b[g, i]]`` for
    ``i < bucket_nnz[g]``, indices clipped to the operands' capacity, pad
    lanes 0; ``(n_buckets, bucket_cap)`` float32."""
    cap_a, cap_b = a_data.shape[0], b_data.shape[0]
    av = a_data.float()[src_a.long().clamp(0, cap_a - 1)]
    bv = b_data.float()[src_b.long().clamp(0, cap_b - 1)]
    return torch.where(_live(bucket_nnz, src_a.shape[1]), av * bv,
                       torch.zeros((), dtype=torch.float32,
                                   device=av.device))


def merge_plain(bucket_nnz, seg, pp, cap_c: int) -> torch.Tensor:
    """``out[seg[g, i]] += pp[g, i]`` over live lanes, bucket-major, slots
    clipped to ``[0, cap_c)``, from a zeroed ``(cap_c,)`` float32."""
    live = _live(bucket_nnz, seg.shape[1])
    out = torch.zeros(cap_c, dtype=torch.float32, device=pp.device)
    return out.index_add_(0, seg[live].long().clamp(0, cap_c - 1),
                          pp[live].float())


def pb_numeric_ref(a_data, b_data, src_a, src_b, seg, bucket_nnz,
                   cap_c: int, nnz_c, *, semiring="plus_times"):
    """Reduce frozen PB plan arrays to C's value vector ``(cap_c,)``.

    Pad lanes go to a dump segment ``cap_c`` with the semiring zero, so an
    empty segment of a min_plus-like semiring leaks no ``inf`` into a live
    slot; slots past ``nnz_c`` are zeroed.
    """
    sr: Semiring = resolve_semiring(semiring)
    cap_a, cap_b = a_data.shape[0], b_data.shape[0]
    live = _live(bucket_nnz, src_a.shape[1])
    av = a_data[src_a.long().clamp(0, cap_a - 1)]
    bv = b_data[src_b.long().clamp(0, cap_b - 1)]
    vals = torch.where(live, sr.mul(av, bv),
                       torch.full((), sr.zero, dtype=av.dtype,
                                  device=av.device))
    s = torch.where(live, seg, torch.full_like(seg, cap_c))
    data = segment_reduce(sr, vals.reshape(-1), s.reshape(-1),
                          cap_c + 1)[:cap_c]
    valid = torch.arange(cap_c, device=data.device) < nnz_c
    return torch.where(valid, data, torch.zeros_like(data))
