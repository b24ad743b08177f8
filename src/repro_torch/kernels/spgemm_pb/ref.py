"""Plain PyTorch versions of the propagation-blocking kernels.

:func:`scatter_plain` and :func:`merge_plain` take the kernels' own
arguments (see ``kernel.py``) and compute the same functions with gathers
and one ``index_add``: the CPU path runs them, and on the card they are
the yardstick the kernels are checked against.  ``index_add`` adds in
lane order on the CPU, the TPU kernel's order; on the card it adds with
atomics in some order, so values agree bitwise on dyadic inputs and to
1 ulp per accumulated product otherwise.  :func:`batched_scatter_plain`
and :func:`batched_merge_plain` are the same functions over a fleet of
members, each argument stacked along a leading member axis or shared
(the batched kernels' arguments); member ``e`` of their output is
bitwise what the single-product versions give on member ``e``'s
arguments, on the CPU.  :func:`slot_major_plain` is the plain version of
the wrappers' ``slot_major`` transpose.

:func:`pb_numeric_ref` is the general-semiring executor (port of
``repro.kernels.spgemm_pb.ref``): the kernels are plus_times only, and
``PBPlan.execute`` threads every other semiring through the same frozen
gathers here.  It is plain torch by design, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.core.semiring import (Semiring, resolve_semiring,
                                       segment_reduce)
from .._build import member_expand


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
    return out.index_add(0, seg[live].long().clamp(0, cap_c - 1),
                         pp[live].float())


def _gather(vals: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """``vals[e][clip(idx[e])]`` for every member ``e``, ``(n,) +
    idx.shape[-2:]``; a shared index is not copied per member."""
    idx = idx.long().clamp(0, vals.shape[-1] - 1)
    if idx.dim() == 2:
        return member_expand(vals, 1, n)[:, idx]
    if vals.dim() == 1:
        return vals[idx]
    return torch.gather(vals, 1, idx.reshape(n, -1)).reshape(idx.shape)


def batched_scatter_plain(bucket_nnz, src_a, src_b, a_data, b_data,
                          n_members: int) -> torch.Tensor:
    """:func:`scatter_plain` for every member, ``(n_members, n_buckets,
    bucket_cap)`` float32: ``bucket_nnz`` is ``(n_buckets,)``, the index
    arrays ``(n_buckets, bucket_cap)`` and the values ``(cap,)``, each
    with a leading member axis or shared by every member."""
    n = n_members
    nb, cap = src_a.shape[-2:]
    av = _gather(a_data.float(), src_a, n)
    bv = _gather(b_data.float(), src_b, n)
    lane = torch.arange(cap, dtype=torch.int32, device=src_a.device)
    live = lane < member_expand(bucket_nnz, 1, n)[:, :, None]
    return torch.where(live, av * bv, torch.zeros(
        (), dtype=torch.float32, device=av.device)).expand(
            n, nb, cap).contiguous()


def batched_merge_plain(bucket_nnz, seg, pp, cap_c: int,
                        n_members: int) -> torch.Tensor:
    """:func:`merge_plain` for every member, ``(n_members, cap_c)``
    float32, arguments stacked or shared as for
    :func:`batched_scatter_plain`: one ``index_add`` over every member's
    live lanes, member-major, each member's into its own row."""
    n = n_members
    nb, cap = seg.shape[-2:]
    dev = seg.device
    lane = torch.arange(cap, dtype=torch.int32, device=dev)
    live = (lane < member_expand(bucket_nnz, 1, n)[:, :, None]) \
        .expand(n, nb, cap)
    row = torch.arange(n, device=dev)[:, None, None] * cap_c
    slot = (seg.long().clamp(0, cap_c - 1) + row).expand(n, nb, cap)
    out = torch.zeros(n * cap_c, dtype=torch.float32, device=dev)
    pp = member_expand(pp, 2, n)
    return out.index_add(0, slot[live], pp[live].float()).view(n, cap_c)


def slot_major_plain(values: torch.Tensor) -> torch.Tensor:
    """``values`` ``(n, cap)`` as ``(cap, n)``, members innermost: the
    layout in which the batched scatter gathers a stacked operand."""
    return values.t().contiguous()


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
