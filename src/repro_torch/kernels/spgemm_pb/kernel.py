"""Hand-written CUDA propagation-blocking kernels and their wrappers.

``csrc/spgemm_pb.cu`` replaces the Pallas kernels ``scatter_call`` and
``merge_call`` of ``repro/kernels/spgemm_pb/kernel.py``, and their
batched twins ``batched_scatter_call`` and ``batched_merge_call`` (the
same over a fleet of members), with one pair of kernels: the single
product is the fleet of one member.  Its header says how the design maps
the TPU's sequential bucket grid onto the card.  It is built like the
hash kernels (:mod:`repro_torch.kernels._build`): ``nvcc`` for
``sm_90a`` at first use, a plain C interface, ``ctypes``.

:func:`scatter_call` and :func:`merge_call` take the reference builders'
call arguments, and :func:`batched_scatter_call` and
:func:`batched_merge_call` take them with a member axis on any of them.
On CPU tensors they run the plain versions of ``ref.py``; on CUDA tensors
they launch the kernel or raise -- a build or launch failure is never
answered with the plain version.

Launch shape: one block per bucket.  Where the fleet shares every index
array (every vmap over a planned execute) the block takes every member
of its bucket, reading each lane's indices once; else one block per
(member, bucket) pair.  :func:`scatter_layout` says which batched value
operands the scatter takes slot-major (``(cap, n)``, members innermost,
made by :func:`slot_major`); the batched merge returns ``(n, cap_c)`` as
a transposed view of a slot-major ``(cap_c, w)`` buffer, ``w`` from
:func:`merge_width`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build
from . import ref

#: Launch counters.  ``scatter``/``merge`` gain one where their wrapper
#: launches its kernel, ``plain`` where a wrapper runs a plain version, and
#: ``inspect`` where ``core.pb.plan_pb`` runs an inspection (a cache miss).
#: ``batched_scatter``/``batched_merge`` gain one per launch of a batched
#: kernel (one covers every member), ``batched_plain`` one per run of a
#: batched plain version.  The single wrappers launch the same kernels at
#: one member and count under their own names.
KERNEL_CALLS = {"inspect": 0, "scatter": 0, "merge": 0, "plain": 0,
                "batched_scatter": 0, "batched_merge": 0,
                "batched_plain": 0}

#: Launches of the slot-major copy (``transpose_kernel``, :func:`slot_major`),
#: one per stacked value operand of a scatter whose blocks take every
#: member; extra to the scatter's one count a call.
COPY_CALLS = {"slot_major": 0}

#: Threads per block: one per lane of a bucket row.
BLOCK = 256

SOURCE = Path(__file__).parent / "csrc" / "spgemm_pb.cu"
_P, _L = ctypes.c_void_p, ctypes.c_longlong
_FUNCTIONS = {
    # ints; each index array's pointer before its member stride; each
    # value operand's before its member and slot strides; output, stream
    "pb_scatter_batched_launch": [ctypes.c_int] * 7 + [_P, _L] * 3
    + [_P, _L, _L] * 2 + [_P] * 2,
    "pb_merge_batched_launch": [ctypes.c_int] * 6 + [_P, _L] * 3
    + [_P, ctypes.c_int, _P],
    "pb_transpose_launch": [ctypes.c_int, _L, ctypes.c_int, _P, _P, _P],
}
_SCATTER_NAMES = ("bucket_nnz", "src_a", "src_b", "a_data", "b_data")
_MERGE_NAMES = ("bucket_nnz", "seg", "pp")
_lib = None


def build() -> dict:
    """Compile (if this source was not built yet) and load the library;
    returns :func:`repro_torch.kernels._build.load`'s record."""
    global _lib
    info = _build.load(SOURCE, _FUNCTIONS)
    _lib = info["lib"]
    return info


def _device_of(*tensors) -> torch.device:
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"operands on {dev} and {t.device}: the PB "
                             f"kernels take tensors on one device")
    return dev


def _check_layout(bucket_nnz, lanes, *more):
    """``lanes`` (and ``more``) are ``(n_buckets, bucket_cap)``, and
    ``bucket_nnz`` is ``(n_buckets,)``."""
    if lanes.dim() != 2 or lanes.shape[1] < 1:
        raise ValueError(f"bucket arrays must be (n_buckets, bucket_cap), "
                         f"got {tuple(lanes.shape)}")
    for t in more:
        if t.shape != lanes.shape:
            raise ValueError(f"bucket arrays differ in shape: "
                             f"{tuple(t.shape)} vs {tuple(lanes.shape)}")
    if tuple(bucket_nnz.shape) != (lanes.shape[0],):
        raise ValueError(f"bucket_nnz must be ({lanes.shape[0]},), got "
                         f"{tuple(bucket_nnz.shape)}")


def _launched(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"spgemm_pb {what} launch failed: CUDA error "
                           f"{err}")


def scatter_layout(n_members: int, shared_indices: bool) -> tuple:
    """``(inner, slot)`` for a scatter over ``n_members``: whether a block
    takes every member of its bucket (only where every index array is
    shared), and whether stacked value operands go slot-major (where a
    block takes more than one member, so that one gather brings a slot's
    value for every member; a block of one member gathers member-major
    rows in place).  Members-inside with slot-major values beat both
    other choices on ER s18 at 8 members of A and 4 of A and B (PERF.md
    §6, ``tools/pb_cost.py --cases rules``)."""
    return shared_indices, shared_indices and n_members > 1


def merge_width(n_members: int, shared_indices: bool) -> int:
    """Members a row of the merge's slot-major output holds: ``n_members``,
    or ``n_members`` rounded up to a multiple of 8 (one 32-byte sector)
    where a block takes every member (every index array shared) and
    ``4 <= n_members`` with ``n_members % 8 != 0``, so that each slot's
    store is whole sectors (at most 2x the output's memory).  At 4 members
    that took the merge from 4.81 to 3.54 ms on ER s18 (PERF.md §6)."""
    if shared_indices and n_members >= 4 and n_members % 8:
        return -(-n_members // 8) * 8
    return n_members


def slot_major(values: torch.Tensor) -> torch.Tensor:
    """``values`` ``(n, cap)`` float32 as ``(cap, n)``, members innermost:
    ``values.t().contiguous()``, on CUDA one ``transpose_kernel``
    launch."""
    if values.dim() != 2:
        raise ValueError(f"slot_major takes (n, cap), got "
                         f"{tuple(values.shape)}")
    if values.device.type == "cpu":
        return ref.slot_major_plain(values)
    _build.check_tensor("values", values, torch.float32, values.device)
    build()
    n, cap = values.shape
    out = torch.empty((cap, n), dtype=torch.float32, device=values.device)
    err = _lib.pb_transpose_launch(
        n, cap, BLOCK, values.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(values.device).cuda_stream)
    _launched(err, "transpose")
    COPY_CALLS["slot_major"] += 1
    return out


def _scatter(args, strides, n: int, dev) -> torch.Tensor:
    """Check the scatter's CUDA arguments and launch it over ``n``
    members (``strides``: each argument's member stride, 0 shared);
    ``pp`` ``(n, n_buckets, bucket_cap)``."""
    for name, t in zip(_SCATTER_NAMES[:3], args[:3]):
        _build.check_tensor(name, t, torch.int32, dev)
    caps = []
    for name, t, st in zip(_SCATTER_NAMES[3:], args[3:], strides[3:]):
        _build.check_tensor(name, t, torch.float32, dev)
        v = t[0] if st else t
        if v.dim() != 1 or v.shape[0] < 1:
            raise ValueError(f"{name} must be a non-empty vector per "
                             f"member, got {tuple(t.shape)}")
        caps.append(v.shape[0])
    build()
    inner, slot = scatter_layout(n, not any(strides[:3]))
    # each value operand as (tensor, member stride, slot stride)
    vals = [(t, 0, 1) if st == 0 else (slot_major(t), 1, n) if slot
            else (t, st, 1) for t, st in zip(args[3:], strides[3:])]
    n_buckets, bucket_cap = args[1].shape[-2:]
    pp = torch.empty((n, n_buckets, bucket_cap), dtype=torch.float32,
                     device=dev)
    idx = [v for t, st in zip(args[:3], strides[:3])
           for v in (t.data_ptr(), st)]
    err = _lib.pb_scatter_batched_launch(
        n, n if inner else 1, n_buckets, bucket_cap, *caps, BLOCK, *idx,
        *[v for t, se, ss in vals for v in (t.data_ptr(), se, ss)],
        pp.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _launched(err, "scatter")
    return pp


def _merge(args, strides, n: int, cap_c: int, dev) -> torch.Tensor:
    """Check the merge's CUDA arguments and launch it over ``n`` members;
    the output slot-major, ``(cap_c, n)``, a view of ``(cap_c,
    merge_width)``."""
    _build.check_tensor("bucket_nnz", args[0], torch.int32, dev)
    _build.check_tensor("seg", args[1], torch.int32, dev)
    _build.check_tensor("pp", args[2], torch.float32, dev)
    build()
    inner = not any(strides[:2])
    width = merge_width(n, inner)
    n_buckets, bucket_cap = args[1].shape[-2:]
    out = torch.zeros((cap_c, width), dtype=torch.float32, device=dev)
    err = _lib.pb_merge_batched_launch(
        n, n if inner else 1, n_buckets, bucket_cap, cap_c, BLOCK,
        *[v for t, st in zip(args, strides) for v in (t.data_ptr(), st)],
        out.data_ptr(), width, torch.cuda.current_stream(dev).cuda_stream)
    _launched(err, "merge")
    return out[:, :n]


def scatter_call(bucket_nnz, src_a, src_b, a_data, b_data) -> torch.Tensor:
    """``pp`` of shape ``(n_buckets, bucket_cap)`` float32, pad lanes 0:
    ``pp[g, i] = a_data[src_a[g, i]] * b_data[src_b[g, i]]`` for
    ``i < bucket_nnz[g]``, indices clipped to the operands' capacity."""
    dev = _device_of(bucket_nnz, src_a, src_b, a_data, b_data)
    _check_layout(bucket_nnz, src_a, src_b)
    if dev.type == "cpu":
        KERNEL_CALLS["plain"] += 1
        return ref.scatter_plain(bucket_nnz, src_a, src_b, a_data, b_data)
    pp = _scatter((bucket_nnz, src_a, src_b, a_data, b_data), (0,) * 5, 1,
                  dev)
    KERNEL_CALLS["scatter"] += 1
    return pp[0]


def merge_call(bucket_nnz, seg, pp, cap_c: int) -> torch.Tensor:
    """``data_c`` of shape ``(cap_c,)`` float32: ``out[seg[g, i]] +=
    pp[g, i]`` over the live lanes in bucket-major lane order, slots
    clipped to ``[0, cap_c)``, from zero.

    The kernel relies on the plan's layout: within a bucket ``seg`` does
    not decrease, and buckets name disjoint slots.
    """
    dev = _device_of(bucket_nnz, seg, pp)
    _check_layout(bucket_nnz, seg, pp)
    if cap_c < 1:
        raise ValueError(f"cap_c must be at least 1, got {cap_c}")
    if dev.type == "cpu":
        KERNEL_CALLS["plain"] += 1
        return ref.merge_plain(bucket_nnz, seg, pp, cap_c)
    out = _merge((bucket_nnz, seg, pp), (0,) * 3, 1, cap_c, dev)
    KERNEL_CALLS["merge"] += 1
    return out.view(cap_c)


def batched_scatter_call(bucket_nnz, src_a, src_b, a_data, b_data, *,
                         n_members: int) -> torch.Tensor:
    """:func:`scatter_call` for every member of a fleet: ``pp`` of shape
    ``(n_members, n_buckets, bucket_cap)`` float32.

    Each argument either has a leading member axis of ``n_members`` or has
    :func:`scatter_call`'s shape and is shared by every member: it goes to
    the kernel as it is, read in place with member stride 0, and is never
    copied per member.  A stacked value operand goes slot-major where
    :func:`scatter_layout` says so (one :func:`slot_major` copy a call).
    """
    args = (bucket_nnz, src_a, src_b, a_data, b_data)
    strides, views = _build.member_layout(_SCATTER_NAMES, args,
                                          (1, 2, 2, 1, 1), n_members)
    dev = _device_of(*args)
    _check_layout(*views[:3])
    if dev.type == "cpu":
        KERNEL_CALLS["batched_plain"] += 1
        return ref.batched_scatter_plain(*args, n_members)
    pp = _scatter(args, strides, n_members, dev)
    KERNEL_CALLS["batched_scatter"] += 1
    return pp


def batched_merge_call(bucket_nnz, seg, pp, cap_c: int, *,
                       n_members: int) -> torch.Tensor:
    """:func:`merge_call` for every member of a fleet, each argument
    stacked or shared as for :func:`batched_scatter_call`.

    Returns ``(n_members, cap_c)`` float32 stored slot-major, on either
    device: a view of a contiguous ``(cap_c, w)`` buffer, ``w =
    merge_width(n_members, shared)`` (``shared``: ``bucket_nnz`` and
    ``seg`` shared), strides ``(1, w)``; ``.contiguous()`` copies it
    member-major (as a vmap rule's ``_build.members_first`` does for a
    batched argument).
    """
    args = (bucket_nnz, seg, pp)
    strides, views = _build.member_layout(_MERGE_NAMES, args, (1, 2, 2),
                                          n_members)
    dev = _device_of(*args)
    _check_layout(*views)
    if cap_c < 1:
        raise ValueError(f"cap_c must be at least 1, got {cap_c}")
    if dev.type == "cpu":
        KERNEL_CALLS["batched_plain"] += 1
        out = torch.zeros((cap_c, merge_width(n_members, not any(
            strides[:2]))), dtype=torch.float32)
        out[:, :n_members] = ref.batched_merge_plain(*args, cap_c,
                                                     n_members).t()
        return out[:, :n_members].t()
    out = _merge(args, strides, n_members, cap_c, dev)
    KERNEL_CALLS["batched_merge"] += 1
    return out.t()
