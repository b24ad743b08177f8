"""Hand-written CUDA propagation-blocking kernels and their wrappers.

``csrc/spgemm_pb.cu`` replaces the Pallas kernels ``scatter_call`` and
``merge_call`` of ``repro/kernels/spgemm_pb/kernel.py``, and their
batched twins ``batched_scatter_call`` and ``batched_merge_call`` (the
same over a fleet of members); its header says how the design maps the
TPU's sequential bucket grid onto the card.  It is
built like the hash kernels (:mod:`repro_torch.kernels._build`): ``nvcc``
for ``sm_90a`` at first use, a plain C interface, ``ctypes``.

:func:`scatter_call` and :func:`merge_call` take the reference builders'
call arguments, and :func:`batched_scatter_call` and
:func:`batched_merge_call` take them with a member axis on any of them.
On CPU tensors they run the plain versions of ``ref.py``; on CUDA tensors
they launch the kernel or raise -- a build or launch failure is never
answered with the plain version.
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
#: batched plain version.
KERNEL_CALLS = {"inspect": 0, "scatter": 0, "merge": 0, "plain": 0,
                "batched_scatter": 0, "batched_merge": 0,
                "batched_plain": 0}

#: Threads per block: one per lane of a bucket row.
BLOCK = 256
#: Most blocks per single-product launch; each walks buckets with a grid
#: stride.
MAX_BLOCKS = 132 * 16
#: Most blocks per batched launch: one per (member, bucket) pair up to the
#: grid's x limit, past which blocks walk the pairs with a grid stride (a
#: walk of dozens of pairs per block ran the 8-member ER s18 fleet about 2x
#: slower than one block per pair, H100).
MAX_BATCHED_BLOCKS = 2**31 - 1

SOURCE = Path(__file__).parent / "csrc" / "spgemm_pb.cu"
_P, _L = ctypes.c_void_p, ctypes.c_longlong
_FUNCTIONS = {
    "pb_scatter_launch": [ctypes.c_int] * 6 + [_P] * 7,
    "pb_merge_launch": [ctypes.c_int] * 5 + [_P] * 5,
    # ints; each input's pointer before its member stride; output, stream
    "pb_scatter_batched_launch": [ctypes.c_int] * 7 + [_P, _L] * 5
    + [_P] * 2,
    "pb_merge_batched_launch": [ctypes.c_int] * 6 + [_P, _L] * 3 + [_P] * 2,
}
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


def scatter_call(bucket_nnz, src_a, src_b, a_data, b_data) -> torch.Tensor:
    """``pp`` of shape ``(n_buckets, bucket_cap)`` float32, pad lanes 0:
    ``pp[g, i] = a_data[src_a[g, i]] * b_data[src_b[g, i]]`` for
    ``i < bucket_nnz[g]``, indices clipped to the operands' capacity."""
    dev = _device_of(bucket_nnz, src_a, src_b, a_data, b_data)
    _check_layout(bucket_nnz, src_a, src_b)
    if dev.type == "cpu":
        KERNEL_CALLS["plain"] += 1
        return ref.scatter_plain(bucket_nnz, src_a, src_b, a_data, b_data)
    for name, t in (("bucket_nnz", bucket_nnz), ("src_a", src_a),
                    ("src_b", src_b)):
        _build.check_tensor(name, t, torch.int32, dev)
    for name, t in (("a_data", a_data), ("b_data", b_data)):
        _build.check_tensor(name, t, torch.float32, dev)
        if t.dim() != 1 or t.shape[0] < 1:
            raise ValueError(f"{name} must be a non-empty vector, got "
                             f"{tuple(t.shape)}")
    build()
    n_buckets, bucket_cap = src_a.shape
    pp = torch.empty((n_buckets, bucket_cap), dtype=torch.float32,
                     device=dev)
    err = _lib.pb_scatter_launch(
        n_buckets, bucket_cap, a_data.shape[0], b_data.shape[0],
        min(n_buckets, MAX_BLOCKS), BLOCK, bucket_nnz.data_ptr(),
        src_a.data_ptr(), src_b.data_ptr(), a_data.data_ptr(),
        b_data.data_ptr(), pp.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _launched(err, "scatter")
    KERNEL_CALLS["scatter"] += 1
    return pp


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
    _build.check_tensor("bucket_nnz", bucket_nnz, torch.int32, dev)
    _build.check_tensor("seg", seg, torch.int32, dev)
    _build.check_tensor("pp", pp, torch.float32, dev)
    build()
    n_buckets, bucket_cap = seg.shape
    out = torch.zeros(cap_c, dtype=torch.float32, device=dev)
    err = _lib.pb_merge_launch(
        n_buckets, bucket_cap, cap_c, min(n_buckets, MAX_BLOCKS), BLOCK,
        bucket_nnz.data_ptr(), seg.data_ptr(), pp.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _launched(err, "merge")
    KERNEL_CALLS["merge"] += 1
    return out


def batched_scatter_call(bucket_nnz, src_a, src_b, a_data, b_data, *,
                         n_members: int) -> torch.Tensor:
    """:func:`scatter_call` for every member of a fleet: ``pp`` of shape
    ``(n_members, n_buckets, bucket_cap)`` float32.

    Each argument either has a leading member axis of ``n_members`` or has
    :func:`scatter_call`'s shape and is shared by every member: it goes to
    the kernel as it is, read in place with member stride 0, and is never
    copied per member.
    """
    args = (bucket_nnz, src_a, src_b, a_data, b_data)
    names = ("bucket_nnz", "src_a", "src_b", "a_data", "b_data")
    strides, views = _build.member_layout(names, args, (1, 2, 2, 1, 1),
                                          n_members)
    dev = _device_of(*args)
    _check_layout(*views[:3])
    if dev.type == "cpu":
        KERNEL_CALLS["batched_plain"] += 1
        return ref.batched_scatter_plain(*args, n_members)
    for name, t in zip(names[:3], args[:3]):
        _build.check_tensor(name, t, torch.int32, dev)
    for name, t, v in zip(names[3:], args[3:], views[3:]):
        _build.check_tensor(name, t, torch.float32, dev)
        if v.dim() != 1 or v.shape[0] < 1:
            raise ValueError(f"{name} must be a non-empty vector per "
                             f"member, got {tuple(t.shape)}")
    build()
    n_buckets, bucket_cap = views[1].shape
    pp = torch.empty((n_members, n_buckets, bucket_cap),
                     dtype=torch.float32, device=dev)
    pairs = [v for t, st in zip(args, strides) for v in (t.data_ptr(), st)]
    grid = min(n_members * n_buckets, MAX_BATCHED_BLOCKS)
    err = _lib.pb_scatter_batched_launch(
        n_members, n_buckets, bucket_cap, views[3].shape[0],
        views[4].shape[0], grid, BLOCK, *pairs, pp.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _launched(err, "batched scatter")
    KERNEL_CALLS["batched_scatter"] += 1
    return pp


def batched_merge_call(bucket_nnz, seg, pp, cap_c: int, *,
                       n_members: int) -> torch.Tensor:
    """:func:`merge_call` for every member of a fleet: ``(n_members,
    cap_c)`` float32, each argument stacked or shared as for
    :func:`batched_scatter_call`."""
    args = (bucket_nnz, seg, pp)
    names = ("bucket_nnz", "seg", "pp")
    strides, views = _build.member_layout(names, args, (1, 2, 2),
                                          n_members)
    dev = _device_of(*args)
    _check_layout(*views)
    if cap_c < 1:
        raise ValueError(f"cap_c must be at least 1, got {cap_c}")
    if dev.type == "cpu":
        KERNEL_CALLS["batched_plain"] += 1
        return ref.batched_merge_plain(*args, cap_c, n_members)
    _build.check_tensor("bucket_nnz", bucket_nnz, torch.int32, dev)
    _build.check_tensor("seg", seg, torch.int32, dev)
    _build.check_tensor("pp", pp, torch.float32, dev)
    build()
    n_buckets, bucket_cap = views[1].shape
    out = torch.zeros((n_members, cap_c), dtype=torch.float32, device=dev)
    pairs = [v for t, st in zip(args, strides) for v in (t.data_ptr(), st)]
    grid = min(n_members * n_buckets, MAX_BATCHED_BLOCKS)
    err = _lib.pb_merge_batched_launch(
        n_members, n_buckets, bucket_cap, cap_c, grid, BLOCK, *pairs,
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _launched(err, "batched merge")
    KERNEL_CALLS["batched_merge"] += 1
    return out
