"""Hand-written CUDA block-row hash SpGEMM kernel over BCSR and its
wrapper.

``csrc/spgemm_bcsr.cu`` replaces the Pallas kernels ``numeric_call`` (with
its scalar and vector probes) and ``batched_numeric_call`` (the same over
a fleet of members) of ``repro/kernels/spgemm_bcsr/kernel.py``; its header
says how the design maps the TPU's sequential grids onto the card.  It is
built like the other kernels (:mod:`repro_torch.kernels._build`): ``nvcc``
for ``sm_90a`` at first use, a plain C interface, ``ctypes``.

:func:`numeric_call` takes the arguments of the reference's compiled
``numeric_call``, and :func:`batched_numeric_call` takes them with a
member axis on any of them.
On CPU tensors they run the plain versions of ``ref.py``; on CUDA tensors
they launch the kernel or raise -- a build or launch failure is never
answered with the plain version.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build
from ..spgemm_hash.kernel import batched_launches
from . import ref

#: Launch counters.  ``numeric``/``numeric_vector`` gain one where the
#: wrapper launches its kernel (one call covers every bin), ``plain`` where
#: it runs the plain version, and ``symbolic`` where ``ops.bcsr_inspect``
#: runs a block-level inspection (which launches the hash symbolic kernel,
#: counted by that kernel's own counters).  ``batched_numeric`` /
#: ``batched_numeric_vector`` gain one per CUDA launch of the batched grid
#: (one per bin index that holds rows in any member), ``batched_plain`` one
#: per run of the batched plain version.
KERNEL_CALLS = {"symbolic": 0, "numeric": 0, "numeric_vector": 0,
                "plain": 0, "batched_numeric": 0,
                "batched_numeric_vector": 0, "batched_plain": 0}

#: Largest table (keys + float32 tiles) kept in shared memory, in bytes.
SMEM_BUDGET = 128 * 1024
#: Blocks that share the global-memory tables of a bin with larger tables.
GLOBAL_BLOCKS = 264
#: Most threads per block; a larger tile gives each thread several lanes,
#: so no tile size is refused (a bin's global tables, blocks x tsz x
#: (1 + bm * bn) x 4 B, must fit on the card).
MAX_THREADS = 1024

#: The array arguments of :func:`numeric_call`, in order, and their
#: dimensions.  An argument of :func:`batched_numeric_call` has one more (a
#: leading member axis), or has these and is shared by every member.
ARG_NAMES = ("offsets", "bin_tsize", "indptr_a", "indptr_b", "indptr_c",
             "a_bcol", "a_blk", "b_bcol", "b_blk")
ARG_DIMS = (1, 1, 1, 1, 1, 1, 3, 1, 3)

SOURCE = Path(__file__).parent / "csrc" / "spgemm_bcsr.cu"
_P, _L = ctypes.c_void_p, ctypes.c_longlong
_FUNCTIONS = {
    "spgemm_bcsr_launch": [ctypes.c_int] * 11 + [_P] * 13,
    # ints; each array pointer before its member stride (offsets,
    # bin_tsize, indptr_a, a_bcol, a_blk, indptr_b, b_bcol, b_blk,
    # indptr_c); outputs, errors, workspace and the stream
    "spgemm_bcsr_batched_launch":
        [ctypes.c_int] * 14 + [_P, _L] * 9 + [_P] * 6,
}
_lib = None


def build() -> dict:
    """Compile (if this source was not built yet) and load the library;
    returns :func:`repro_torch.kernels._build.load`'s record."""
    global _lib
    info = _build.load(SOURCE, _FUNCTIONS)
    _lib = info["lib"]
    return info


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_operands(indptr_a, indptr_b, indptr_c, a_bcol, a_blk, b_bcol,
                    b_blk):
    dev = a_bcol.device
    for name, t in (("indptr_a", indptr_a), ("indptr_b", indptr_b),
                    ("indptr_c", indptr_c), ("a_bcol", a_bcol),
                    ("b_bcol", b_bcol)):
        _build.check_tensor(name, t, torch.int32, dev)
    for name, t in (("a_blk", a_blk), ("b_blk", b_blk)):
        _build.check_tensor(name, t, torch.float32, dev)
        if t.dim() != 3:
            raise ValueError(f"{name} must be (bcap, rows, cols), got "
                             f"{tuple(t.shape)}")
    if a_blk.shape[2] != b_blk.shape[1]:
        raise ValueError(f"inner tile sizes differ: A tiles "
                         f"{tuple(a_blk.shape[1:])}, B tiles "
                         f"{tuple(b_blk.shape[1:])}")
    if indptr_c.shape != indptr_a.shape:
        raise ValueError("indptr_c and indptr_a must both be (gm + 1,)")
    if min(a_blk.shape[1:]) < 1 or b_blk.shape[2] < 1:
        raise ValueError(f"empty tiles: A {tuple(a_blk.shape[1:])}, B "
                         f"{tuple(b_blk.shape[1:])}")


def _launch_bins(vector, offsets, bin_tsize, table_size, indptr_a,
                 indptr_b, indptr_c, a_bcol, a_blk, b_bcol, b_blk, out_bcol,
                 out_blk, errors):
    dev = a_bcol.device
    bm, bk = a_blk.shape[1], a_blk.shape[2]
    bn = b_blk.shape[2]
    tile = bm * bn
    threads = _threads(tile)
    build()
    bounds = offsets.tolist()
    sizes = bin_tsize.tolist()
    gm = indptr_a.shape[0] - 1
    if len(bounds) != len(sizes) + 1 or \
            any(not 0 <= r0 <= r1 <= gm for r0, r1 in zip(bounds, bounds[1:])):
        raise ValueError(f"bin offsets {bounds} do not partition {gm} block "
                         f"rows into {len(sizes)} bins")
    stream = torch.cuda.current_stream(dev).cuda_stream
    for b, tsz in enumerate(sizes):
        r0, r1 = bounds[b], bounds[b + 1]
        if r1 <= r0:
            continue
        tsz = min(int(tsz), table_size)
        if tsz < 1 or tsz & (tsz - 1) or (vector and tsz < 8):
            raise ValueError(f"bin {b}: table size {tsz} is not a power of "
                             f"two{' >= 8' if vector else ''}")
        ws_keys = ws_acc = None
        smem = tsz * 4 * (1 + tile)
        if smem <= SMEM_BUDGET:
            grid = r1 - r0
        else:
            grid, smem = min(r1 - r0, GLOBAL_BLOCKS), 0
            ws_keys = torch.empty(grid * tsz, dtype=torch.int32, device=dev)
            ws_acc = torch.empty(grid * tsz * tile, dtype=torch.float32,
                                 device=dev)
        err = _lib.spgemm_bcsr_launch(
            int(vector), r0, r1, tsz, out_bcol.shape[0], bm, bk, bn, grid,
            threads, smem, _ptr(indptr_a), _ptr(a_bcol), _ptr(a_blk),
            _ptr(indptr_b), _ptr(b_bcol), _ptr(b_blk), _ptr(indptr_c),
            _ptr(out_bcol), _ptr(out_blk), _ptr(errors), _ptr(ws_keys),
            _ptr(ws_acc), stream)
        if err != 0:
            raise RuntimeError(f"spgemm_bcsr launch failed for bin {b}: "
                               f"CUDA error {err}")


def _threads(tile: int) -> int:
    """Threads per block: one per output lane of the tile, in whole warps,
    at most :data:`MAX_THREADS`."""
    return min(MAX_THREADS, max(32, -(-tile // 32) * 32))


def numeric_call(offsets, bin_tsize, indptr_a, indptr_b, indptr_c, a_bcol,
                 a_blk, b_bcol, b_blk, *, bcap_c: int, table_size: int,
                 vector: bool, errors: torch.Tensor | None = None):
    """``(out_bcol (bcap_c,) int32, out_blk (bcap_c, bm, bn) float32)``:
    each block row's blocks at ``indptr_c``, block columns unsorted, the
    tail zero.

    ``errors`` (CUDA only): a 1-element int32 tensor that gains one per
    probe that found its table full and per block row whose flushed count
    disagrees with ``indptr_c`` -- zero on every valid plan.  Without it
    the wrapper reads its own count after the launch and raises if it is
    not zero.
    """
    if a_bcol.device.type == "cpu":
        KERNEL_CALLS["plain"] += 1
        return ref.numeric_plain(offsets, bin_tsize, indptr_a, indptr_b,
                                 indptr_c, a_bcol, a_blk, b_bcol, b_blk,
                                 bcap_c=bcap_c, table_size=table_size,
                                 vector=vector)
    _check_operands(indptr_a, indptr_b, indptr_c, a_bcol, a_blk, b_bcol,
                    b_blk)
    dev = a_bcol.device
    out_bcol = torch.zeros(bcap_c, dtype=torch.int32, device=dev)
    out_blk = torch.zeros((bcap_c, a_blk.shape[1], b_blk.shape[2]),
                          dtype=torch.float32, device=dev)
    own = errors is None
    if own:
        errors = torch.zeros(1, dtype=torch.int32, device=dev)
    _build.check_tensor("errors", errors, torch.int32, dev)
    _launch_bins(vector, offsets, bin_tsize, table_size, indptr_a, indptr_b,
                 indptr_c, a_bcol, a_blk, b_bcol, b_blk, out_bcol, out_blk,
                 errors)
    KERNEL_CALLS["numeric_vector" if vector else "numeric"] += 1
    if own:
        _build.raise_on_errors(errors, "spgemm_bcsr numeric")
    return out_bcol, out_blk


def batched_numeric_call(offsets, bin_tsize, indptr_a, indptr_b, indptr_c,
                         a_bcol, a_blk, b_bcol, b_blk, *, n_members: int,
                         bcap_c: int, table_size: int, vector: bool,
                         errors: torch.Tensor | None = None):
    """:func:`numeric_call` for every member of a fleet: ``(out_bcol
    (n, bcap_c) int32, out_blk (n, bcap_c, bm, bn) float32)``.

    Each array argument either has a leading member axis of ``n_members``
    or has :func:`numeric_call`'s shape and is shared by every member: it
    goes to the kernel as it is, read in place with member stride 0, and
    is never copied per member.  The wrapper reads the bins back to lay
    out its launches (:func:`launch_list`); the kernel itself checks each
    member's bins against the block rows it is given.  ``errors`` as for
    :func:`numeric_call`, one counter for all members.
    """
    args = (offsets, bin_tsize, indptr_a, indptr_b, indptr_c, a_bcol, a_blk,
            b_bcol, b_blk)
    strides, views = _build.member_layout(ARG_NAMES, args, ARG_DIMS,
                                          n_members)
    if a_bcol.device.type == "cpu":
        KERNEL_CALLS["batched_plain"] += 1
        return ref.batched_numeric_plain(
            *args, n_members=n_members, bcap_c=bcap_c,
            table_size=table_size, vector=vector)
    dev = a_bcol.device
    for name, t in zip(ARG_NAMES[:2], args[:2]):
        _build.check_tensor(name, t, torch.int32, dev)
    _check_operands(*views[2:])
    if errors is not None:
        _build.check_tensor("errors", errors, torch.int32, dev)
    bm, bn = a_blk.shape[-2], b_blk.shape[-1]
    bk = a_blk.shape[-1]
    tile = bm * bn
    build()
    launches = launch_list(offsets, bin_tsize, n_members=n_members,
                           n_rows=indptr_a.shape[-1] - 1,
                           table_size=table_size, tile=tile, vector=vector)
    out_bcol = torch.zeros(n_members, bcap_c, dtype=torch.int32, device=dev)
    out_blk = torch.zeros((n_members, bcap_c, bm, bn), dtype=torch.float32,
                          device=dev)
    own = errors is None
    if own:
        errors = torch.zeros(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    threads = _threads(tile)
    key = "batched_numeric_vector" if vector else "batched_numeric"
    # the C interface's order: the schedule, A's arrays, B's, indptr_c
    pairs = [v for i in (0, 1, 2, 5, 6, 3, 7, 8, 4)
             for v in (_ptr(args[i]), strides[i])]
    for launch in launches:
        ws_keys = ws_acc = None
        if launch["ws_tsz"]:
            slots = launch["grid_x"] * n_members * launch["ws_tsz"]
            ws_keys = torch.empty(slots, dtype=torch.int32, device=dev)
            ws_acc = torch.empty(slots * tile, dtype=torch.float32,
                                 device=dev)
        err = _lib.spgemm_bcsr_batched_launch(
            int(vector), launch["bin"], indptr_a.shape[-1] - 1, table_size,
            launch["smem_slots"], launch["ws_tsz"], bcap_c, bm, bk, bn,
            launch["grid_x"], n_members, threads,
            launch["smem_slots"] * 4 * (1 + tile), *pairs, _ptr(out_bcol),
            _ptr(out_blk), _ptr(errors), _ptr(ws_keys), _ptr(ws_acc),
            stream)
        if err != 0:
            raise RuntimeError(f"spgemm_bcsr batched launch failed for bin "
                               f"{launch['bin']}: CUDA error {err}")
        KERNEL_CALLS[key] += 1
    if own:
        _build.raise_on_errors(errors, "spgemm_bcsr batched numeric")
    return out_bcol, out_blk


def launch_list(offsets, bin_tsize, *, n_members: int, n_rows: int,
                table_size: int, tile: int, vector: bool) -> list:
    """The launches of :func:`batched_numeric_call` for this schedule
    (stacked ``(n, ...)`` or shared 1-D bins): the hash batched kernel's
    geometry (``spgemm_hash.kernel.batched_launches``), with the shared
    memory of :data:`SMEM_BUDGET` counted in slots of ``tile`` float32
    lanes plus a key."""
    bounds = offsets.tolist()
    sizes = bin_tsize.tolist()
    if offsets.dim() == 1:
        bounds = [bounds] * n_members
    if bin_tsize.dim() == 1:
        sizes = [sizes] * n_members
    return batched_launches(bounds, sizes, table_size, n_rows, vector,
                            smem_slots=SMEM_BUDGET // (4 * (1 + tile)))
