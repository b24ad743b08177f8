"""Hand-written CUDA block-row hash SpGEMM kernel over BCSR and its
wrapper.

``csrc/spgemm_bcsr.cu`` replaces the Pallas kernel ``numeric_call`` of
``repro/kernels/spgemm_bcsr/kernel.py`` (with its scalar and vector
probes); its header says how the design maps the TPU's sequential bin
grid onto the card.  It is built like the other kernels
(:mod:`repro_torch.kernels._build`): ``nvcc`` for ``sm_90a`` at first use,
a plain C interface, ``ctypes``.

:func:`numeric_call` takes the reference builder's call arguments.  On CPU
tensors it runs the plain version of ``ref.py``; on CUDA tensors it
launches the kernel or raises -- a build or launch failure is never
answered with the plain version.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build
from . import ref

#: Launch counters.  ``numeric``/``numeric_vector`` gain one where the
#: wrapper launches its kernel (one call covers every bin), ``plain`` where
#: it runs the plain version, and ``symbolic`` where ``ops.bcsr_inspect``
#: runs a block-level inspection (which launches the hash symbolic kernel,
#: counted by that kernel's own counters).
KERNEL_CALLS = {"symbolic": 0, "numeric": 0, "numeric_vector": 0,
                "plain": 0}

#: Largest table (keys + float32 tiles) kept in shared memory, in bytes.
SMEM_BUDGET = 128 * 1024
#: Blocks that share the global-memory tables of a bin with larger tables.
GLOBAL_BLOCKS = 264
#: Most threads per block; a larger tile gives each thread several lanes,
#: so no tile size is refused (a bin's global tables, blocks x tsz x
#: (1 + bm * bn) x 4 B, must fit on the card).
MAX_THREADS = 1024

SOURCE = Path(__file__).parent / "csrc" / "spgemm_bcsr.cu"
_FUNCTIONS = {"spgemm_bcsr_launch":
              [ctypes.c_int] * 11 + [ctypes.c_void_p] * 13}
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
    threads = min(MAX_THREADS, max(32, -(-tile // 32) * 32))
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
        n = int(errors)
        if n:
            raise RuntimeError(
                f"spgemm_bcsr numeric kernel: {n} full-table probes or block "
                f"rows whose flushed count disagrees with indptr_c (table "
                f"sizes or indptr_c do not fit these operands)")
    return out_bcol, out_blk
