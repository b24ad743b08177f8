"""Hand-written CUDA hash SpGEMM kernels (paper Figs. 7 and 8) and their
wrappers.

``csrc/spgemm_hash.cu`` replaces the Pallas kernels of
``repro/kernels/spgemm_hash/kernel.py`` (``numeric_call``,
``symbolic_call`` and the ``_probe_vector`` mode of both); its header says
how the design maps the TPU's sequential bin grid onto the card.  It is
compiled with ``nvcc`` for ``sm_90a`` at first use, into a shared library
with a plain C interface under ``build/torch_ext/`` at the root of the
checkout, and loaded with ``ctypes``.  Nothing is compiled at import, so
the module imports on a machine without CUDA.

:func:`symbolic_call` and :func:`numeric_call` take the reference
builders' arguments.  On CPU tensors they run the plain versions of
``ref.py``; on CUDA tensors they launch the kernel or raise -- a build or
launch failure is never answered with the plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from . import ref

#: Vector probe width: slots compared per step in hash_vector mode.
CHUNK = 8

#: Launch counters.  A wrapper adds one where it launches its kernel (one
#: call covers every bin), and ``plain`` counts the wrappers' runs of the
#: plain versions -- zero on a card proves the main path never took them.
KERNEL_CALLS = {"symbolic": 0, "numeric": 0, "symbolic_vector": 0,
                "numeric_vector": 0, "plain": 0}

#: Largest table kept in shared memory: 16,384 slots, 128 KB of key+value.
SMEM_SLOTS = 16384
#: Blocks that share the global-memory tables of a bin with larger tables.
GLOBAL_BLOCKS = 264

_SOURCE = Path(__file__).parent / "csrc" / "spgemm_hash.cu"
_BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "torch_ext"
_lib = None
_build_info = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def build() -> dict:
    """Compile (if this source was not built yet) and load the library.

    Returns ``{"seconds", "path", "ptxas"}``: the build time (near 0 when
    a library of the same source was already on disk) and what ``ptxas
    -v`` said about registers, shared memory and spills.  Later calls in
    the process return the first call's result.
    """
    global _lib, _build_info
    if _build_info is not None:
        return _build_info
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:16]
    path = _BUILD_DIR / f"spgemm_hash_{digest}.so"
    log = path.with_suffix(".log")
    t0 = time.perf_counter()
    if not path.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), "-gencode=arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(tmp), str(_SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, path)
    seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(path))
    fn = lib.spgemm_hash_launch
    fn.argtypes = [ctypes.c_int] * 9 + [ctypes.c_void_p] * 14
    fn.restype = ctypes.c_int
    _lib = lib
    _build_info = {"seconds": seconds, "path": str(path),
                   "ptxas": log.read_text() if log.exists() else ""}
    return _build_info


def _check(name, t, dtype, device):
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: want a contiguous {dtype} tensor on "
                         f"{device}, got {t.dtype} on {t.device}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_bins(numeric, vector, offsets, bin_tsize, table_size, indptr_a,
                 indptr_b, a_idx, a_val, b_idx, b_val, indptr_c, out_cols,
                 out_vals, row_nnz, errors):
    cap_c = 0 if out_cols is None else out_cols.shape[0]
    dev = a_idx.device
    for name, t in (("indptr_a", indptr_a), ("indptr_b", indptr_b),
                    ("a_idx", a_idx), ("b_idx", b_idx)):
        _check(name, t, torch.int32, dev)
    for name, t in (("a_val", a_val), ("b_val", b_val)):
        _check(name, t, torch.float32, dev)
    if indptr_c is not None:
        _check("indptr_c", indptr_c, torch.int32, dev)
    _check("errors", errors, torch.int32, dev)
    build()
    bounds = offsets.tolist()
    sizes = bin_tsize.tolist()
    m = indptr_a.shape[0] - 1
    if len(bounds) != len(sizes) + 1 or \
            any(not 0 <= r0 <= r1 <= m for r0, r1 in zip(bounds, bounds[1:])):
        raise ValueError(f"bin offsets {bounds} do not partition {m} rows "
                         f"into {len(sizes)} bins")
    stream = torch.cuda.current_stream(dev).cuda_stream
    for b, tsz in enumerate(sizes):
        r0, r1 = bounds[b], bounds[b + 1]
        if r1 <= r0:
            continue
        tsz = min(int(tsz), table_size)
        if tsz < 1 or tsz & (tsz - 1) or (vector and tsz < CHUNK):
            raise ValueError(f"bin {b}: table size {tsz} is not a power of "
                             f"two{' >= CHUNK' if vector else ''}")
        ws_keys = ws_vals = None
        if tsz <= SMEM_SLOTS:
            grid, smem = r1 - r0, tsz * (8 if numeric else 4)
            block = 64 if tsz <= 256 else (128 if tsz <= 4096 else 256)
        else:
            grid, smem, block = min(r1 - r0, GLOBAL_BLOCKS), 0, 512
            ws_keys = torch.empty(grid * tsz, dtype=torch.int32, device=dev)
            if numeric:
                ws_vals = torch.empty(grid * tsz, dtype=torch.float32,
                                      device=dev)
        err = _lib.spgemm_hash_launch(
            int(numeric), int(vector), r0, r1, tsz, cap_c, grid, block, smem,
            _ptr(indptr_a), _ptr(a_idx), _ptr(a_val), _ptr(indptr_b),
            _ptr(b_idx), _ptr(b_val), _ptr(indptr_c), _ptr(out_cols),
            _ptr(out_vals), _ptr(row_nnz), _ptr(errors), _ptr(ws_keys),
            _ptr(ws_vals), stream)
        if err != 0:
            raise RuntimeError(f"spgemm_hash launch failed for bin {b}: "
                               f"CUDA error {err}")


def _raise_on_errors(errors: torch.Tensor, what: str) -> None:
    n = int(errors)
    if n:
        raise RuntimeError(
            f"spgemm_hash {what} kernel: {n} full-table probes or rows whose "
            f"flushed count disagrees with indptr_c (table sizes or "
            f"indptr_c do not fit these operands)")


def symbolic_call(offsets, bin_tsize, indptr_a, indptr_b, a_idx, a_val,
                  b_idx, b_val, *, table_size: int, vector: bool,
                  errors: torch.Tensor | None = None) -> torch.Tensor:
    """Distinct columns per output row, ``(m,) int32``.

    ``errors`` (CUDA only): a 1-element int32 tensor that gains one per
    probe that found its table full -- zero on every valid plan.  Without
    it the wrapper reads its own count after the launch and raises if it
    is not zero.
    """
    if a_idx.device.type == "cpu":
        KERNEL_CALLS["plain"] += 1
        return ref.symbolic_plain(offsets, bin_tsize, indptr_a, indptr_b,
                                  a_idx, a_val, b_idx, b_val,
                                  table_size=table_size, vector=vector)
    m = indptr_a.shape[0] - 1
    dev = a_idx.device
    row_nnz = torch.zeros(m, dtype=torch.int32, device=dev)
    own = errors is None
    if own:
        errors = torch.zeros(1, dtype=torch.int32, device=dev)
    _launch_bins(False, vector, offsets, bin_tsize, table_size, indptr_a,
                 indptr_b, a_idx, a_val, b_idx, b_val, None, None, None,
                 row_nnz, errors)
    KERNEL_CALLS["symbolic_vector" if vector else "symbolic"] += 1
    if own:
        _raise_on_errors(errors, "symbolic")
    return row_nnz


def numeric_call(offsets, bin_tsize, indptr_a, indptr_b, indptr_c, a_idx,
                 a_val, b_idx, b_val, *, cap_c: int, table_size: int,
                 vector: bool, errors: torch.Tensor | None = None):
    """``(cols (cap_c,) int32, vals (cap_c,) float32)``: each row's
    entries at ``indptr_c``, unsorted, the tail zero.

    ``errors`` (CUDA only): a 1-element int32 tensor that gains one per
    row whose flushed count disagrees with ``indptr_c`` and per probe that
    found its table full -- zero on every valid plan.  Without it the
    wrapper reads its own count after the launch and raises if it is not
    zero.
    """
    if a_idx.device.type == "cpu":
        KERNEL_CALLS["plain"] += 1
        return ref.numeric_plain(offsets, bin_tsize, indptr_a, indptr_b,
                                 indptr_c, a_idx, a_val, b_idx, b_val,
                                 cap_c=cap_c, table_size=table_size,
                                 vector=vector)
    dev = a_idx.device
    out_cols = torch.zeros(cap_c, dtype=torch.int32, device=dev)
    out_vals = torch.zeros(cap_c, dtype=torch.float32, device=dev)
    own = errors is None
    if own:
        errors = torch.zeros(1, dtype=torch.int32, device=dev)
    _launch_bins(True, vector, offsets, bin_tsize, table_size, indptr_a,
                 indptr_b, a_idx, a_val, b_idx, b_val, indptr_c, out_cols,
                 out_vals, None, errors)
    KERNEL_CALLS["numeric_vector" if vector else "numeric"] += 1
    if own:
        _raise_on_errors(errors, "numeric")
    return out_cols, out_vals
