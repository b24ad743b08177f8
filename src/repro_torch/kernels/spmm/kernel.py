"""Hand-written CUDA SpMM kernel (CSR times dense) and its wrapper.

``csrc/spmm.cu`` replaces the Pallas kernel ``spmm_call`` of
``repro/kernels/spmm/kernel.py``; its header says why the TPU's bins of
equal nnz are gone (one warp per row).  It is built like the other kernels
(:mod:`repro_torch.kernels._build`): ``nvcc`` for ``sm_90a`` at first use,
a plain C interface, ``ctypes``.

:func:`spmm_call` takes the kernel's arguments.  On CPU tensors it runs
the plain version of ``ref.py``; on CUDA tensors it launches the kernel or
raises -- a build or launch failure is never answered with the plain
version.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build
from . import ref

#: Launch counters: ``spmm`` gains one where the wrapper launches the
#: kernel, ``plain`` where it runs the plain version.
KERNEL_CALLS = {"spmm": 0, "plain": 0}

#: X's dtypes the kernel takes, with their code in the C interface.
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

SOURCE = Path(__file__).parent / "csrc" / "spmm.cu"
_FUNCTIONS = {"spmm_launch": [ctypes.c_int] * 5 + [ctypes.c_void_p] * 7}
_lib = None


def build() -> dict:
    """Compile (if this source was not built yet) and load the library;
    returns :func:`repro_torch.kernels._build.load`'s record."""
    global _lib
    info = _build.load(SOURCE, _FUNCTIONS)
    _lib = info["lib"]
    return info


def _check_shapes(indptr, indices, data, x, nnz) -> None:
    if indptr.dim() != 1 or indptr.shape[0] < 1:
        raise ValueError(f"indptr must be (m + 1,), got {tuple(indptr.shape)}")
    if indices.dim() != 1 or data.shape != indices.shape:
        raise ValueError(f"indices and data must be (cap,) alike, got "
                         f"{tuple(indices.shape)} and {tuple(data.shape)}")
    if x.dim() != 2:
        raise ValueError(f"x must be (n, k), got {tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise ValueError(f"x must be float32, bfloat16 or float16, got "
                         f"{x.dtype}")
    if nnz.dim() != 0:
        raise ValueError(f"nnz must be a 0-dim tensor, got "
                         f"{tuple(nnz.shape)}")


def spmm_call(indptr, indices, data, x, nnz) -> torch.Tensor:
    """``y (m, k)`` in ``x``'s dtype: ``y[i] = sum_j data[j] * x[indices[j]]``
    over row ``i``'s slots below ``min(nnz, cap)``, in float32 in slot
    order; ``nnz`` is a 0-dim int32 tensor (the CSR's live length)."""
    _check_shapes(indptr, indices, data, x, nnz)
    dev = x.device
    if dev.type == "cpu":
        for t in (indptr, indices, data, nnz):
            if t.device != dev:
                raise ValueError(f"operands on {t.device} and {dev}: the "
                                 f"SpMM kernel takes tensors on one device")
        KERNEL_CALLS["plain"] += 1
        return ref.spmm_plain(indptr, indices, data, x, nnz)
    for name, t in (("indptr", indptr), ("indices", indices), ("nnz", nnz)):
        _build.check_tensor(name, t, torch.int32, dev)
    _build.check_tensor("data", data, torch.float32, dev)
    _build.check_tensor("x", x, x.dtype, dev)
    m = indptr.shape[0] - 1
    n, k = x.shape
    if m == 0 or n == 0 or k == 0 or indices.shape[0] == 0:
        return torch.zeros((m, k), dtype=x.dtype, device=dev)
    build()
    y = torch.empty((m, k), dtype=x.dtype, device=dev)
    err = _lib.spmm_launch(
        DTYPES[x.dtype], m, n, k, indices.shape[0], nnz.data_ptr(),
        indptr.data_ptr(), indices.data_ptr(), data.data_ptr(), x.data_ptr(),
        y.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"spmm launch failed: CUDA error {err}")
    KERNEL_CALLS["spmm"] += 1
    return y
