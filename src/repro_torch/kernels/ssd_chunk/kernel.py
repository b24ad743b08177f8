"""Hand-written CUDA SSD chunk-scan kernel and its wrapper.

``csrc/ssd_chunk.cu`` replaces the Pallas kernel ``ssd_call`` of
``repro/kernels/ssd_chunk/kernel.py``; its header says how the TPU's
sequential chunk grid axis became a loop inside each block.  It is built
like the other kernels (:mod:`repro_torch.kernels._build`): ``nvcc`` for
``sm_90a`` at first use, a plain C interface, ``ctypes``.

:func:`ssd_fwd` takes the kernel's arguments.  On CPU tensors it runs the
plain version of ``ref.py``; on CUDA tensors it launches the kernel or
raises -- a build or launch failure is never answered with the plain
version.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build
from . import ref

#: Launch counters: ``ssd_chunk`` gains one where the wrapper launches the
#: kernel, ``plain`` where it runs the plain version.
KERNEL_CALLS = {"ssd_chunk": 0, "plain": 0}

#: xd/B/C dtypes the kernel takes, with their code in the C interface.
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the longest chunk and the largest state the kernel takes (its shared
#: memory holds n x 168 floats beside the chunk's cumsum)
MAX_CHUNK, MAX_STATE = 256, 256

SOURCE = Path(__file__).parent / "csrc" / "ssd_chunk.cu"
_FUNCTIONS = {"ssd_chunk_launch": [ctypes.c_int] * 8
              + [ctypes.c_void_p] * 8}
_lib = None


def build() -> dict:
    """Compile (if this source was not built yet) and load the library;
    returns :func:`repro_torch.kernels._build.load`'s record."""
    global _lib
    info = _build.load(SOURCE, _FUNCTIONS)
    _lib = info["lib"]
    return info


def _check_shapes(xd, log_a, Bm, Cm, chunk: int) -> None:
    if xd.dim() != 4 or Bm.dim() != 4 or Cm.shape != Bm.shape:
        raise ValueError(f"want xd (b, s, nh, hp) and B, C (b, s, g, n) "
                         f"alike, got {tuple(xd.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}")
    b, s, nh, _ = xd.shape
    g = Bm.shape[2]
    if tuple(log_a.shape) != (b, s, nh) or tuple(Bm.shape[:2]) != (b, s) \
            or g < 1 or nh % g:
        raise ValueError(f"log_a {tuple(log_a.shape)} and B "
                         f"{tuple(Bm.shape)} do not fit xd {tuple(xd.shape)}: "
                         f"log_a (b, s, nh), B and C (b, s, g, n) with nh a "
                         f"multiple of g")
    if chunk < 1 or s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    if any(t.device != xd.device for t in (log_a, Bm, Cm)):
        raise ValueError(f"xd, log_a, B, C on {xd.device}, {log_a.device}, "
                         f"{Bm.device}, {Cm.device}: the SSD kernel takes "
                         f"tensors on one device")


def ssd_fwd(xd, log_a, Bm, Cm, chunk: int):
    """The chunk scan over chunks of ``chunk`` steps: ``(y (b, s, nh, hp)``
    in xd's dtype, ``hT (b, nh, n, hp))`` float32 -- hT in the Pallas
    kernel's (n, hp) order, the transpose of ``ref.ssd_chunked``'s."""
    _check_shapes(xd, log_a, Bm, Cm, chunk)
    if xd.device.type == "cpu":
        KERNEL_CALLS["plain"] += 1
        y, h = ref.ssd_chunked(xd, log_a, Bm, Cm, chunk)
        return y, h.transpose(-1, -2).contiguous()
    if xd.dtype not in DTYPES or Bm.dtype != xd.dtype \
            or Cm.dtype != xd.dtype:
        raise ValueError(f"the SSD kernel takes float32 or bfloat16 xd, B, "
                         f"C of one dtype, got {xd.dtype}, {Bm.dtype}, "
                         f"{Cm.dtype}")
    if log_a.dtype != torch.float32:
        raise ValueError(f"log_a must be float32, got {log_a.dtype}")
    b, s, nh, hp = xd.shape
    g, n = Bm.shape[2], Bm.shape[3]
    if chunk > MAX_CHUNK or n > MAX_STATE:
        raise ValueError(f"chunk {chunk} and state {n}: the SSD kernel takes "
                         f"chunks up to {MAX_CHUNK} and states up to "
                         f"{MAX_STATE}")
    y = torch.empty((b, s, nh, hp), dtype=xd.dtype, device=xd.device)
    hT = torch.empty((b, nh, n, hp), dtype=torch.float32, device=xd.device)
    if b == 0:
        return y, hT
    # the kernel takes any batch, step and head strides, not the last
    xd, Bm, Cm = (t if t.stride(3) == 1 else t.contiguous()
                  for t in (xd, Bm, Cm))
    log_a = log_a.contiguous()
    strides = (ctypes.c_longlong * 9)(*(t.stride(i) for t in (xd, Bm, Cm)
                                        for i in range(3)))
    build()
    err = _lib.ssd_chunk_launch(
        DTYPES[xd.dtype], b, s, nh, hp, g, n, chunk, xd.data_ptr(),
        log_a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
        hT.data_ptr(), ctypes.addressof(strides),
        torch.cuda.current_stream(xd.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk launch failed: CUDA error {err}")
    KERNEL_CALLS["ssd_chunk"] += 1
    return y, hT
