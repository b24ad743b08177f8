"""Hand-written CUDA flash-attention forward kernel and its wrapper.

``csrc/flash_attention.cu`` replaces the Pallas kernel ``fwd_call`` of
``repro/kernels/flash_attention/kernel.py``; its header says how the TPU's
sequential kv grid axis became a loop inside each block.  It is built like
the other kernels (:mod:`repro_torch.kernels._build`): ``nvcc`` for
``sm_90a`` at first use, a plain C interface, ``ctypes``.

:func:`flash_fwd` takes the kernel's arguments.  On CPU tensors it runs
the plain version of ``ref.py``; on CUDA tensors it launches the kernel or
raises -- a build or launch failure is never answered with the plain
version or with a library's attention.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build
from . import ref

#: Launch counters: ``flash_fwd`` gains one where the wrapper launches the
#: kernel, ``plain`` where it runs the plain version.
KERNEL_CALLS = {"flash_fwd": 0, "plain": 0}

#: q/k/v dtypes the kernel takes, with their code in the C interface.
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the kernel is compiled for (the configs' 64, 128 and 256, and
#: the reduced configs' 16 and 32).
HEAD_DIMS = (16, 32, 64, 128, 256)

SOURCE = Path(__file__).parent / "csrc" / "flash_attention.cu"
_FUNCTIONS = {"flash_fwd_launch": [ctypes.c_int] * 8 + [ctypes.c_float]
              + [ctypes.c_void_p] * 6}
_lib = None


def build() -> dict:
    """Compile (if this source was not built yet) and load the library;
    returns :func:`repro_torch.kernels._build.load`'s record."""
    global _lib
    info = _build.load(SOURCE, _FUNCTIONS)
    _lib = info["lib"]
    return info


def _check_shapes(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B, H, Sq, D) and k, v (B, Hkv, Skv, D) "
                         f"alike, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or k.shape[1] < 1 \
            or h % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)}: same batch and head dim, and "
                         f"n_heads a multiple of n_kv_heads")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}: "
                         f"the flash kernel takes tensors on one device")


def flash_fwd(q, k, v, *, scale: float, causal: bool) -> torch.Tensor:
    """Attention forward ``(B, H, Sq, D)`` in q's dtype: query head ``h``
    reads KV head ``h // (H / Hkv)``; with ``causal`` query ``i`` sees key
    ``j`` iff ``i >= j`` (the reference kernel's mask, no offset)."""
    _check_shapes(q, k, v)
    if q.device.type == "cpu":
        KERNEL_CALLS["plain"] += 1
        return ref.flash_attention_plain(q, k, v, causal=causal, scale=scale)
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the flash kernel takes float32 or bfloat16 q, k, "
                         f"v of one dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}: the flash kernel is built for "
                         f"{HEAD_DIMS}")
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    if sq == 0 or b == 0:
        return out
    if skv == 0:
        raise ValueError("no keys: Skv must be at least 1")
    # the kernel takes any batch, head and row strides, not the last
    q, k, v = (t if t.stride(3) == 1 else t.contiguous() for t in (q, k, v))
    strides = (ctypes.c_longlong * 9)(*(t.stride(i) for t in (q, k, v)
                                        for i in range(3)))
    build()
    err = _lib.flash_fwd_launch(
        DTYPES[q.dtype], b, h, hkv, sq, skv, d, int(causal), float(scale),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        ctypes.addressof(strides), torch.cuda.current_stream(q.device)
        .cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {err}")
    KERNEL_CALLS["flash_fwd"] += 1
    return out
