"""Hand-written CUDA flash-attention forward kernels and their wrapper.

Two kernels replace the Pallas kernel ``fwd_call`` of
``repro/kernels/flash_attention/kernel.py``, each for its inputs:

* ``csrc/flash_attention_wgmma.cu``: bfloat16 at head dims 64, 128 and
  256 on the tensor cores (``wgmma``, K/V tiles by TMA under mbarriers, one
  K/V tile for every query head of a GQA group);
* ``csrc/flash_attention.cu``: float32 (IEEE ``fmaf``, no TF32) and
  bfloat16 at head dims 16 and 32, on the CUDA cores.

Each source's header says how the TPU's sequential kv grid axis became a
loop inside each block.  They are built like the other kernels
(:mod:`repro_torch.kernels._build`): one ``nvcc`` for ``sm_90a`` per
source, both at once, at first use; a plain C interface, ``ctypes``.

:func:`flash_fwd` takes the kernels' arguments.  On CPU tensors it runs
the plain version of ``ref.py``; on CUDA tensors it launches the kernel
:func:`variant` names or raises -- a build or launch failure is never
answered with the other kernel, the plain version or a library's
attention.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build
from . import ref

#: Launch counters: ``flash_fwd`` gains one where the wrapper launches a
#: kernel, ``plain`` where it runs the plain version.
KERNEL_CALLS = {"flash_fwd": 0, "plain": 0}
#: Which kernel each ``flash_fwd`` launch ran (:func:`variant`).
VARIANT_CALLS = {"wgmma": 0, "fma": 0}

#: q/k/v dtypes the kernels take, with their code in the CUDA-core
#: kernel's C interface.
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the kernels take (the configs' 64, 128 and 256, and the
#: reduced configs' 16 and 32), and those the tensor-core kernel takes.
HEAD_DIMS = (16, 32, 64, 128, 256)
WGMMA_HEAD_DIMS = (64, 128, 256)

SOURCE = Path(__file__).parent / "csrc" / "flash_attention.cu"
WGMMA_SOURCE = Path(__file__).parent / "csrc" / "flash_attention_wgmma.cu"
SOURCES = (SOURCE, WGMMA_SOURCE)
_FUNCTIONS = {
    SOURCE: {"flash_fwd_launch": [ctypes.c_int] * 8 + [ctypes.c_float]
             + [ctypes.c_void_p] * 6},
    WGMMA_SOURCE: {"flash_fwd_wgmma_launch": [ctypes.c_int] * 7
                   + [ctypes.c_float] + [ctypes.c_void_p] * 6},
}
_VARIANT_SOURCE = {"fma": SOURCE, "wgmma": WGMMA_SOURCE}
_libs = None
#: the tensor-core kernel's own error codes (past the CUDA runtime's)
_WGMMA_ERRORS = {10000: "cuTensorMapEncodeTiled not found in libcuda",
                 10001: "an operand TMA cannot address"}


def variant(dtype: torch.dtype, d: int) -> str:
    """The kernel :func:`flash_fwd` launches for q's dtype and head dim:
    ``"wgmma"`` (tensor cores) for bfloat16 at ``WGMMA_HEAD_DIMS``,
    ``"fma"`` (CUDA cores) for float32 -- whose gate, 2e-5 against the
    plain version, a bf16 product could not hold -- and for bfloat16 at
    head dims 16 and 32 (the reduced configs' widths, under the 64
    columns of one 128-byte swizzled row)."""
    return "wgmma" if dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS \
        else "fma"


def build() -> dict:
    """Compile both sources (in parallel, those not built yet) and load
    the libraries; returns ``{variant: record}`` with
    :func:`repro_torch.kernels._build.load`'s records.  Later calls return
    the first call's result."""
    global _libs
    if _libs is None:
        _build.compile_sources(SOURCES)
        _libs = {name: _build.load(src, _FUNCTIONS[src])
                 for name, src in _VARIANT_SOURCE.items()}
    return _libs


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


def _tma_addressable(t) -> bool:
    """A TMA tensor map can describe ``t`` as it lies: last dim
    contiguous, 16-byte aligned, every other stride of a dimension longer
    than 1 a positive multiple of 16 bytes."""
    return t.stride(3) == 1 and t.data_ptr() % 16 == 0 and all(
        t.shape[i] == 1 or (t.stride(i) > 0 and t.stride(i) % 8 == 0)
        for i in range(3))


def flash_fwd(q, k, v, *, scale: float, causal: bool) -> torch.Tensor:
    """Attention forward ``(B, H, Sq, D)`` in q's dtype: query head ``h``
    reads KV head ``h // (H / Hkv)``; with ``causal`` query ``i`` sees key
    ``j`` iff ``i >= j`` (the reference kernel's mask, no offset).  Any
    lengths; q, k, v may be strided views.  On CUDA tensors it launches
    the kernel :func:`variant` picks for (dtype, head dim)."""
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
    kind = variant(q.dtype, d)
    if kind == "wgmma":
        # the tensor maps take any strides TMA can address; others copy
        q, k, v = (t if _tma_addressable(t) else
                   t.clone(memory_format=torch.contiguous_format)
                   for t in (q, k, v))
    else:
        # the kernel takes any batch, head and row strides, not the last
        q, k, v = (t if t.stride(3) == 1 else t.contiguous()
                   for t in (q, k, v))
    strides = (ctypes.c_longlong * 9)(*(t.stride(i) for t in (q, k, v)
                                        for i in range(3)))
    lib = build()[kind]["lib"]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            ctypes.addressof(strides), stream)
    if kind == "wgmma":
        err = lib.flash_fwd_wgmma_launch(b, h, hkv, sq, skv, d, int(causal),
                                         float(scale), *ptrs)
    else:
        err = lib.flash_fwd_launch(DTYPES[q.dtype], b, h, hkv, sq, skv, d,
                                   int(causal), float(scale), *ptrs)
    if err != 0:
        what = _WGMMA_ERRORS.get(err) or (
            f"cuTensorMapEncodeTiled returned CUresult {err - 20000}"
            if err >= 20000 else f"CUDA error {err}")
        raise RuntimeError(f"flash_fwd launch ({kind} kernel) failed: "
                           f"{what}")
    KERNEL_CALLS["flash_fwd"] += 1
    VARIANT_CALLS[kind] += 1
    return out
