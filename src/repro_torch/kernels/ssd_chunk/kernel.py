"""Hand-written CUDA SSD chunk-scan kernels and their wrapper.

Two kernels replace the Pallas kernel ``ssd_call`` of
``repro/kernels/ssd_chunk/kernel.py``, each for its inputs
(:func:`variant`):

* ``csrc/ssd_chunk_wgmma.cu`` (``"tc"``): bfloat16 with head dim and
  state multiples of 16 and operands TMA can address, on the tensor cores
  -- three launches in stream order, the chunks in parallel: (a) each
  chunk's cumsum and own state, (b) the states passed from chunk to chunk,
  (c) each chunk's output with C B^T computed once for a block's heads;
* ``csrc/ssd_chunk.cu`` (``"fma"``): float32, odd widths and unaligned
  strides, on the CUDA cores, the chunks of a head in series in one block.

Each source's header says how the TPU's sequential chunk grid axis was
rethought.  They are built like the other kernels
(:mod:`repro_torch.kernels._build`): one ``nvcc`` for ``sm_90a`` per
source, both at once, at first use; a plain C interface, ``ctypes``.

:func:`ssd_fwd` takes the kernels' arguments.  On CPU tensors it runs the
plain version of ``ref.py``; on CUDA tensors it launches the kernel
:func:`variant` names or raises -- a build or launch failure is never
answered with the other kernel or the plain version.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build
from . import ref

#: Launch counters: ``ssd_chunk`` gains one where the wrapper launches a
#: kernel, ``plain`` where it runs the plain version.
KERNEL_CALLS = {"ssd_chunk": 0, "plain": 0}
#: Which kernel each ``ssd_chunk`` launch ran (:func:`variant`).
VARIANT_CALLS = {"tc": 0, "fma": 0}

#: xd/B/C dtypes the kernel takes, with their code in the C interface.
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the longest chunk and the largest state the kernels take (the CUDA-core
#: kernel's shared memory holds n x 168 floats beside the chunk's cumsum;
#: the tensor-core kernel keeps a chunk's cumsum in shared memory)
MAX_CHUNK, MAX_STATE = 256, 256
#: heads a block of the tensor-core kernel's pass (a) and pass (c) takes.
#: Neither changes a block's registers (C B^T's 128 in (c)) or shared
#: memory but by a head's cumsum (1 KB); (c) computes C B^T once for its
#: heads, so more heads share more of it, while fewer leave more blocks to
#: fill the card.  On the H100 (``tools/ssd_cost.py --sweep``, mamba2-780m
#: widths) 6 was fastest at S 4,096 (16 chunks x 4 row tiles x 8 head sets
#: = 512 blocks of (c), two an SM) and within 2% of the fastest (12) at
#: 32,768; 4 heads for (a) as fast as 2 and faster than 8.
HEADS_STATES, HEADS_OUTPUT = 4, 6
#: the tensor-core kernel's head dims and states are multiples of this
TC_WIDTH = 16

SOURCE = Path(__file__).parent / "csrc" / "ssd_chunk.cu"
TC_SOURCE = Path(__file__).parent / "csrc" / "ssd_chunk_wgmma.cu"
SOURCES = (SOURCE, TC_SOURCE)
_FUNCTIONS = {
    SOURCE: {"ssd_chunk_launch": [ctypes.c_int] * 8
             + [ctypes.c_void_p] * 8},
    TC_SOURCE: {"ssd_chunk_wgmma_launch": [ctypes.c_int] * 10
                + [ctypes.c_void_p] * 10},
}
_VARIANT_SOURCE = {"fma": SOURCE, "tc": TC_SOURCE}
_libs = None
#: the tensor-core kernel's own error codes (past the CUDA runtime's)
_TC_ERRORS = {10000: "cuTensorMapEncodeTiled not found in libcuda",
              10001: "an operand TMA cannot address"}


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


def _tma_addressable(t) -> bool:
    """A TMA tensor map can describe the 4-D ``t`` as it lies: last dim
    contiguous, 16-byte aligned, every other stride of a dimension longer
    than 1 a positive multiple of 16 bytes."""
    return t.stride(3) == 1 and t.data_ptr() % 16 == 0 and all(
        t.shape[i] == 1 or (t.stride(i) > 0
                            and t.stride(i) * t.element_size() % 16 == 0)
        for i in range(3))


def variant(xd, Bm, Cm) -> str:
    """The kernel :func:`ssd_fwd` launches for these operands: ``"tc"``
    (tensor cores) for bfloat16 xd, B and C whose head dim and state are
    multiples of ``TC_WIDTH`` and which TMA can address as they lie;
    ``"fma"`` (CUDA cores) for float32 -- whose gates a bf16 product could
    not hold --, odd widths and unaligned strides."""
    hp, n = xd.shape[3], Bm.shape[3]
    tc = (xd.dtype == Bm.dtype == Cm.dtype == torch.bfloat16
          and hp % TC_WIDTH == 0 and n % TC_WIDTH == 0 and n <= MAX_STATE
          and all(_tma_addressable(t) for t in (xd, Bm, Cm)))
    return "tc" if tc else "fma"


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
    kernel's (n, hp) order, the transpose of ``ref.ssd_chunked``'s.  On
    CUDA tensors it launches the kernel :func:`variant` picks."""
    _check_shapes(xd, log_a, Bm, Cm, chunk)
    if xd.device.type == "cpu":
        KERNEL_CALLS["plain"] += 1
        y, h = ref.ssd_chunked(xd, log_a, Bm, Cm, chunk)
        return y, h.transpose(-1, -2).contiguous()
    _check_cuda(xd, log_a, Bm, Cm, chunk)
    b, s, nh, hp = xd.shape
    n = Bm.shape[3]
    kind = variant(xd, Bm, Cm)
    y = torch.empty((b, s, nh, hp), dtype=xd.dtype, device=xd.device)
    hT = torch.empty((b, nh, n, hp), dtype=torch.float32, device=xd.device)
    if b == 0:
        return y, hT
    if kind == "tc":
        _launch_tc(xd, log_a.contiguous(), Bm, Cm, chunk, y, hT, 7,
                   (HEADS_STATES, HEADS_OUTPUT))
    else:
        # the kernel takes any batch, step and head strides, not the last
        xd, Bm, Cm = (t if t.stride(3) == 1 else t.contiguous()
                      for t in (xd, Bm, Cm))
        log_a = log_a.contiguous()
        strides = (ctypes.c_longlong * 9)(*(t.stride(i) for t in (xd, Bm, Cm)
                                            for i in range(3)))
        err = build()["fma"]["lib"].ssd_chunk_launch(
            DTYPES[xd.dtype], b, s, nh, hp, Bm.shape[2], n, chunk,
            xd.data_ptr(), log_a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            y.data_ptr(), hT.data_ptr(), ctypes.addressof(strides),
            torch.cuda.current_stream(xd.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"ssd_chunk launch (fma kernel) failed: CUDA "
                               f"error {err}")
    KERNEL_CALLS["ssd_chunk"] += 1
    VARIANT_CALLS[kind] += 1
    return y, hT


def _check_cuda(xd, log_a, Bm, Cm, chunk: int) -> None:
    """What both kernels take on the card, beyond :func:`_check_shapes`."""
    if xd.dtype not in DTYPES or Bm.dtype != xd.dtype \
            or Cm.dtype != xd.dtype:
        raise ValueError(f"the SSD kernel takes float32 or bfloat16 xd, B, "
                         f"C of one dtype, got {xd.dtype}, {Bm.dtype}, "
                         f"{Cm.dtype}")
    if log_a.dtype != torch.float32:
        raise ValueError(f"log_a must be float32, got {log_a.dtype}")
    n = Bm.shape[3]
    if chunk > MAX_CHUNK or n > MAX_STATE:
        raise ValueError(f"chunk {chunk} and state {n}: the SSD kernel takes "
                         f"chunks up to {MAX_CHUNK} and states up to "
                         f"{MAX_STATE}")


def _launch_tc(xd, log_a, Bm, Cm, chunk, y, hT, passes: int, heads):
    """Launch the tensor-core kernel's ``passes`` (bit mask: 1 (a), 2 (b),
    4 (c)) with ``heads`` = (heads a block of (a), of (c)); returns its
    scratch (cum (b, s, nh), states (b, s / chunk, nh, hp, n)) float32."""
    b, s, nh, hp = xd.shape
    g, n = Bm.shape[2], Bm.shape[3]
    cum = torch.empty((b, s, nh), dtype=torch.float32, device=xd.device)
    states = torch.empty((b, s // chunk, nh, hp, n), dtype=torch.float32,
                         device=xd.device)
    strides = (ctypes.c_longlong * 9)(*(t.stride(i) for t in (xd, Bm, Cm)
                                        for i in range(3)))
    err = build()["tc"]["lib"].ssd_chunk_wgmma_launch(
        b, s, nh, hp, g, n, chunk, heads[0], heads[1], passes,
        xd.data_ptr(), log_a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        y.data_ptr(), hT.data_ptr(), cum.data_ptr(), states.data_ptr(),
        ctypes.addressof(strides),
        torch.cuda.current_stream(xd.device).cuda_stream)
    if err != 0:
        what = _TC_ERRORS.get(err) or (
            f"cuTensorMapEncodeTiled returned CUresult {err - 20000}"
            if err >= 20000 else f"CUDA error {err}")
        raise RuntimeError(f"ssd_chunk launch (tc kernel) failed: {what}")
    return cum, states


def tc_passes(xd, log_a, Bm, Cm, chunk: int, passes: int = 7,
              heads=(HEADS_STATES, HEADS_OUTPUT)) -> dict:
    """The tensor-core kernel's passes on CUDA tensors, for checks and
    timing, counted nowhere: ``{"y", "hT", "cum", "states"}`` after the
    passes in ``passes`` (1 (a): cum and each chunk's own state S_c^T in
    ``states``; 2 (b): ``states`` then holds the state entering each chunk
    as bf16 hi and lo rows, :func:`states_entering` reads them, and hT the
    last; 4 (c): y).  Raises where :func:`variant` would not pick ``"tc"``."""
    _check_shapes(xd, log_a, Bm, Cm, chunk)
    _check_cuda(xd, log_a, Bm, Cm, chunk)
    if variant(xd, Bm, Cm) != "tc":
        raise ValueError("the tc SSD kernel does not take these operands")
    b, s, nh, hp = xd.shape
    y = torch.empty((b, s, nh, hp), dtype=xd.dtype, device=xd.device)
    hT = torch.empty((b, nh, Bm.shape[3], hp), dtype=torch.float32,
                     device=xd.device)
    cum, states = _launch_tc(xd, log_a.contiguous(), Bm, Cm, chunk, y, hT,
                             passes, heads)
    return {"y": y, "hT": hT, "cum": cum, "states": states}


def states_entering(states):
    """Pass (b)'s output as float32 (b, nc, nh, hp, n): each row's bf16 hi
    (first n values) plus lo (next n), the pair pass (c) multiplies."""
    n = states.shape[-1]
    pairs = states.view(torch.bfloat16)
    return pairs[..., :n].float() + pairs[..., n:].float()
