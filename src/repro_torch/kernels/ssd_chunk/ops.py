"""Public entry point of the SSD chunk scan (port of
``repro.kernels.ssd_chunk.ops``).

``ssd_chunk`` -- the hand-written CUDA kernels on CUDA tensors (the
                 tensor-core one for bfloat16 at widths that are multiples
                 of 16, else the CUDA-core one: ``kernel.variant``), their
                 plain version (``ref.ssd_chunked``) on CPU tensors.
"""
from __future__ import annotations

from . import kernel as K
from .kernel import KERNEL_CALLS, VARIANT_CALLS


def reset_kernel_calls() -> None:
    """Zero the launch counters and the variant counters."""
    for counter in (KERNEL_CALLS, VARIANT_CALLS):
        for k in counter:
            counter[k] = 0


def kernel_call_counts() -> dict:
    """Snapshot of :data:`KERNEL_CALLS`."""
    return dict(KERNEL_CALLS)


def variant_call_counts() -> dict:
    """Snapshot of :data:`VARIANT_CALLS`: which kernel the launches ran."""
    return dict(VARIANT_CALLS)


def ssd_chunk(xd, log_a, Bm, Cm, chunk: int):
    """Same contract as ``repro.kernels.ssd_chunk.ops.ssd_pallas``.

    xd: (b, s, nh, hp) inputs pre-scaled by dt; log_a: (b, s, nh) float32;
    Bm/Cm: (b, s, g, n).  The chunk is cut to ``min(chunk, s)`` and must
    then divide s (``ValueError`` where the reference asserts), and nh must
    be a multiple of g.  Returns (y (b, s, nh, hp), hT (b, nh, n, hp)) --
    hT is (n, hp)-ordered, as the Pallas kernel's; transpose it to match
    ``SSMCache.h``'s (hp, n) when feeding the decode path.
    """
    return K.ssd_fwd(xd, log_a, Bm, Cm, min(chunk, xd.shape[1]))
