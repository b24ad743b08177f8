"""The single-device part of ``repro.parallel.sharding``.

The reference's :class:`ParallelCtx` carries a mesh, the sharding rules
of the TPU pods and the training switches; the port serves on one card,
so it keeps only the field its model code reads, ``attn_impl``.  Meshes,
``safe_pspec``, ``constrain`` and the parameter shardings wait for the
distributed slice (ROADMAP.md, Queue 1 item 7); ``remat`` and
``scan_unroll`` for the training slice.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ParallelCtx:
    """``attn_impl`` picks the prefill attention: ``"flash"`` (the
    hand-written kernels' wrapper ``flash_fwd``), ``"full"`` (exact softmax,
    ``attention_ref``) or ``"chunked"`` (online softmax over KV chunks).
    """
    attn_impl: str = "chunked"        # chunked | flash | full


def single_device_ctx(**kw) -> ParallelCtx:
    return ParallelCtx(**kw)
