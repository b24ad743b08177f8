"""Public entry points of attention (port of
``repro.kernels.flash_attention.ops``, forward only).

``flash_attention``   -- the hand-written CUDA kernels on CUDA tensors,
                         their plain version on CPU tensors; keeps the
                         reference's tiling preconditions.  The model's
                         prefill calls ``kernel.flash_fwd``, which takes
                         any length.
``chunked_attention`` -- online softmax over KV chunks in plain PyTorch,
                         with sliding windows; what the reference computes
                         outside Pallas.  Its custom VJP waits for the
                         training slice.
"""
from __future__ import annotations

import torch

from . import kernel as K
from .kernel import KERNEL_CALLS, VARIANT_CALLS
from .ref import NEG_INF


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


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None, bq: int = 128,
                    bkv: int = 128) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, Hkv, Skv, D) -> (B, H, Sq, D).

    ``bq`` and ``bkv`` keep the reference's preconditions: each is cut to
    its sequence length and must then divide it (``ValueError`` where the
    reference asserts).  They do not change the result: the CUDA kernels
    tile by their own sizes and mask ragged edges, and the causal mask is
    the reference kernel's (query ``i`` sees key ``j`` iff ``i >= j``).
    """
    sq, d = q.shape[2], q.shape[3]
    skv = k.shape[2]
    bq = min(bq, sq)
    bkv = min(bkv, skv)
    if bq < 1 or bkv < 1 or sq % bq or skv % bkv:
        raise ValueError(f"flash_attention needs Sq % bq == 0 and Skv % bkv "
                         f"== 0 after bq = min(bq, Sq), bkv = min(bkv, Skv); "
                         f"got Sq {sq}, bq {bq}, Skv {skv}, bkv {bkv}")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    return K.flash_fwd(q, k, v, scale=scale, causal=causal)


def chunked_attention(q, k, v, *, causal: bool = True,
                      window: int | None = None,
                      bkv: int = 512) -> torch.Tensor:
    """Online-softmax attention over KV chunks of ``bkv`` keys.

    q positions are the *last* Sq positions of the kv stream (prefill: Sq
    == Skv; decode: Sq == 1); ``window`` adds sliding-window masking.
    GQA KV heads are repeated up front.  Softmax statistics are float32;
    the probability-times-V contraction runs in the input dtype, as the
    reference's; the output is q's dtype.
    """
    b, h, sq, d = q.shape
    skv = k.shape[2]
    group = h // k.shape[1]
    bkv = min(bkv, skv)
    if bkv < 1 or skv % bkv:
        raise ValueError(f"chunked_attention needs Skv % bkv == 0 after "
                         f"bkv = min(bkv, Skv); got Skv {skv}, bkv {bkv}")
    kf = torch.repeat_interleave(k, group, dim=1)
    vf = torch.repeat_interleave(v, group, dim=1)
    scale = 1.0 / (d ** 0.5)
    qf = q.float()
    q_pos = (skv - sq) + torch.arange(sq, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    for c0 in range(0, skv, bkv):
        kc, vc = kf[:, :, c0:c0 + bkv], vf[:, :, c0:c0 + bkv]
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kc.float()) * scale
        if causal:
            k_pos = c0 + torch.arange(bkv, device=q.device)
            keep = q_pos[:, None] >= k_pos[None, :]
            if window is not None:
                keep &= (q_pos[:, None] - k_pos[None, :]) < window
            s = torch.where(keep, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(vc.dtype), vc).float()
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
