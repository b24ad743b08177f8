"""Exact-softmax attention: the oracle and the flash kernel's plain version.

:func:`attention_ref` ports ``repro.kernels.flash_attention.ref``: GQA,
causal mask with the queries taken as the *last* Sq positions of the KV
stream (query i sees key j iff ``i + Skv - Sq >= j``).

:func:`flash_attention_plain` computes what the flash kernel computes, in
plain PyTorch: the kernel's causal mask (query i sees key j iff
``i >= j``, no offset, as ``repro/kernels/flash_attention/kernel.py``'s
``_fwd_kernel``), masked scores set to ``NEG_INF``, softmax statistics
and the weighted sum in float32, ``acc / max(l, 1e-30)`` cast to q's
dtype.  The two masks agree only at ``Sq == Skv``, which is what prefill
uses.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, h: int) -> torch.Tensor:
    """(B, Hkv, S, D) -> (B, H, S, D): query head ``h`` reads KV head
    ``h // (H / Hkv)``."""
    group = h // k.shape[1]
    return torch.repeat_interleave(k, group, dim=1)


def attention_ref(q, k, v, *, causal: bool = True,
                  scale: float | None = None) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, Hkv, Skv, D). Returns (B, H, Sq, D)."""
    _, h, sq, d = q.shape
    skv = k.shape[2]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    kq = _repeat_kv(k, h).float()
    vq = _repeat_kv(v, h).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kq) * scale
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        mask = rows >= torch.arange(skv, device=q.device)[None, :]
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vq).to(q.dtype)


def flash_attention_plain(q, k, v, *, causal: bool,
                          scale: float) -> torch.Tensor:
    """The flash kernel's function, exact softmax in float32.

    q: (B, H, Sq, D); k, v: (B, Hkv, Skv, D) -> (B, H, Sq, D) in q's dtype.
    """
    _, h, sq, _ = q.shape
    skv = k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                     _repeat_kv(k, h).float()) * scale
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None]
        mask = rows >= torch.arange(skv, device=q.device)[None, :]
        s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bhkd->bhqd", p, _repeat_kv(v, h).float())
    return (acc / l.clamp_min(1e-30)).to(q.dtype)
