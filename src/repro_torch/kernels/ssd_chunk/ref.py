"""The chunked SSD in plain PyTorch (port of ``repro.models.ssm``'s
``ssd_chunked``): the oracle, and the SSD chunk kernel's plain version.

It lives here, not in ``models/ssm.py``, so that the model imports the
kernel package and not the other way round.
"""
from __future__ import annotations

import torch

#: the upper triangle's exponent, set before ``exp`` (never exponentiated)
NEG_BIG = -1e30


def ssd_chunked(xd, log_a, Bm, Cm, chunk: int):
    """SSD: y_t = C_t^T H_t,  H_t = a_t H_{t-1} + B_t xd_t^T.

    xd: (b, s, nh, hp)  (inputs already scaled by dt)
    log_a: (b, s, nh)   (per-step log decay, <= 0)
    Bm, Cm: (b, s, g, n); heads map to groups by nh//g blocks.
    Returns (b, s, nh, hp) in xd's dtype and the final state (b, nh, hp,
    n) in float32.
    """
    b, s, nh, hp = xd.shape
    g, n = Bm.shape[2], Bm.shape[3]
    rep = nh // g
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    nc, Q = s // chunk, chunk
    f32 = torch.float32

    xd_ = xd.reshape(b, nc, Q, nh, hp).to(f32)
    la = log_a.reshape(b, nc, Q, nh).to(f32)
    B_ = Bm.reshape(b, nc, Q, g, n).repeat_interleave(rep, dim=3).to(f32)
    C_ = Cm.reshape(b, nc, Q, g, n).repeat_interleave(rep, dim=3).to(f32)

    cum = torch.cumsum(la, dim=2)                         # (b, nc, Q, nh)
    # intra-chunk: Y[i] += sum_{j<=i} (C_i.B_j) exp(cum_i - cum_j) xd_j
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (b,nc,Qi,Qj,nh)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=xd.device).tril()
    # mask BEFORE exp: the upper triangle holds positive exponents
    seg = torch.where(tri[None, None, :, :, None], seg, NEG_BIG)
    Ld = torch.exp(seg)
    CB = torch.einsum("bcihn,bcjhn->bcijh", C_, B_)       # (b,nc,Qi,Qj,nh)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", CB * Ld, xd_)

    # chunk-end states: S_c = sum_j exp(cum_end - cum_j) B_j xd_j^T
    dec_end = torch.exp(cum[:, :, -1:, :] - cum)          # (b, nc, Q, nh)
    S_c = torch.einsum("bcjhn,bcjhp->bchpn", dec_end[..., None] * B_, xd_)

    # cross-chunk recurrence: H_c = exp(sum la_c) H_{c-1} + S_c, emitting
    # H_{c-1} for chunk c
    a_chunk = torch.exp(cum[:, :, -1, :])                 # (b, nc, nh)
    h = torch.zeros((b, nh, hp, n), dtype=f32, device=xd.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * a_chunk[:, c, :, None, None] + S_c[:, c]
    h_prev = torch.stack(h_prev, dim=1)                   # (b,nc,nh,hp,n)

    # inter-chunk: Y[i] += exp(cum_i) C_i . H_{c-1}
    y_inter = torch.exp(cum)[..., None] * torch.einsum(
        "bcihn,bchpn->bcihp", C_, h_prev)
    y = (y_intra + y_inter).reshape(b, s, nh, hp)
    return y.to(xd.dtype), h
