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


# ---- the tensor-core kernel's three passes, in plain PyTorch ---------------
#
# The same function cut as ``csrc/ssd_chunk_wgmma.cu`` cuts it, so that its
# passes can be checked one by one: (a) each chunk's cumsum and own state,
# (b) the states passed from chunk to chunk, (c) each chunk's output.  The
# states are (hp, n)-ordered, as the kernel keeps them.

def chunk_cumsum(log_a, chunk: int):
    """Pass (a)'s cumsum of log_a within each chunk: (b, s, nh) float32."""
    b, s, nh = log_a.shape
    return torch.cumsum(log_a.float().reshape(b, s // chunk, chunk, nh),
                        dim=2).reshape(b, s, nh)


def chunk_states(xd, cum, Bm, chunk: int):
    """Pass (a): each chunk's own state, the inputs of the chunk decayed to
    its end, S_c = (exp(cum_Q - cum) o xd)^T B: (b, nc, nh, hp, n)
    float32."""
    b, s, nh, hp = xd.shape
    g, n = Bm.shape[2], Bm.shape[3]
    nc = s // chunk
    c = cum.reshape(b, nc, chunk, nh)
    w = torch.exp(c[:, :, -1:, :] - c)                    # (b, nc, Q, nh)
    x = xd.reshape(b, nc, chunk, nh, hp).float() * w[..., None]
    B_ = Bm.reshape(b, nc, chunk, g, n).float().repeat_interleave(
        nh // g, dim=3)
    return torch.einsum("bcjhp,bcjhn->bchpn", x, B_)


def pass_states(S, cum, chunk: int):
    """Pass (b): H_c = exp(cum_Q) H_{c-1} + S_c from H = 0.  Returns the
    state entering each chunk (b, nc, nh, hp, n) and the last (b, nh, hp,
    n), float32."""
    b, nc, nh = S.shape[:3]
    a = torch.exp(cum.reshape(b, nc, chunk, nh)[:, :, -1, :])   # (b, nc, nh)
    h = torch.zeros_like(S[:, 0])
    entering = []
    for c in range(nc):
        entering.append(h)
        h = h * a[:, c, :, None, None] + S[:, c]
    return torch.stack(entering, dim=1), h


def chunk_output(xd, cum, Bm, Cm, entering, chunk: int):
    """Pass (c): y = ((C B^T) o L) xd + exp(cum) o (C H_{c-1}), C B^T once
    per group, L masked before exp; (b, s, nh, hp) in xd's dtype."""
    b, s, nh, hp = xd.shape
    g, n = Bm.shape[2], Bm.shape[3]
    nc, rep = s // chunk, nh // g
    f32 = torch.float32
    C_ = Cm.reshape(b, nc, chunk, g, n).to(f32)
    B_ = Bm.reshape(b, nc, chunk, g, n).to(f32)
    CB = torch.einsum("bcign,bcjgn->bcgij", C_, B_)      # (b, nc, g, Qi, Qj)
    CB = CB.repeat_interleave(rep, dim=2)                 # (b, nc, nh, Qi, Qj)
    c = cum.reshape(b, nc, chunk, nh).permute(0, 1, 3, 2)  # (b, nc, nh, Q)
    seg = c[..., :, None] - c[..., None, :]
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=xd.device).tril()
    L = torch.exp(torch.where(tri, seg, NEG_BIG))
    x = xd.reshape(b, nc, chunk, nh, hp).to(f32)
    y = torch.einsum("bchij,bcjhp->bcihp", CB * L, x)
    C_h = C_.repeat_interleave(rep, dim=3)                # (b, nc, Q, nh, n)
    y = y + torch.exp(c).permute(0, 1, 3, 2)[..., None] * torch.einsum(
        "bcihn,bchpn->bcihp", C_h, entering)
    return y.reshape(b, s, nh, hp).to(xd.dtype)


def ssd_passes(xd, log_a, Bm, Cm, chunk: int):
    """The three passes composed: the same contract as
    :func:`ssd_chunked` (y in xd's dtype, the last state (b, nh, hp, n)
    float32)."""
    cum = chunk_cumsum(log_a, chunk)
    entering, h = pass_states(chunk_states(xd, cum, Bm, chunk), cum, chunk)
    return chunk_output(xd, cum, Bm, Cm, entering, chunk), h


def split_bf16(v):
    """A float32 operand as the kernel feeds it to the tensor cores: hi =
    bf16(v), lo = bf16(v - hi); hi + lo is v within 2^-16 |v| (each part
    keeps 8 significant bits)."""
    hi = v.to(torch.bfloat16)
    return hi, (v - hi.float()).to(torch.bfloat16)
