"""The port's SSD chunk scan (``repro_torch.kernels.ssd_chunk``) against
``repro.kernels.ssd_chunk``.

Same inputs in one process, made with numpy from a seed: ``ssd_chunk``
(on CPU tensors: the plain version behind the CUDA kernel) against the
reference's Pallas kernel ``ssd_pallas`` run in interpret mode and
against the pure-jnp oracle ``ssd_ref``, on the reference's four sweep
shapes and on many chunks, strong decay, a chunk of 13, a chunk of 1, a
chunk cut to the sequence, and a state size unlike the head dim (so a
transposed final state cannot pass).  The final state is compared in the
Pallas kernel's (n, hp) order and, transposed, in the oracle's (hp, n).
Tolerances: float32 within 1e-4 (sums in another order, as
``tests/test_ssd_kernel.py`` holds the Pallas kernel), plus 8 float32
ulps of the largest |cumsum| times the largest |y| where the cumsum
reaches -3,000 (a difference of two such cumsums carries their rounding);
bfloat16 inputs
against the float32 oracle within 2e-2 of the largest |y| (one bf16
rounding of each input and of y).  On CPU tensors the CUDA kernel is
never launched.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_chunk.ops import ssd_pallas
from repro.kernels.ssd_chunk.ref import ssd_ref
from repro_torch.kernels.ssd_chunk import kernel as K
from repro_torch.kernels.ssd_chunk import ops, ref

TOL, BF16_REL = 1e-4, 2e-2


def inputs(seed, b, s, nh, hp, g, n, decay=0.1):
    """xd, log_a, B, C as numpy float32 (the reference test's draws)."""
    rng = np.random.default_rng(seed)
    xd = rng.normal(size=(b, s, nh, hp)).astype(np.float32) * 0.1
    la = -np.abs(rng.normal(size=(b, s, nh)).astype(np.float32)) * decay
    Bm = rng.normal(size=(b, s, g, n)).astype(np.float32)
    Cm = rng.normal(size=(b, s, g, n)).astype(np.float32)
    return xd, la, Bm, Cm


def err(got, want) -> float:
    return float(np.abs(got.float().numpy() - np.asarray(want)).max())


@pytest.mark.parametrize("b,s,nh,hp,g,n,chunk", [
    (1, 32, 2, 16, 1, 8, 16),     # the reference's sweep: single group
    (2, 64, 4, 16, 2, 8, 16),     # grouped heads
    (1, 48, 6, 8, 3, 16, 8),      # chunk < state, odd ratios
    (2, 32, 4, 32, 4, 8, 32),     # chunk == seq (single chunk)
    (1, 128, 2, 16, 1, 8, 16),    # many chunks: the state carried 8 times
    (1, 39, 4, 8, 2, 24, 13),     # a chunk of 13, n 24 != hp 8
    (2, 7, 2, 8, 1, 12, 1),       # a chunk of 1: the recurrence itself
    (1, 20, 3, 12, 1, 5, 256),    # chunk cut to the sequence, n 5 != hp 12
])
def test_ssd_chunk_matches_pallas_and_oracle(b, s, nh, hp, g, n, chunk):
    xd, la, Bm, Cm = inputs(b * s + n, b, s, nh, hp, g, n)
    K.KERNEL_CALLS.update(ssd_chunk=0, plain=0)
    y, hT = ops.ssd_chunk(*(torch.from_numpy(a) for a in (xd, la, Bm, Cm)),
                          chunk)
    assert K.KERNEL_CALLS == {"ssd_chunk": 0, "plain": 1}
    assert y.dtype == torch.float32 and y.shape == (b, s, nh, hp)
    assert hT.shape == (b, nh, n, hp)
    jin = [jnp.asarray(a) for a in (xd, la, Bm, Cm)]
    yp, hp_ = ssd_pallas(*jin, chunk, interpret=True)
    yr, hr = ssd_ref(*jin, min(chunk, s))
    assert err(y, yp) < TOL and err(hT, hp_) < TOL
    assert err(y, yr) < TOL
    assert err(hT.transpose(-1, -2), hr) < TOL


def test_ssd_chunk_strong_decay():
    """Strong decay (a ~ 0): the output reduces to the intra-chunk term,
    every value finite (the upper triangle is masked before exp)."""
    xd, la, Bm, Cm = inputs(0, 1, 32, 2, 8, 1, 4)
    la = np.full_like(la, -50.0)
    y, hT = ops.ssd_chunk(*(torch.from_numpy(a) for a in (xd, la, Bm, Cm)),
                          8)
    jin = [jnp.asarray(a) for a in (xd, la, Bm, Cm)]
    yp, hp_ = ssd_pallas(*jin, 8, interpret=True)
    yr, _ = ssd_ref(*jin, 8)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(hT).all())
    assert err(y, yp) < TOL and err(y, yr) < TOL and err(hT, hp_) < TOL


def test_ssd_chunk_underflowing_decay_is_finite():
    """mamba2's strongest heads: log_a down to about -16 a step, so cum
    reaches about -3,000 over a chunk of 256 and exp(cum) is 0; exp is
    taken of one difference, so nothing is 0/0.  Each cum_i - cum_j then
    carries a few float32 ulps of |cum| (2.4e-4 at 3,000), in both
    packages' cumsums, so y is held to 8 ulps of the largest |cum| times
    the largest |y| on top of TOL."""
    xd, la, Bm, Cm = inputs(1, 1, 512, 2, 8, 1, 16, decay=1.0)
    la = la * 16.0
    y, hT = ops.ssd_chunk(*(torch.from_numpy(a) for a in (xd, la, Bm, Cm)),
                          256)
    yr, hr = ssd_ref(*(jnp.asarray(a) for a in (xd, la, Bm, Cm)), 256)
    cum_max = float(-la.reshape(2, 256, 2).sum(axis=1).min())
    assert cum_max > 3000
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(hT).all())
    tol = TOL + 8 * np.finfo(np.float32).eps * cum_max * \
        float(jnp.abs(yr).max())
    assert err(y, yr) < tol and err(hT.transpose(-1, -2), hr) < TOL


def test_ssd_chunk_bf16_against_f32_oracle():
    xd, la, Bm, Cm = inputs(2, 1, 64, 4, 16, 2, 24)
    t = [torch.from_numpy(a) for a in (xd, la, Bm, Cm)]
    t = [x.to(torch.bfloat16) if i != 1 else x for i, x in enumerate(t)]
    y, hT = ops.ssd_chunk(*t, 16)
    assert y.dtype == torch.bfloat16 and hT.dtype == torch.float32
    yr, hr = ssd_ref(*(jnp.asarray(x.float().numpy()) for x in t), 16)
    assert err(y, yr) < BF16_REL * float(jnp.abs(yr).max())
    assert err(hT.transpose(-1, -2), hr) < BF16_REL * float(jnp.abs(hr).max())


def test_ssd_chunk_takes_strided_operands():
    """B and C as the model slices them out of the convolution's output."""
    b, s, nh, hp, g, n = 2, 24, 4, 8, 2, 6
    xd, la, _, _ = inputs(3, b, s, nh, hp, g, n)
    xbc = np.random.default_rng(4).normal(
        size=(b, s, 5 + 2 * g * n)).astype(np.float32)
    t = torch.from_numpy(xbc)
    Bm = t[..., 5:5 + g * n].reshape(b, s, g, n)
    Cm = t[..., 5 + g * n:].reshape(b, s, g, n)
    assert not Bm.is_contiguous()
    y, hT = ops.ssd_chunk(torch.from_numpy(xd), torch.from_numpy(la), Bm, Cm,
                          8)
    yr, hr = ref.ssd_chunked(torch.from_numpy(xd), torch.from_numpy(la),
                             Bm.contiguous(), Cm.contiguous(), 8)
    assert torch.equal(y, yr) and torch.equal(hT, hr.transpose(-1, -2))


def test_ssd_chunk_keeps_the_reference_preconditions():
    xd, la, Bm, Cm = (torch.from_numpy(a)
                      for a in inputs(5, 1, 20, 4, 8, 2, 4))
    with pytest.raises(ValueError, match="multiple of chunk 8"):
        ops.ssd_chunk(xd, la, Bm, Cm, 8)
    with pytest.raises(ValueError, match="multiple of g"):
        ops.ssd_chunk(xd[:, :, :3], la[:, :, :3], Bm, Cm, 4)
    with pytest.raises(ValueError, match="log_a"):
        ops.ssd_chunk(xd, la[:, :10], Bm, Cm, 4)
