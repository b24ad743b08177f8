"""The tensor-core SSD kernel's three passes in plain PyTorch
(``repro_torch.kernels.ssd_chunk.ref``: ``chunk_cumsum``/``chunk_states``
(a), ``pass_states`` (b), ``chunk_output`` (c), composed in
``ssd_passes``) against ``ref.ssd_chunked`` and against
``repro.kernels.ssd_chunk``: the reference's Pallas kernel ``ssd_pallas``
in interpret mode and its pure-jnp oracle ``ssd_ref``.

Same inputs in one process, made with numpy from a seed, on the shapes
of ``tests/test_torch_ssd_chunk.py`` and chunks 250, 150, 13 and 1, a
chunk cut to the sequence, two and three groups, n != hp and underflowing
decay.  Tolerances: float32 within 1e-4 (sums in another order), plus 8
float32 ulps of the largest |cumsum| times the largest |value| where the
cumsum reaches -3,000 (a difference of two such cumsums carries their
rounding).  The hi/lo split that feeds a float32 operand to the tensor
cores (``ref.split_bf16``) is held against the float32 product within
2^-16 of the sum of |terms|.  Also the wrapper's variant choice
(``kernel.variant``), which reads only shapes, dtypes and strides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_chunk.ops import ssd_pallas
from repro.kernels.ssd_chunk.ref import ssd_ref
from repro_torch.kernels.ssd_chunk import kernel as K
from repro_torch.kernels.ssd_chunk import ref

TOL = 1e-4


def inputs(seed, b, s, nh, hp, g, n, decay=0.1):
    """xd, log_a, B, C as numpy float32 (the reference test's draws)."""
    rng = np.random.default_rng(seed)
    xd = rng.normal(size=(b, s, nh, hp)).astype(np.float32) * 0.1
    la = -np.abs(rng.normal(size=(b, s, nh)).astype(np.float32)) * decay
    Bm = rng.normal(size=(b, s, g, n)).astype(np.float32)
    Cm = rng.normal(size=(b, s, g, n)).astype(np.float32)
    return xd, la, Bm, Cm


def err(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float32) -
                        np.asarray(want, np.float32)).max())


def tol_for(la, chunk, values) -> float:
    """TOL plus 8 float32 ulps of the largest |cumsum| over a chunk, of the
    largest |value| (at least 1)."""
    b, s, nh = la.shape
    cum = float(-la.reshape(b, s // chunk, chunk, nh).sum(axis=2).min())
    return (TOL + 8 * np.finfo(np.float32).eps * cum) * \
        max(1.0, float(np.abs(np.asarray(values)).max()))


@pytest.mark.parametrize("b,s,nh,hp,g,n,chunk", [
    (1, 500, 2, 16, 1, 8, 250),   # ragged chunks of 250 (S 1,000's pick)
    (1, 300, 4, 8, 2, 16, 150),   # two chunks of 150 (phase 20's gate)
    (1, 39, 4, 8, 2, 24, 13),     # a chunk of 13, n 24 != hp 8
    (2, 7, 2, 8, 1, 12, 1),       # a chunk of 1: the recurrence itself
    (1, 20, 3, 12, 1, 5, 20),     # the whole sequence one chunk, n 5
    (2, 64, 4, 16, 2, 8, 16),     # two groups
    (1, 48, 6, 8, 3, 16, 8),      # three groups, chunk < state
])
def test_passes_match_chunked_pallas_and_oracle(b, s, nh, hp, g, n, chunk):
    xd, la, Bm, Cm = inputs(b * s + n, b, s, nh, hp, g, n)
    t = [torch.from_numpy(a) for a in (xd, la, Bm, Cm)]
    y, h = ref.ssd_passes(*t, chunk)
    yc, hc = ref.ssd_chunked(*t, chunk)
    assert y.shape == (b, s, nh, hp) and h.shape == (b, nh, hp, n)
    assert err(y, yc) < TOL and err(h, hc) < TOL
    jin = [jnp.asarray(a) for a in (xd, la, Bm, Cm)]
    yp, hp_ = ssd_pallas(*jin, chunk, interpret=True)
    yr, hr = ssd_ref(*jin, chunk)
    assert err(y, yp) < TOL and err(h.transpose(-1, -2), hp_) < TOL
    assert err(y, yr) < TOL and err(h, hr) < TOL


def test_passes_with_underflowing_decay():
    """mamba2's strongest heads: log_a down to about -16 a step, so cum
    reaches about -3,000 over a chunk of 256 and exp(cum) is 0; every
    pass's exp is of one difference (or of the chunk's own cumsum), so
    nothing is 0/0 and every value is finite."""
    xd, la, Bm, Cm = inputs(1, 1, 512, 2, 8, 1, 16, decay=1.0)
    la = la * 16.0
    t = [torch.from_numpy(a) for a in (xd, la, Bm, Cm)]
    cum = ref.chunk_cumsum(t[1], 256)
    assert float(-cum.min()) > 3000
    S = ref.chunk_states(t[0], cum, t[2], 256)
    entering, h = ref.pass_states(S, cum, 256)
    y = ref.chunk_output(t[0], cum, t[2], t[3], entering, 256)
    for v in (S, entering, h, y):
        assert bool(torch.isfinite(v).all())
    yr, hr = ssd_ref(*(jnp.asarray(a) for a in (xd, la, Bm, Cm)), 256)
    assert err(y, yr) < tol_for(la, 256, yr)
    assert err(h, hr) < tol_for(la, 256, hr)


@pytest.mark.parametrize("chunk", (16, 13, 1))
def test_each_pass_against_its_definition(chunk):
    """Pass by pass against sums written out step by step: (a) the cumsum
    restarts at every chunk and S_c sums the chunk's inputs decayed to its
    end; (b) the state entering chunk c is the recurrence's state at the
    step before the chunk; (c) y is the recurrence's C_t H_t."""
    b, nh, hp, g, n = 1, 4, 6, 2, 5
    s = 156 - 156 % chunk
    xd, la, Bm, Cm = inputs(7 + chunk, b, s, nh, hp, g, n, decay=0.5)
    t = [torch.from_numpy(a) for a in (xd, la, Bm, Cm)]
    cum = ref.chunk_cumsum(t[1], chunk)
    want = np.zeros_like(la)
    for c0 in range(0, s, chunk):
        want[:, c0:c0 + chunk] = np.cumsum(la[:, c0:c0 + chunk], axis=1)
    assert err(cum, want) < TOL
    S = ref.chunk_states(t[0], cum, t[2], chunk)
    entering, h = ref.pass_states(S, cum, chunk)
    y = ref.chunk_output(t[0], cum, t[2], t[3], entering, chunk)
    rep = nh // g
    H = np.zeros((b, nh, hp, n))
    ys = np.zeros((b, s, nh, hp))
    for step in range(s):
        if step % chunk == 0:
            assert err(entering[:, step // chunk], H) < TOL
        a = np.exp(la[:, step])                          # (b, nh)
        Bh = np.repeat(Bm[:, step], rep, axis=1)         # (b, nh, n)
        Ch = np.repeat(Cm[:, step], rep, axis=1)
        H = H * a[:, :, None, None] + xd[:, step, :, :, None] * \
            Bh[:, :, None, :]
        ys[:, step] = np.einsum("bhpn,bhn->bhp", H, Ch)
        if step % chunk == chunk - 1:
            c = step // chunk
            own = S[:, c].double().numpy()
            # S_c is what the chunk adds to the state it was given
            Hin = entering[:, c].double().numpy()
            decay = np.exp(la[:, step - chunk + 1:step + 1].sum(axis=1))
            assert np.abs(H - Hin * decay[:, :, None, None] - own).max() \
                < TOL
    assert err(h, H) < TOL and err(y, ys) < TOL


def test_split_bf16_products_within_2_to_minus_16():
    """A float32 operand enters the tensor cores as hi = bf16(v), lo =
    bf16(v - hi), two bf16 x bf16 products summed in float32: within 2^-16
    of the sum of |terms| of the float32 product (hi + lo keeps 16
    significant bits), where hi alone misses it by up to 2^-9."""
    rng = np.random.default_rng(11)
    a = torch.from_numpy(rng.normal(size=(64, 256)).astype(np.float32)) \
        .to(torch.bfloat16)
    for scale in (1.0, 1e-3, 1e3):
        v = torch.from_numpy(rng.normal(size=(256, 64)).astype(np.float32)) \
            * scale
        hi, lo = ref.split_bf16(v)
        assert hi.dtype == lo.dtype == torch.bfloat16
        assert bool(((hi.float() + lo.float() - v).abs()
                     <= 2.0 ** -16 * v.abs()).all())
        want = a.double() @ v.double()
        bound = (a.double().abs() @ v.double().abs()) * 2.0 ** -16
        got = a.float() @ hi.float() + a.float() @ lo.float()
        assert bool(((got.double() - want).abs() <= bound).all())
        one = a.float() @ hi.float()
        assert float(((one.double() - want).abs() / bound).max()) > 4


def test_variant_reads_dtype_widths_and_strides():
    """``kernel.variant`` on CPU tensors (it reads no data): bfloat16 at
    widths that are multiples of 16 with 16-byte strides and bases goes to
    the tensor-core kernel, the model's strided B and C slices included;
    float32, odd widths and unaligned operands to the CUDA-core kernel."""
    bf, b, s = torch.bfloat16, 1, 8
    xd = torch.zeros((b, s, 4, 64), dtype=bf)
    Bm = torch.zeros((b, s, 1, 128), dtype=bf)
    assert K.variant(xd, Bm, Bm) == "tc"
    assert K.variant(xd.float(), Bm.float(), Bm.float()) == "fma"
    assert K.variant(torch.zeros((b, s, 4, 24), dtype=bf), Bm, Bm) == "fma"
    odd = torch.zeros((b, s, 1, 40), dtype=bf)
    assert K.variant(xd, odd, odd) == "fma"
    # the model's slices of the convolution's output (d_in 256, g n 128)
    xbc = torch.zeros((b, s, 256 + 2 * 128), dtype=bf)
    _, Bs, Cs = torch.split(xbc, [256, 128, 128], dim=-1)
    Bs, Cs = Bs.reshape(b, s, 1, 128), Cs.reshape(b, s, 1, 128)
    assert not Bs.is_contiguous() and K.variant(xd, Bs, Cs) == "tc"
    # a base 6 bytes in, and a row stride of 520 bytes
    xbc = torch.zeros((b, s, 3 + 2 * 128), dtype=bf)
    Bo = xbc[..., 3:131].reshape(b, s, 1, 128)
    assert K.variant(xd, Bo, Bm) == "fma"
    xbc = torch.zeros((b, s, 260), dtype=bf)
    Br = xbc[..., :128].reshape(b, s, 1, 128)
    assert K.variant(xd, Br, Bm) == "fma"
