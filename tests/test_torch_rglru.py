"""The port's RG-LRU block (``repro_torch.models.rglru``) against
``repro``'s.

Weights are the reference's ``init`` of reduced recurrentgemma-9b's mixer
(also with an RNN width of 96 beside d_model 64, so that a transposed
projection cannot pass), with ``conv_b`` and ``a_param`` redrawn from a
numpy seed (the reference initialises the first to zeros and the second to
one span of decays), handed to both packages as the same numpy arrays.
Inputs are numpy arrays from a seed.

The port's prefill scans with ``linear_scan`` (Hillis-Steele doubling)
where the reference runs ``jax.lax.associative_scan``: the same combine in
another association.  Each h_t is a sum of products of at most S decays,
so the two differ by a few float32 ulps of |h| (|h| is O(1) here); the
tolerance is the LM tests' 1e-4 absolute, which also covers the matmuls
and the gates summed in another order.  The scan is also held against the
sequential recurrence (5e-6 relative), and prefill against token-by-token
decode from an empty cache.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import rglru as JR
from repro_torch import configs as tconfigs
from repro_torch.models import rglru as TR

TOL = 1e-4
#: the reduced config as it is (w = d = 64), and w 96 != d 64
WIDTHS = [None, 96]


def cfgs(rnn_width=None):
    j = jconfigs.reduced(jconfigs.get("recurrentgemma-9b"))
    t = tconfigs.reduced(tconfigs.get("recurrentgemma-9b"))
    if rnn_width is not None:
        j = dataclasses.replace(j, rnn_width=rnn_width)
        t = dataclasses.replace(t, rnn_width=rnn_width)
    return j, t


def params(seed, rnn_width=None):
    """(jax cfg, port cfg, jax params, port params): one weight set."""
    jcfg, tcfg = cfgs(rnn_width)
    p = jax.tree.map(np.asarray, JR.init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    w = p["conv_b"].shape[0]
    p["conv_b"] = rng.normal(0.0, 0.5, size=w).astype(np.float32)
    # decays from fast to slow: softplus^-1 of U[0.05, 2]
    p["a_param"] = np.log(np.expm1(rng.uniform(0.05, 2.0, size=w))) \
        .astype(np.float32)
    return (jcfg, tcfg, {k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v.copy()) for k, v in p.items()})


def diff(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float32)
                        - np.asarray(want, np.float32)).max())


def inputs(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_init_matches_reference_layout():
    """The port's ``init`` draws the reference's names and shapes, its
    constants and its span of decays (linspace rounds apart by an ulp)."""
    for rnn_width in WIDTHS:
        jcfg, tcfg = cfgs(rnn_width)
        want = jax.tree.map(np.asarray, JR.init(jax.random.PRNGKey(0), jcfg))
        got = TR.init(torch.Generator().manual_seed(0), tcfg)
        assert list(got) == ["w_gate_in", "w_rnn_in", "conv_w", "conv_b",
                             "gate_a", "gate_x", "a_param", "w_rnn_out"]
        assert {k: v.shape for k, v in want.items()} == \
            {k: tuple(v.shape) for k, v in got.items()}
        assert all(v.dtype == torch.float32 for v in got.values())
        assert np.array_equal(got["conv_b"].numpy(), want["conv_b"])
        assert np.allclose(got["a_param"].numpy(), want["a_param"],
                           rtol=1e-5, atol=1e-6)
        for k in ("w_gate_in", "w_rnn_in", "conv_w", "gate_a", "gate_x",
                  "w_rnn_out"):
            assert abs(float(got[k].std()) / float(want[k].std()) - 1) \
                < 0.15, k


@pytest.mark.parametrize("rnn_width", WIDTHS, ids=["w64", "w96"])
def test_block_gate_and_gates_match_reference(rnn_width):
    _, _, jp, tp = params(1, rnn_width)
    w = jp["conv_b"].shape[0]
    xr = inputs(2, 3, 5, w)
    for g in ("gate_a", "gate_x"):
        want = JR._block_gate(jp[g], jnp.asarray(xr))
        got = TR._block_gate(tp[g], torch.from_numpy(xr))
        assert got.dtype == torch.float32 and diff(got, want) < TOL
    wa, wb = JR._gates(jp, jnp.asarray(xr))
    ga, gb = TR._gates(tp, torch.from_numpy(xr))
    assert ga.dtype == gb.dtype == torch.float32
    assert diff(ga, wa) < TOL and diff(gb, wb) < TOL
    # the decays span fast to slow
    assert float(ga.min()) < 0.1 and float(ga.max()) > 0.9


@pytest.mark.parametrize("rnn_width", WIDTHS, ids=["w64", "w96"])
@pytest.mark.parametrize("seq", [1, 2, 3, 13, 48])
def test_apply_full_matches_reference(seq, rnn_width):
    """y and the cache: the conv tail (left-padded with zeros under 3
    tokens) and the last state."""
    jcfg, tcfg, jp, tp = params(seq, rnn_width)
    x = inputs(seq, 2, seq, jcfg.d_model)
    want, wc = JR.apply_full(jp, jnp.asarray(x), jcfg)
    got, tc = TR.apply_full(tp, torch.from_numpy(x), tcfg)
    assert got.shape == want.shape and diff(got, want) < TOL
    assert tc.conv.shape == wc.conv.shape == (2, TR.D_CONV - 1,
                                              TR.width(tcfg))
    assert tc.h.shape == wc.h.shape and tc.h.dtype == torch.float32
    assert diff(tc.conv, wc.conv) < TOL and diff(tc.h, wc.h) < TOL
    if seq < TR.D_CONV - 1:
        assert not bool(tc.conv[:, :TR.D_CONV - 1 - seq].any())


@pytest.mark.parametrize("rnn_width", WIDTHS, ids=["w64", "w96"])
def test_apply_decode_matches_reference(rnn_width):
    jcfg, tcfg, jp, tp = params(3, rnn_width)
    rng = np.random.default_rng(4)
    cache = TR.init_cache(tcfg, 3, torch.float32, "cpu")
    conv = rng.normal(size=cache.conv.shape).astype(np.float32)
    h = rng.normal(size=cache.h.shape).astype(np.float32)
    cache.conv.copy_(torch.from_numpy(conv))
    cache.h.copy_(torch.from_numpy(h))
    jc = JR.RGLRUCache(jnp.asarray(conv), jnp.asarray(h))
    for _ in range(3):
        x = rng.normal(size=(3, 1, jcfg.d_model)).astype(np.float32)
        want, jc = JR.apply_decode(jp, jnp.asarray(x), jc, jcfg)
        got, tc = TR.apply_decode(tp, torch.from_numpy(x), cache, tcfg)
        assert tc is cache                     # written in place
        assert got.shape == want.shape and diff(got, want) < TOL
        assert diff(tc.conv, jc.conv) < TOL and diff(tc.h, jc.h) < TOL


def test_init_cache_matches_reference():
    jcfg, tcfg = cfgs(96)
    want = JR.init_cache(jcfg, 3, jnp.bfloat16)
    got = TR.init_cache(tcfg, 3, torch.bfloat16, "cpu")
    assert tuple(got.conv.shape) == want.conv.shape
    assert tuple(got.h.shape) == want.h.shape
    assert got.conv.dtype == torch.bfloat16 and got.h.dtype == torch.float32
    assert not bool(got.conv.any()) and not bool(got.h.any())


@pytest.mark.parametrize("seq", [1, 5, 33])
def test_prefill_equals_token_by_token_decode(seq):
    """The scan's prefill against the port's own recurrence, one token at
    a time from an empty cache: y at every position and the cache."""
    _, tcfg, _, tp = params(5, 96)
    x = torch.from_numpy(inputs(6, 2, seq, tcfg.d_model))
    want, wc = TR.apply_full(tp, x, tcfg)
    cache = TR.init_cache(tcfg, 2, torch.float32, "cpu")
    ys = [TR.apply_decode(tp, x[:, i:i + 1], cache, tcfg)[0]
          for i in range(seq)]
    assert diff(torch.cat(ys, dim=1), want) < TOL
    assert diff(cache.conv, wc.conv) < TOL and diff(cache.h, wc.h) < TOL


@pytest.mark.parametrize("seq", [1, 2, 3, 7, 64, 100, 257])
def test_linear_scan_equals_sequential_recurrence(seq):
    """Every h_t of the doubling scan against h_t = a_t h_{t-1} + b_t in
    float64, within 5e-6 of max |h|; decays in (0, 1) as the gates make
    them, some near 1 (long memory), some near 0."""
    rng = np.random.default_rng(seq)
    a = rng.uniform(0.0, 1.0, size=(2, seq, 6)) ** 0.05
    a[:, :, 0] = rng.uniform(0.0, 0.05, size=(2, seq))
    b = rng.normal(size=(2, seq, 6))
    got = TR.linear_scan(torch.from_numpy(a.astype(np.float32)),
                         torch.from_numpy(b.astype(np.float32)))
    h = np.zeros((2, 6))
    want = np.empty_like(b)
    for t in range(seq):
        h = a[:, t] * h + b[:, t]
        want[:, t] = h
    assert got.shape == (2, seq, 6) and got.dtype == torch.float32
    assert diff(got, want) <= 5e-6 * max(1.0, float(np.abs(want).max()))
