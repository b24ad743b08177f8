"""The port's Mamba-2 SSD mixer (``repro_torch.models.ssm``) and the
mamba2-780m model path against ``repro``'s.

Weights are the reference's ``init_params`` pytree of reduced mamba2-780m
(also with a state size of 24 and two groups, so that n != hp and heads
share groups), with ``A_log`` redrawn as log U[1, 16] (the config's span
of decays), ``dt_bias``, ``D``, the conv bias and every norm scale redrawn
from a numpy seed (the reference initialises them to constants), carried
across with ``load_jax_params``.  Inputs are numpy arrays from a seed.
The port's prefill runs the SSD chunk kernel's wrapper (its plain version
on CPU tensors) where the reference runs ``ssd_chunked``; prompt lengths
give chunks of 16, 13, 10, 2 and 1 (``_pick_chunk``).  Tolerance: float32
within 1e-4 absolute (sums in another order).  The kernel's prefill is also
held against the port's own token-by-token decode (the recurrence) from
empty caches.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from repro_torch.parallel.sharding import single_device_ctx as tctx

TOL = 1e-4
#: the reduced config as it is (n 16 == hp 16), and n 24 != hp 16 in 2 groups
SSM_KW = [{}, {"d_state": 24, "n_groups": 2}]


def cfgs(**ssm_kw):
    j = jconfigs.reduced(jconfigs.get("mamba2-780m"))
    t = tconfigs.reduced(tconfigs.get("mamba2-780m"))
    return (dataclasses.replace(j, ssm=dataclasses.replace(j.ssm, **ssm_kw)),
            dataclasses.replace(t, ssm=dataclasses.replace(t.ssm, **ssm_kw)))


def redraw(tree, rng):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k == "A_log":
                v = np.log(rng.uniform(1.0, 16.0, size=np.shape(v)))
            elif k in ("scale", "norm_scale", "D"):
                v = rng.normal(1.0, 0.3, size=np.shape(v))
            elif k in ("dt_bias", "conv_b"):
                v = rng.normal(0.0, 0.5, size=np.shape(v))
            else:
                out[k] = redraw(v, rng)
                continue
            out[k] = np.asarray(v, np.float32)
        return out
    if isinstance(tree, (tuple, list)):
        return type(tree)(redraw(v, rng) for v in tree)
    return tree


def carried(seed=0, **ssm_kw):
    """(jax cfg, port cfg, jax params, port model) with the same weights."""
    jcfg, tcfg = cfgs(**ssm_kw)
    params_np = jax.tree.map(np.asarray,
                             JT.init_params(jax.random.PRNGKey(seed), jcfg))
    params_np = redraw(params_np, np.random.default_rng(seed))
    return jcfg, tcfg, jax.tree.map(jnp.asarray, params_np), \
        TT.load_jax_params(tcfg, params_np, "cpu")


def mixers(jp, model):
    """Layer 0's SSD parameters in both packages."""
    return (jax.tree.map(lambda a: a[0], jp["periods"][0]["mixer"]),
            model.layers[0]["mixer"])


def diff(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float32)
                        - np.asarray(want, np.float32)).max())


def test_init_matches_reference_layout():
    """The port's ``init`` draws the reference's shapes, with its constants
    and its A_log span (linspace rounds apart by an ulp)."""
    jcfg, tcfg = cfgs()
    want = jax.tree.map(np.asarray, JS.init(jax.random.PRNGKey(0), jcfg))
    got = TS.init(torch.Generator().manual_seed(0), tcfg)
    assert {k: v.shape for k, v in want.items()} == \
        {k: tuple(v.shape) for k, v in got.items()}
    for k in ("conv_b", "dt_bias", "D", "norm_scale"):
        assert np.array_equal(got[k].numpy(), want[k]), k
    assert np.allclose(got["A_log"].numpy(), want["A_log"], rtol=1e-6)
    for k in ("in_proj", "conv_w", "out_proj"):
        assert abs(float(got[k].std()) / float(want[k].std()) - 1) < 0.1, k


@pytest.mark.parametrize("ssm_kw", SSM_KW, ids=["n16", "n24g2"])
@pytest.mark.parametrize("seq", [16, 48, 13, 40, 17, 2])
def test_apply_full_matches_reference(seq, ssm_kw):
    jcfg, tcfg, jp, model = carried(seed=seq, **ssm_kw)
    jmix, tmix = mixers(jp, model)
    x = np.random.default_rng(seq).normal(
        size=(2, seq, jcfg.d_model)).astype(np.float32)
    want, wc = JS.apply_full(jmix, jnp.asarray(x), jcfg)
    got, tc = TS.apply_full(tmix, torch.from_numpy(x), tcfg)
    assert got.shape == want.shape and diff(got, want) < TOL
    assert tc.h.shape == wc.h.shape and tc.h.dtype == torch.float32
    assert diff(tc.conv, wc.conv) < TOL and diff(tc.h, wc.h) < TOL


@pytest.mark.parametrize("seq", [2, 13])
def test_tail_conv_inputs_match_reference(seq):
    """Prompts shorter than d_conv - 1 are left-padded with zeros."""
    jcfg, tcfg, jp, model = carried(seed=1)
    jmix, tmix = mixers(jp, model)
    x = np.random.default_rng(seq).normal(
        size=(3, seq, jcfg.d_model)).astype(np.float32)
    want = JS._tail_conv_inputs(jcfg, jnp.asarray(x), jmix)
    got = TS._tail_conv_inputs(tcfg, torch.from_numpy(x), tmix)
    assert got.shape == want.shape == (3, jcfg.ssm.d_conv - 1,
                                       TS.dims(tcfg)[2])
    assert diff(got, want) < TOL


@pytest.mark.parametrize("ssm_kw", SSM_KW, ids=["n16", "n24g2"])
def test_apply_decode_matches_reference(ssm_kw):
    jcfg, tcfg, jp, model = carried(seed=2, **ssm_kw)
    jmix, tmix = mixers(jp, model)
    rng = np.random.default_rng(3)
    cache = TS.init_cache(tcfg, 3, torch.float32, "cpu")
    conv = rng.normal(size=cache.conv.shape).astype(np.float32)
    h = rng.normal(size=cache.h.shape).astype(np.float32)
    cache.conv.copy_(torch.from_numpy(conv))
    cache.h.copy_(torch.from_numpy(h))
    jc = JS.SSMCache(jnp.asarray(conv), jnp.asarray(h))
    for step in range(3):
        x = rng.normal(size=(3, 1, jcfg.d_model)).astype(np.float32)
        want, jc = JS.apply_decode(jmix, jnp.asarray(x), jc, jcfg)
        got, tc = TS.apply_decode(tmix, torch.from_numpy(x), cache, tcfg)
        assert tc is cache                     # written in place
        assert diff(got, want) < TOL
        assert diff(tc.conv, jc.conv) < TOL and diff(tc.h, jc.h) < TOL


@pytest.mark.parametrize("ssm_kw", SSM_KW, ids=["n16", "n24g2"])
def test_prefill_equals_token_by_token_decode(ssm_kw):
    """The port's prefill (the SSD chunk kernel's wrapper, 4 chunks of 10)
    against its own decode (the O(1) recurrence) fed the same tokens one
    at a time from empty caches: last logits and every layer's conv
    window and state."""
    _, tcfg, _, model = carried(seed=4, **ssm_kw)
    pctx = tctx(attn_impl="flash")
    tok = torch.from_numpy(np.random.default_rng(5).integers(
        0, tcfg.vocab_size, size=(2, 40))).long()
    want, wc = TT.prefill(model, tok, tcfg, pctx)
    caches = TT.init_caches(tcfg, 2, 64, torch.float32, "cpu")
    for i in range(tok.shape[1]):
        got, caches = TT.decode_step(model, tok[:, i:i + 1], caches,
                                     torch.tensor(i), tcfg, pctx)
    assert diff(got, want) < TOL
    for c, w in zip(caches, wc):
        assert diff(c.conv, w.conv) < TOL and diff(c.h, w.h) < TOL
