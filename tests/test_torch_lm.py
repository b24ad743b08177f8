"""The port's LM stack (``repro_torch.configs``, ``models.layers``,
``models.attention``, ``models.transformer``) against ``repro``'s.

Weights are the reference's ``init_params`` pytree, with every norm scale,
qk-norm scale and QKV bias, and an SSD layer's ``A_log``, ``dt_bias``,
``D``, conv bias and gated-norm scale, redrawn from a numpy seed (the
reference initialises them to constants, which would hide a missing term),
carried across with ``load_jax_params``.  Inputs are numpy arrays from a
seed.  The reference runs attention as ``"full"`` (exact softmax); the
port runs ``"flash"`` (the flash kernel's plain version on CPU tensors),
``"full"`` and ``"chunked"``; mamba2-780m's SSD prefill runs the SSD
chunk kernel's plain version where the reference runs ``ssd_chunked``.
Tolerance: float32 logits, activations and
caches within 1e-4 absolute (matmuls and softmax sum in another order;
reduced-config logits are O(10)).  recurrentgemma-9b's RG-LRU layers scan
with ``rglru.linear_scan`` where the reference runs ``associative_scan``
(another association: a few float32 ulps of |h|, inside the same 1e-4);
the MoE archs' reduced configs have a capacity factor of 4, so no expert
drops an assignment and the unstable dispatch sort's order of ties does
not show in the outputs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.parallel.sharding import single_device_ctx as jctx
from repro_torch import configs as tconfigs
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.parallel.sharding import single_device_ctx as tctx

TOL = 1e-4
DENSE = ["qwen3-0.6b", "granite-8b", "qwen1.5-32b", "phi4-mini-3.8b",
         "chameleon-34b", "musicgen-medium"]
SERVED = DENSE + ["mamba2-780m", "recurrentgemma-9b", "qwen3-moe-30b-a3b",
                  "qwen3-moe-235b-a22b"]
JPCTX = jctx(remat=False, attn_impl="full")
IMPLS = ["flash", "full", "chunked"]
REDRAWN = ("scale", "q_scale", "k_scale", "bq", "bk", "bv", "A_log",
           "dt_bias", "D", "conv_b", "norm_scale", "a_param")


def cfgs(arch, **kw):
    """The reference's and the port's reduced config of ``arch``."""
    j = dataclasses.replace(jconfigs.reduced(jconfigs.get(arch)), **kw)
    t = dataclasses.replace(tconfigs.reduced(tconfigs.get(arch)), **kw)
    return j, t


def redraw(tree, rng):
    """The numpy pytree with norm scales and biases redrawn."""
    if isinstance(tree, dict):
        return {k: (rng.normal(1.0 if "scale" in k else 0.0, 0.3,
                               size=np.shape(v)).astype(np.float32)
                    if k in REDRAWN else redraw(v, rng))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(redraw(v, rng) for v in tree)
    return tree


def carried(arch, seed=0, **kw):
    """(jax cfg, port cfg, jax params, port model) with the same weights."""
    jcfg, tcfg = cfgs(arch, **kw)
    params_np = jax.tree.map(np.asarray,
                             JT.init_params(jax.random.PRNGKey(seed), jcfg))
    params_np = redraw(params_np, np.random.default_rng(seed))
    jparams = jax.tree.map(jnp.asarray, params_np)
    return jcfg, tcfg, jparams, TT.load_jax_params(tcfg, params_np, "cpu")


def jax_layer_caches(caches, cfg):
    """The reference's {"periods", "tail"} caches as one tuple of arrays
    per layer: (k, v) or (conv, h), SSD or RG-LRU."""
    out = []
    for i in range(cfg.n_full_periods):
        for j in range(cfg.period):
            out.append(tuple(np.asarray(f[i]) for f in caches["periods"][j]))
    out.extend(tuple(np.asarray(f) for f in c) for c in caches["tail"])
    return out


def carried_count(cfg) -> int:
    """The parameters a model carries: the config's analytic count, which
    leaves out each SSD layer's conv bias and dt bias and each RG-LRU
    layer's conv bias and ``a_param`` (2 w), plus those."""
    total = cfg.param_count()
    for li in range(cfg.n_layers):
        mixer = cfg.plan[li % cfg.period][0]
        if mixer == "ssd":
            s = cfg.ssm
            d_in = s.expand * cfg.d_model
            total += d_in + 2 * s.n_groups * s.d_state + d_in // s.head_dim
        elif mixer == "rglru":
            total += 2 * (cfg.rnn_width or cfg.d_model)
    return total


def diff(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float32)
                        - np.asarray(want, np.float32)).max())


def tokens_for(cfg, rng, b, s):
    shape = (b, s, cfg.n_codebooks) if cfg.n_codebooks else (b, s)
    return rng.integers(0, cfg.vocab_size, size=shape).astype(np.int32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(jconfigs.ARCHS))
def test_configs_equal_reference(arch):
    j, t = jconfigs.get(arch), tconfigs.get(arch)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.param_count() == t.param_count()
    assert dataclasses.asdict(jconfigs.reduced(j)) == \
        dataclasses.asdict(tconfigs.reduced(t))
    assert tconfigs.get("qwen3-0.6b").param_count() == 596_049_920


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    scale = rng.normal(1.0, 0.3, size=32).astype(np.float32)
    got = TL.rmsnorm({"scale": torch.from_numpy(scale)},
                     torch.from_numpy(x), 1e-6)
    assert diff(got, JL.rmsnorm({"scale": scale}, jnp.asarray(x),
                                1e-6)) < TOL

    xr = rng.normal(size=(2, 3, 5, 16)).astype(np.float32)
    for pos in (np.arange(5), np.array([3, 70, 1_000])[:, None, None][:2]):
        pos = pos.astype(np.int32)
        want = JL.apply_rope(jnp.asarray(xr[:, :, :pos.shape[-1]]),
                             jnp.asarray(pos), 1e6)
        got = TL.apply_rope(torch.from_numpy(xr[:, :, :pos.shape[-1]]),
                            torch.from_numpy(pos), 1e6)
        assert diff(got, want) < TOL

    w = {k: rng.normal(size=s).astype(np.float32) * 0.2 for k, s in
         (("w_gate", (32, 48)), ("w_in", (32, 48)), ("w_out", (48, 32)))}
    for act in ("silu", "gelu"):
        want = JL.mlp_apply(w, jnp.asarray(x), act=act)
        got = TL.mlp_apply({k: torch.from_numpy(v) for k, v in w.items()},
                           torch.from_numpy(x), act=act)
        assert diff(got, want) < TOL


@pytest.mark.parametrize("arch,tie,softcap", [
    ("qwen3-0.6b", True, None), ("granite-8b", False, None),
    ("granite-8b", False, 30.0), ("musicgen-medium", False, None),
    ("musicgen-medium", True, 15.0)])
def test_embed_and_head_match_reference(arch, tie, softcap):
    jcfg, tcfg = cfgs(arch, tie_embeddings=tie, logit_softcap=softcap)
    key = jax.random.PRNGKey(1)
    emb = jax.tree.map(np.array, JL.embed_init(
        key, jcfg.vocab_size, jcfg.d_model, jcfg.n_codebooks))
    head = jax.tree.map(np.array, JL.head_init(key, jcfg))
    temb = {k: torch.from_numpy(v) for k, v in emb.items()}
    thead = {k: torch.from_numpy(v) for k, v in head.items()}
    rng = np.random.default_rng(2)
    tok = tokens_for(jcfg, rng, 2, 6)
    want = JL.embed_apply(emb, jnp.asarray(tok), jcfg)
    got = TL.embed_apply(temb, torch.from_numpy(tok).long(), tcfg)
    assert diff(got, want) < TOL
    x = rng.normal(size=(2, 3, jcfg.d_model)).astype(np.float32)
    want = JL.head_apply(head, emb, jnp.asarray(x), jcfg)
    got = TL.head_apply(thead, temb, torch.from_numpy(x), tcfg)
    assert got.shape == want.shape and diff(got, want) < TOL


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen1.5-32b"])
def test_apply_full_matches_reference(arch, impl):
    jcfg, tcfg, jp, model = carried(arch, seed=3)
    p = jp["periods"][0]["mixer"]
    jmix = jax.tree.map(lambda a: a[0], p)
    tmix = model.layers[0]["mixer"]
    x = np.random.default_rng(4).normal(
        size=(2, 24, jcfg.d_model)).astype(np.float32)
    want, wc = JA.apply_full(jmix, jnp.asarray(x), jcfg, JPCTX)
    got, tc = TA.apply_full(tmix, torch.from_numpy(x), tcfg,
                            tctx(attn_impl=impl))
    assert diff(got, want) < TOL
    assert diff(tc.k, wc.k) < TOL and diff(tc.v, wc.v) < TOL


def test_apply_full_local_window_matches_reference():
    jcfg, tcfg, jp, model = carried("qwen3-0.6b", seed=5, attn_window=16)
    jmix = jax.tree.map(lambda a: a[0], jp["periods"][0]["mixer"])
    x = np.random.default_rng(6).normal(
        size=(1, 64, jcfg.d_model)).astype(np.float32)
    want, _ = JA.apply_full(jmix, jnp.asarray(x), jcfg, JPCTX, local=True)
    got, _ = TA.apply_full(model.layers[0]["mixer"], torch.from_numpy(x),
                           tcfg, tctx(attn_impl="flash"), local=True)
    assert diff(got, want) < TOL


@pytest.mark.parametrize("local", [False, True])
def test_apply_decode_vector_positions_match_reference(local):
    jcfg, tcfg, jp, model = carried("qwen3-0.6b", seed=7, attn_window=8)
    jmix = jax.tree.map(lambda a: a[0], jp["periods"][0]["mixer"])
    rng = np.random.default_rng(8)
    B, S = 3, 32
    shape = (B, jcfg.n_kv_heads, S, jcfg.hd)
    k0, v0 = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    x = rng.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
    pos = np.array([5, 0, 17], np.int32)
    want, wc = JA.apply_decode(jmix, jnp.asarray(x),
                               JA.KVCache(jnp.asarray(k0), jnp.asarray(v0)),
                               jnp.asarray(pos), jcfg, JPCTX, local=local)
    cache = TA.KVCache(torch.from_numpy(k0.copy()),
                       torch.from_numpy(v0.copy()))
    got, tc = TA.apply_decode(model.layers[0]["mixer"], torch.from_numpy(x),
                              cache, torch.from_numpy(pos), tcfg,
                              tctx(attn_impl="flash"), local=local)
    assert tc is cache                      # written in place
    assert diff(got, want) < TOL
    assert diff(tc.k, wc.k) < TOL and diff(tc.v, wc.v) < TOL


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", SERVED)
def test_param_count_equals_carried_tensors(arch):
    _, tcfg, _, model = carried(arch)
    total = sum(p.numel() for p in model.parameters())
    assert total == carried_count(tcfg)
    fresh = TT.init_params(torch.Generator().manual_seed(0), tcfg)
    assert sum(p.numel() for p in fresh.parameters()) == total
    assert {n: p.shape for n, p in fresh.named_parameters()} == \
        {n: p.shape for n, p in model.named_parameters()}


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", SERVED)
def test_prefill_matches_reference(arch, impl):
    jcfg, tcfg, jp, model = carried(arch, seed=9)
    tok = tokens_for(jcfg, np.random.default_rng(10), 2, 12)
    want, wc = JT.prefill(jp, jnp.asarray(tok), jcfg, JPCTX)
    got, tc = TT.prefill(model, torch.from_numpy(tok).long(), tcfg,
                         tctx(attn_impl=impl))
    assert got.shape == want.shape and diff(got, want) < TOL
    wl = jax_layer_caches(wc, jcfg)
    assert len(tc) == len(wl) == tcfg.n_layers
    for c, w in zip(tc, wl):
        assert len(c) == len(w)
        assert all(diff(f, wf) < TOL for f, wf in zip(c, w))


@pytest.mark.parametrize("arch", SERVED)
def test_decode_steps_match_reference(arch):
    jcfg, tcfg, jp, model = carried(arch, seed=11)
    rng = np.random.default_rng(12)
    B, S = 2, 16
    jc = JT.init_caches(jcfg, B, S, jnp.float32)
    tc = TT.init_caches(tcfg, B, S, torch.float32, "cpu")
    pctx = tctx(attn_impl="flash")
    for pos in (0, 1, 2, np.array([3, 7], np.int32),
                np.array([4, 15], np.int32)):
        tok = tokens_for(jcfg, rng, B, 1)
        want, jc = JT.decode_step(jp, jnp.asarray(tok), jc,
                                  jnp.asarray(pos), jcfg, JPCTX)
        got, tc = TT.decode_step(model, torch.from_numpy(tok).long(), tc,
                                 torch.as_tensor(pos), tcfg, pctx)
        assert got.shape == want.shape and diff(got, want) < TOL
    for c, w in zip(tc, jax_layer_caches(jc, jcfg)):
        assert all(diff(f, wf) < TOL for f, wf in zip(c, w))


def test_flash_prefill_serves_any_length():
    """A 200-token prompt -- past 128 tokens and not a multiple of 128,
    which the reference's accelerator path refuses -- prefills through
    "flash" (the kernels' wrapper, which tiles and masks by itself) as
    through "full", "chunked" and the reference, caches included."""
    jcfg, tcfg, jp, model = carried("qwen3-0.6b")
    tok = tokens_for(tcfg, np.random.default_rng(0), 1, 200)
    want, _ = JT.prefill(jp, jnp.asarray(tok), jcfg, JPCTX)
    tok = torch.from_numpy(tok).long()
    flash, fc = TT.prefill(model, tok, tcfg, tctx(attn_impl="flash"))
    full, uc = TT.prefill(model, tok, tcfg, tctx(attn_impl="full"))
    chunked, _ = TT.prefill(model, tok, tcfg, tctx(attn_impl="chunked"))
    assert flash.shape == full.shape == want.shape
    assert diff(flash, full) < TOL and diff(chunked, full) < TOL
    assert diff(flash, want) < TOL
    for c, u in zip(fc, uc):
        assert all(diff(f, w) < TOL for f, w in zip(c, u))


@pytest.mark.parametrize("where", ["mixer", "mlp"])
def test_unknown_mixer_or_mlp_raises(where):
    """Every config's sub-layers are ported; a name in neither
    ``MIXERS`` nor ``MLPS`` raises from ``layer_plan``, and so from
    ``init_params``, ``load_jax_params`` and ``init_caches``."""
    assert set(TT.MIXERS) == set(tconfigs.base.MIXERS)
    assert set(TT.MLPS) == set(tconfigs.base.MLPS)
    for arch in tconfigs.ARCHS:
        TT.layer_plan(tconfigs.get(arch))
    _, tcfg = cfgs("qwen3-0.6b")
    plan = (("mamba3", "swiglu"),) if where == "mixer" else \
        (("attn", "kan"),)
    bad = dataclasses.replace(tcfg, plan=plan)
    name = plan[0][0] if where == "mixer" else plan[0][1]
    with pytest.raises(NotImplementedError, match=name):
        TT.init_params(torch.Generator().manual_seed(0), bad)
    with pytest.raises(NotImplementedError, match=name):
        TT.load_jax_params(bad, {}, "cpu")
    with pytest.raises(NotImplementedError, match=name):
        TT.init_caches(bad, 1, 8, torch.float32, "cpu")
