"""The port's serving path (``repro_torch.serve``, ``repro_torch.launch.
serve``) against ``repro``'s.

The port's ``Engine`` and the reference's serve the same requests (the
prompt lengths of ``tests/test_serve.py``, prompts from a numpy seed) on
reduced qwen3-0.6b, mamba2-780m, recurrentgemma-9b and qwen3-moe-30b-a3b
with the reference's weights carried across (the MoE config's capacity
factor of 4 drops no assignment, at prefill or at decode): the same
requests finish in the same order with the same greedy tokens (float32
logits agree within 1e-4, far inside these logits' top-2 gaps).  The
reference serves with ``"full"`` attention; the port with ``"flash"`` (the
flash kernel's plain version on CPU tensors) and ``"full"``.
``insert_slot`` writes the same KV, SSM and RG-LRU caches as the
reference's (exactly: it copies).  Sampling draws from a
``torch.Generator``, so only greedy and top-k=1 are compared by value.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.parallel.sharding import single_device_ctx as jctx
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve.cache import insert_slot as jinsert
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer as TT
from repro_torch.parallel.sharding import single_device_ctx as tctx
from repro_torch.serve import Engine, Request
from repro_torch.serve.cache import insert_slot
from repro_torch.serve.sampling import sample_logits

LENGTHS = [4, 9, 13, 7, 5]


def carried(arch="qwen3-0.6b", seed=0):
    jcfg = jconfigs.reduced(jconfigs.get(arch))
    tcfg = tconfigs.reduced(tconfigs.get(arch))
    jp = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    model = TT.load_jax_params(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, model


def prompts(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)
            for n in LENGTHS]


def served(done):
    return [(d.rid, [int(t) for t in d.out_tokens]) for d in done]


@pytest.mark.parametrize("impl", ["flash", "full"])
def test_engine_matches_reference(impl):
    jcfg, tcfg, jp, model = carried()
    jeng = JEngine(jcfg, jp, jctx(remat=False, attn_impl="full"),
                   max_batch=3, max_len=48)
    eng = Engine(tcfg, model, tctx(attn_impl=impl),
                 max_batch=3, max_len=48, device="cpu")
    for r, p in enumerate(prompts(jcfg)):
        jeng.add_request(JRequest(rid=r, prompt=p, max_new_tokens=4 + r))
        eng.add_request(Request(rid=r, prompt=p, max_new_tokens=4 + r))
    want, got = served(jeng.run_to_completion()), \
        served(eng.run_to_completion())
    assert len(got) == 5
    assert sorted(len(t) for _, t in got) == [4, 5, 6, 7, 8]
    assert got == want


def test_flash_engine_serves_any_length():
    """A 200-token prompt (past 128 tokens, not a multiple of 128) through
    an engine on "flash": its first logits equal "full"'s within 1e-4, and
    its requests are served as the reference's engine serves them."""
    jcfg, tcfg, jp, model = carried()
    rng = np.random.default_rng(3)
    ps = [rng.integers(0, jcfg.vocab_size, size=(n,)).astype(np.int32)
          for n in (200, 9)]
    jeng = JEngine(jcfg, jp, jctx(remat=False, attn_impl="full"),
                   max_batch=2, max_len=224)
    for r, p in enumerate(ps):
        jeng.add_request(JRequest(rid=r, prompt=p, max_new_tokens=6))
    want = served(jeng.run_to_completion())
    firsts = {}
    for impl in ("flash", "full"):
        eng = Engine(tcfg, model, tctx(attn_impl=impl), max_batch=2,
                     max_len=224, device="cpu")
        seen = []
        inner = eng._prefill

        def keep(*args, inner=inner, seen=seen):
            out = inner(*args)
            seen.append(out[0][0, 0].clone())
            return out
        eng._prefill = keep
        for r, p in enumerate(ps):
            eng.add_request(Request(rid=r, prompt=p, max_new_tokens=6))
        got = served(eng.run_to_completion())
        assert got == want, impl
        firsts[impl] = seen
    assert [len(f) for f in firsts.values()] == [2, 2]
    for f, u in zip(*firsts.values()):
        assert float((f - u).abs().max()) < 1e-4


def test_engine_stops_at_max_len():
    _, tcfg, _, model = carried()
    eng = Engine(tcfg, model, tctx(attn_impl="flash"), max_batch=2,
                 max_len=16, device="cpu")
    for r, p in enumerate(prompts(tcfg)[:2]):
        eng.add_request(Request(rid=r, prompt=p, max_new_tokens=50))
    done = eng.run_to_completion()
    # pos starts at the prompt length and stops at max_len - 1
    assert sorted(len(d.out_tokens) for d in done) == [16 - 1 - 9 + 1,
                                                       16 - 1 - 4 + 1]


def test_greedy_matches_prefill_oracle():
    _, tcfg, _, model = carried()
    pctx = tctx(attn_impl="flash")
    eng = Engine(tcfg, model, pctx, max_batch=2, max_len=32, device="cpu")
    prompt = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, size=(6,)).astype(np.int32)
    eng.add_request(Request(rid=0, prompt=prompt, max_new_tokens=4))
    out = [int(t) for t in eng.run_to_completion()[0].out_tokens]
    seq, ref = list(prompt), []
    for _ in range(4):
        logits, _ = TT.prefill(model, torch.tensor([seq]), tcfg, pctx)
        ref.append(int(torch.argmax(logits[0, 0])))
        seq.append(ref[-1])
    assert out == ref


@pytest.mark.parametrize("slot,length", [(0, 5), (2, 11)])
def test_insert_slot_matches_reference(slot, length):
    jcfg, tcfg, jp, model = carried(seed=2)
    rng = np.random.default_rng(slot)
    B, S = 3, 16
    jbig = JT.init_caches(jcfg, B, S, jnp.float32)
    jbig = jax.tree.map(
        lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32)),
        jbig)
    tbig = TT.init_caches(tcfg, B, S, torch.float32, "cpu")
    for li, c in enumerate(tbig):
        per = li // jcfg.period
        jc = jbig["periods"][li % jcfg.period]
        c.k.copy_(torch.from_numpy(np.array(jc.k[per])))
        c.v.copy_(torch.from_numpy(np.array(jc.v[per])))
    tok = rng.integers(0, jcfg.vocab_size, size=(1, length)).astype(np.int32)
    _, jsmall = JT.prefill(jp, jnp.asarray(tok), jcfg,
                           jctx(attn_impl="full"))
    _, tsmall = TT.prefill(model, torch.from_numpy(tok).long(), tcfg,
                           tctx(attn_impl="full"))
    want = jinsert(jbig, jsmall, slot)
    got = insert_slot(tbig, tsmall, slot)
    assert got is tbig                                  # written in place
    for li, c in enumerate(got):
        jc = want["periods"][li % jcfg.period]
        per = li // jcfg.period
        for t, w in ((c.k, jc.k[per]), (c.v, jc.v[per])):
            assert np.abs(t.numpy() - np.asarray(w)).max() < 1e-4
            # untouched slots and positions are copied bits
            keep = np.ones(t.shape, bool)
            keep[slot, :, :length] = False
            assert np.array_equal(t.numpy()[keep], np.asarray(w)[keep])


def test_sampling_modes():
    gen = torch.Generator().manual_seed(0)
    logits = torch.tensor([[0.0, 5.0, 1.0, -2.0]])
    assert int(sample_logits(gen, logits, temperature=0.0)[0]) == 1
    # top-k=1 equals greedy regardless of temperature
    for _ in range(8):
        assert int(sample_logits(gen, logits, temperature=2.0,
                                 top_k=1)[0]) == 1
    draws = [int(sample_logits(gen, logits, temperature=1.0)[0])
             for _ in range(64)]
    assert set(draws) <= {0, 1, 2, 3}
    assert np.bincount(draws, minlength=4).argmax() == 1
    # ties go to the first largest logit, as jnp.argmax
    tied = torch.tensor([[1.0, 3.0, 3.0], [2.0, 2.0, 0.0]])
    assert sample_logits(gen, tied, temperature=0.0).tolist() == [1, 0]


def test_launcher_smoke_on_cpu(capsys):
    assert launch_serve.main(["--arch", "qwen3-0.6b", "--smoke",
                              "--device", "cpu"]) == 0
    assert capsys.readouterr().out.startswith("served 8 requests, 128 tokens")


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tcfg, _, model = carried()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(tcfg, model, tctx(attn_impl="flash"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--arch", "qwen3-0.6b", "--smoke"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.load_jax_params(tcfg, {}, None)


def test_engine_rejects_params_on_another_device():
    _, tcfg, _, model = carried()
    model = model.to(torch.float64)         # still on the CPU: accepted
    Engine(dataclasses.replace(tcfg, dtype="float64"), model,
           tctx(attn_impl="full"), device="cpu")
    with pytest.raises(ValueError, match="engine on meta"):
        Engine(tcfg, model, tctx(attn_impl="full"), device="meta")


@pytest.mark.parametrize("slot,length", [(0, 2), (2, 13)])
def test_insert_slot_ssm_matches_reference(slot, length):
    """An SSD layer's slot gets the prefill's whole conv window (a prompt
    shorter than d_conv - 1 left-padded) and state; other slots keep their
    bits."""
    jcfg, tcfg, jp, model = carried("mamba2-780m", seed=3)
    rng = np.random.default_rng(slot)
    B = 3
    jbig = JT.init_caches(jcfg, B, 16, jnp.float32)
    jbig = jax.tree.map(
        lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32)),
        jbig)
    tbig = TT.init_caches(tcfg, B, 16, torch.float32, "cpu")
    for li, c in enumerate(tbig):
        jc = jbig["periods"][li % jcfg.period]
        per = li // jcfg.period
        c.conv.copy_(torch.from_numpy(np.array(jc.conv[per])))
        c.h.copy_(torch.from_numpy(np.array(jc.h[per])))
    tok = rng.integers(0, jcfg.vocab_size, size=(1, length)).astype(np.int32)
    _, jsmall = JT.prefill(jp, jnp.asarray(tok), jcfg,
                           jctx(attn_impl="full"))
    _, tsmall = TT.prefill(model, torch.from_numpy(tok).long(), tcfg,
                           tctx(attn_impl="flash"))
    want = jinsert(jbig, jsmall, slot)
    got = insert_slot(tbig, tsmall, slot)
    assert got is tbig                                  # written in place
    for li, c in enumerate(got):
        jc = want["periods"][li % jcfg.period]
        per = li // jcfg.period
        for t, w in ((c.conv, jc.conv[per]), (c.h, jc.h[per])):
            assert np.abs(t.numpy() - np.asarray(w)).max() < 1e-4
            keep = np.ones(t.shape, bool)
            keep[slot] = False
            assert np.array_equal(t.numpy()[keep], np.asarray(w)[keep])


def test_mamba2_engine_matches_reference():
    """``tests/test_serve.py``'s ``test_engine_completes_all`` requests on
    reduced mamba2-780m: every request finishes, with the reference
    engine's greedy tokens (idle slots decode too; their SSM state is
    overwritten at the next admission)."""
    jcfg, tcfg, jp, model = carried("mamba2-780m")
    jeng = JEngine(jcfg, jp, jctx(remat=False, attn_impl="full"),
                   max_batch=3, max_len=48)
    eng = Engine(tcfg, model, tctx(attn_impl="flash"), max_batch=3,
                 max_len=48, device="cpu")
    for r, p in enumerate(prompts(jcfg)):
        jeng.add_request(JRequest(rid=r, prompt=p, max_new_tokens=4 + r))
        eng.add_request(Request(rid=r, prompt=p, max_new_tokens=4 + r))
    want, got = served(jeng.run_to_completion()), \
        served(eng.run_to_completion())
    assert len(got) == 5
    assert sorted(len(t) for _, t in got) == [4, 5, 6, 7, 8]
    assert got == want


def test_launcher_smoke_mamba2_on_cpu(capsys):
    assert launch_serve.main(["--arch", "mamba2-780m", "--smoke",
                              "--device", "cpu"]) == 0
    assert capsys.readouterr().out.startswith("served 8 requests, 128 tokens")


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "qwen3-moe-30b-a3b"])
def test_launcher_smoke_rglru_and_moe_on_cpu(capsys, arch):
    """The launcher serves the RG-LRU and MoE archs at reduced sizes:
    every request finishes with its 16 tokens."""
    assert launch_serve.main(["--arch", arch, "--smoke",
                              "--device", "cpu"]) == 0
    assert capsys.readouterr().out.startswith("served 8 requests, 128 tokens")


def reference_layer_cache(caches, cfg, li):
    """Layer ``li``'s cache in the reference's {"periods", "tail"} caches,
    as a tuple of arrays."""
    n_full = cfg.n_full_periods * cfg.period
    if li < n_full:
        return tuple(f[li // cfg.period]
                     for f in caches["periods"][li % cfg.period])
    return tuple(caches["tail"][li - n_full])


@pytest.mark.parametrize("slot,length", [(0, 2), (2, 13)])
def test_insert_slot_rglru_matches_reference(slot, length):
    """recurrentgemma's caches: an RG-LRU layer's slot gets the prefill's
    whole conv window (a prompt shorter than 3 tokens left-padded) and
    state, a local-attention layer's its KV prefix; other slots and
    positions keep their bits."""
    jcfg, tcfg, jp, model = carried("recurrentgemma-9b", seed=4)
    rng = np.random.default_rng(slot)
    B, S = 3, 16
    jbig = JT.init_caches(jcfg, B, S, jnp.float32)
    jbig = jax.tree.map(
        lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32)),
        jbig)
    tbig = TT.init_caches(tcfg, B, S, torch.float32, "cpu")
    kinds = set()
    for li, c in enumerate(tbig):
        kinds.add(type(c).__name__)
        for f, w in zip(c, reference_layer_cache(jbig, jcfg, li)):
            f.copy_(torch.from_numpy(np.array(w)))
    assert kinds == {"RGLRUCache", "KVCache"}
    tok = rng.integers(0, jcfg.vocab_size, size=(1, length)).astype(np.int32)
    _, jsmall = JT.prefill(jp, jnp.asarray(tok), jcfg,
                           jctx(attn_impl="full"))
    _, tsmall = TT.prefill(model, torch.from_numpy(tok).long(), tcfg,
                           tctx(attn_impl="flash"))
    want = jinsert(jbig, jsmall, slot)
    got = insert_slot(tbig, tsmall, slot)
    assert got is tbig                                  # written in place
    for li, c in enumerate(got):
        for t, w in zip(c, reference_layer_cache(want, jcfg, li)):
            w = np.asarray(w)
            assert np.abs(t.numpy() - w).max() < 1e-4
            keep = np.ones(t.shape, bool)
            if t.dim() == 4:                            # k, v
                keep[slot, :, :length] = False
            else:                                       # conv, h
                keep[slot] = False
            assert np.array_equal(t.numpy()[keep], w[keep])


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "qwen3-moe-30b-a3b"])
def test_engine_matches_reference_rglru_and_moe(arch):
    """``test_mamba2_engine_matches_reference``'s requests on reduced
    recurrentgemma-9b (idle slots decode too; their RG-LRU state is
    overwritten at the next admission) and reduced qwen3-moe-30b-a3b
    (idle slots compete for expert capacity, which at a capacity factor
    of 4 drops nothing)."""
    jcfg, tcfg, jp, model = carried(arch)
    jeng = JEngine(jcfg, jp, jctx(remat=False, attn_impl="full"),
                   max_batch=3, max_len=48)
    eng = Engine(tcfg, model, tctx(attn_impl="flash"), max_batch=3,
                 max_len=48, device="cpu")
    for r, p in enumerate(prompts(jcfg)):
        jeng.add_request(JRequest(rid=r, prompt=p, max_new_tokens=4 + r))
        eng.add_request(Request(rid=r, prompt=p, max_new_tokens=4 + r))
    want, got = served(jeng.run_to_completion()), \
        served(eng.run_to_completion())
    assert len(got) == 5
    assert sorted(len(t) for _, t in got) == [4, 5, 6, 7, 8]
    assert got == want
