"""The port's MoE layer (``repro_torch.models.moe``) against ``repro``'s.

Weights are the reference's ``init`` of reduced qwen3-moe-30b-a3b's MLP (8
experts, top-2, d_model 64, d_expert 32), also at 16 experts top-4,
handed to both packages as the same numpy arrays; inputs are numpy arrays
from a seed.

Routing (``top_i``) and, under ``stable_dispatch_sort=True``, the
dispatch buffer and every assignment's slot are compared bitwise, at
capacities 1 and 2 (experts overflow) and at capacity >= T (none can).
Under the default unstable sort an overflowing expert keeps the
assignments its sort puts first, and ``torch.sort`` need not order ties as
XLA does, so there the tests hold the invariants: each expert keeps
exactly min(count, capacity) assignments, their slots are its block's
first slots in some order, each kept row is its token's features, and a
dropped assignment adds 0.  Float32 values (probabilities, the aux loss,
expert outputs) agree within 1e-4 absolute: sums in another order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import configs as jconfigs
from repro.models import moe as JM
from repro.parallel.sharding import single_device_ctx as jctx
from repro_torch import configs as tconfigs
from repro_torch.models import moe as TM
from repro_torch.parallel.sharding import single_device_ctx as tctx

TOL = 1e-4
#: (n_experts, top_k): the reduced config's, and a wider one
ROUTES = [(8, 2), (16, 4)]


def cfgs(n_experts=8, top_k=2, **moe_kw):
    def one(pkg):
        c = pkg.reduced(pkg.get("qwen3-moe-30b-a3b"))
        return dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, n_experts=n_experts, top_k=top_k, **moe_kw))
    return one(jconfigs), one(tconfigs)


def params(seed, n_experts=8, top_k=2, **moe_kw):
    jcfg, tcfg = cfgs(n_experts, top_k, **moe_kw)
    p = jax.tree.map(np.asarray, JM.init(jax.random.PRNGKey(seed), jcfg))
    return (jcfg, tcfg, {k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v.copy()) for k, v in p.items()})


def diff(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float32)
                        - np.asarray(want, np.float32)).max())


def routing(seed, t, e, k):
    """(T, k) distinct experts per token, as top-k gives them."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(e)[:k] for _ in range(t)]) \
        .astype(np.int32)


def features(seed, t, d=64):
    return np.random.default_rng(seed).normal(size=(t, d)).astype(np.float32)


def check_invariants(x2, top_i, buf, slot, n_experts, cap):
    """The dispatch contract whatever the order of ties."""
    x2, top_i = np.asarray(x2), np.asarray(top_i)
    buf, slot = np.asarray(buf), np.asarray(slot)
    assert buf.shape == (n_experts * cap, x2.shape[1])
    assert slot.shape == top_i.shape
    filled = np.zeros(n_experts * cap, bool)
    for e in range(n_experts):
        mine = top_i == e
        kept = slot[mine]
        n_keep = min(int(mine.sum()), cap)
        assert int((kept >= 0).sum()) == n_keep
        assert sorted(kept[kept >= 0]) == list(range(e * cap,
                                                     e * cap + n_keep))
        filled[e * cap:e * cap + n_keep] = True
    tok = np.nonzero(slot >= 0)[0]
    assert np.array_equal(buf[slot[slot >= 0]], x2[tok])
    assert not buf[~filled].any()
    return int((slot < 0).sum())


@pytest.mark.parametrize("n_experts,top_k", ROUTES)
def test_route_matches_reference(n_experts, top_k):
    jcfg, tcfg, jp, tp = params(0, n_experts, top_k)
    x2 = features(1, 40)
    wp, wi, wa = JM._route(jp, jnp.asarray(x2), jcfg)
    gp, gi, ga = TM._route(tp, torch.from_numpy(x2), tcfg)
    assert gp.dtype == torch.float32 and gi.shape == (40, top_k)
    assert np.array_equal(gi.numpy(), np.asarray(wi))
    assert diff(gp, wp) < TOL and abs(float(ga) - float(wa)) < TOL
    assert np.allclose(gp.sum(-1).numpy(), 1.0, atol=1e-6)


def test_init_matches_reference_layout():
    jcfg, tcfg = cfgs()
    want = jax.tree.map(np.asarray, JM.init(jax.random.PRNGKey(0), jcfg))
    got = TM.init(torch.Generator().manual_seed(0), tcfg)
    assert list(got) == ["router", "we_gate", "we_in", "we_out"]
    assert {k: v.shape for k, v in want.items()} == \
        {k: tuple(v.shape) for k, v in got.items()}
    for k in got:
        assert got[k].dtype == torch.float32
        assert abs(float(got[k].std()) / float(want[k].std()) - 1) < 0.1, k


@pytest.mark.parametrize("cap", [1, 2, 30])
@pytest.mark.parametrize("n_experts,top_k", ROUTES)
def test_dispatch_bitwise_under_stable_sort(n_experts, top_k, cap):
    """Buffer and slots equal the reference's bit for bit; at capacities
    1 and 2 experts overflow, at 30 (= T) none can."""
    t = 30
    top_i = routing(cap, t, n_experts, top_k)
    x2 = features(cap + 1, t)
    wb, ws = JM._dispatch(jnp.asarray(x2), jnp.asarray(top_i), n_experts,
                          cap, True)
    gb, gs = TM._dispatch(torch.from_numpy(x2),
                          torch.from_numpy(top_i).long(), n_experts, cap,
                          True)
    assert np.array_equal(gb.numpy(), np.asarray(wb))
    assert np.array_equal(gs.numpy(), np.asarray(ws))
    dropped = check_invariants(x2, top_i, gb, gs, n_experts, cap)
    assert (dropped > 0) == (cap < t * top_k / n_experts)


@pytest.mark.parametrize("cap", [1, 2, 30])
@pytest.mark.parametrize("n_experts,top_k", ROUTES)
def test_dispatch_invariants_under_unstable_sort(n_experts, top_k, cap):
    t = 30
    top_i = routing(10 + cap, t, n_experts, top_k)
    x2 = features(cap, t)
    gb, gs = TM._dispatch(torch.from_numpy(x2),
                          torch.from_numpy(top_i).long(), n_experts, cap,
                          False)
    dropped = check_invariants(x2, top_i, gb, gs, n_experts, cap)
    counts = np.bincount(top_i.ravel(), minlength=n_experts)
    assert dropped == int(np.maximum(counts - cap, 0).sum())
    # the reference's unstable sort holds the same contract and drops as
    # many assignments
    wb, ws = JM._dispatch(jnp.asarray(x2), jnp.asarray(top_i), n_experts,
                          cap, False)
    assert check_invariants(x2, top_i, wb, ws, n_experts, cap) == dropped


def test_combine_matches_reference():
    """Gathered expert outputs mixed by the gate probabilities; a dropped
    assignment (slot -1) adds 0."""
    rng = np.random.default_rng(3)
    t, k, e, cap = 12, 2, 8, 2
    top_i = routing(4, t, e, k)
    x2 = features(5, t)
    _, slot = JM._dispatch(jnp.asarray(x2), jnp.asarray(top_i), e, cap, True)
    slot = np.array(slot)
    assert (slot < 0).any()
    ybuf = rng.normal(size=(e * cap, 64)).astype(np.float32)
    top_p = rng.uniform(size=(t, k)).astype(np.float32)
    want = JM._combine(jnp.asarray(ybuf), jnp.asarray(slot),
                       jnp.asarray(top_p))
    got = TM._combine(torch.from_numpy(ybuf), torch.from_numpy(slot).long(),
                      torch.from_numpy(top_p))
    assert diff(got, want) < TOL
    by_hand = sum(np.where(slot[:, j:j + 1] >= 0,
                           ybuf[np.maximum(slot[:, j], 0)], 0)
                  * top_p[:, j:j + 1] for j in range(k))
    assert diff(got, by_hand) < TOL


def test_expert_ffn_matches_reference():
    _, _, jp, tp = params(6)
    xb = np.random.default_rng(7).normal(size=(8, 5, 64)).astype(np.float32)
    want = JM._expert_ffn(jnp.asarray(xb), jp["we_gate"], jp["we_in"],
                          jp["we_out"])
    got = TM._expert_ffn(torch.from_numpy(xb), tp["we_gate"], tp["we_in"],
                         tp["we_out"])
    assert got.shape == want.shape and diff(got, want) < TOL
    # bf16 compute casts the masters at use, as the reference does
    got16 = TM._expert_ffn(torch.from_numpy(xb).bfloat16(), tp["we_gate"],
                           tp["we_in"], tp["we_out"])
    assert got16.dtype == torch.bfloat16
    want16 = JM._expert_ffn(jnp.asarray(xb, jnp.bfloat16), jp["we_gate"],
                            jp["we_in"], jp["we_out"])
    rel = float(np.linalg.norm(got16.float().numpy() -
                               np.asarray(want16, np.float32))
                / np.linalg.norm(np.asarray(want16, np.float32)))
    assert rel < 2e-2          # two bf16 roundings apart at most


@pytest.mark.parametrize("stable", [True, False])
@pytest.mark.parametrize("capacity_factor", [0.5, 1.25, 4.0])
@pytest.mark.parametrize("n_experts,top_k", ROUTES)
def test_apply_dense_matches_reference(n_experts, top_k, capacity_factor,
                                       stable):
    """y and aux; under the stable sort always, under the unstable sort
    where nothing is dropped (capacity factor 4 gives cap >= T)."""
    jcfg, tcfg, jp, tp = params(8, n_experts, top_k,
                                capacity_factor=capacity_factor,
                                stable_dispatch_sort=stable)
    x = np.random.default_rng(9).normal(size=(2, 9, 64)).astype(np.float32)
    got, gaux = TM.apply_dense(tp, torch.from_numpy(x), tcfg)
    assert got.shape == x.shape
    t = x.shape[0] * x.shape[1]
    assert TM.capacity(t, tcfg) == max(1, int(t * top_k / n_experts
                                              * capacity_factor))
    want, waux = JM.apply_dense(jp, jnp.asarray(x), jcfg)
    assert abs(float(gaux) - float(waux)) < TOL
    if stable or capacity_factor >= n_experts / top_k:
        assert diff(got, want) < TOL
    # either way: each token's output is the sum of its kept experts'
    # SwiGLU outputs times its gate probabilities, a dropped one adding 0
    x2 = torch.from_numpy(x.reshape(t, 64))
    top_p, top_i, _ = TM._route(tp, x2, tcfg)
    _, slot = TM._dispatch(x2, top_i, n_experts, TM.capacity(t, tcfg),
                           stable)
    by_hand = torch.zeros_like(x2)
    for i in range(t):
        for j in range(top_k):
            if slot[i, j] < 0:
                continue
            e = int(top_i[i, j])
            h = F.silu(x2[i] @ tp["we_gate"][e]) * (x2[i] @ tp["we_in"][e])
            by_hand[i] += top_p[i, j] * (h @ tp["we_out"][e])
    assert diff(got.reshape(t, 64), by_hand) < TOL


def test_apply_is_apply_dense_on_one_device():
    jcfg, tcfg, jp, tp = params(10)
    x = np.random.default_rng(11).normal(size=(1, 6, 64)).astype(np.float32)
    got, gaux = TM.apply(tp, torch.from_numpy(x), tcfg, tctx())
    want, waux = JM.apply(jp, jnp.asarray(x), jcfg, jctx(remat=False))
    dense, daux = TM.apply_dense(tp, torch.from_numpy(x), tcfg)
    assert torch.equal(got, dense) and float(gaux) == float(daux)
    assert diff(got, want) < TOL and abs(float(gaux) - float(waux)) < TOL
