"""Batched MoE dispatch as a fleet of SpGEMMs, and block-diagonal
squaring (twin of ``examples/moe_dispatch_batch.py``'s
``moe_dispatch_demo`` and ``block_diagonal_demo``).

Expert ``e``'s dispatch is the product ``G_e @ F`` of its one-hot token
gather matrix with a sparse feature matrix ``F`` that every expert shares:
a fleet of products sharing one B.  ``plan_batch`` inspects the fleet once
and buckets it into a few p2 capacity classes; every serving step then runs
one batched hash kernel launch per bin index and class instead of one
planned product per expert, and reads ``F`` in place, never copied per
expert.

The block-diagonal demo squares a DBCSR-style fleet of 12 small R-MAT
blocks with ``plan_batch_power``: one batched plan per stage, one
classifying launch and one launch per table class per plan class.  The
reference example's ``shard_batch`` lines (``core/distributed.py``) wait
for a later slice of the port.

Run:  PYTHONPATH=src python -m repro_torch.examples.moe_dispatch_batch
      (``--device cpu`` runs the kernels' plain versions on the CPU)
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import (CSR, clear_plan_cache, plan_batch,
                              plan_batch_power, plan_cache_stats, plan_spgemm)
from repro_torch.core.formats import resolve_device
from repro_torch.data.rmat import rmat_csr

# the reference example's routing shapes (qwen3-moe-30b-a3b, reduced)
N_EXPERTS = 32
TOP_K = 4
T = 1024
D_MODEL = 256
FEATURE_DENSITY = 0.05


def build_dispatch_fleet(seed: int = 0, *, n_experts: int = N_EXPERTS,
                         top_k: int = TOP_K, tokens: int = T,
                         d_model: int = D_MODEL,
                         density: float = FEATURE_DENSITY, device=None):
    """Per-expert gather matrices ``G_e`` (cap_e x tokens) and the shared
    sparse ``F`` (tokens x d_model), as the reference builds them.

    The router draws ``top_k`` distinct experts per token, uniformly; G_e
    has one unit entry per slot (slot -> token), so ``G_e @ F`` is exactly
    expert e's dispatched feature rows.  Returns ``(pairs, fd, assign)``:
    the fleet, F dense on the host and the routing ``(tokens, top_k)``.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    assign = np.stack([rng.choice(n_experts, size=top_k, replace=False)
                       for _ in range(tokens)])
    fd = rng.uniform(0.5, 1.5, size=(tokens, d_model)).astype(np.float32)
    fd = np.where(rng.random((tokens, d_model)) < density, fd, 0.0)
    rows, cols = np.nonzero(fd)
    f = CSR.from_numpy_coo(rows, cols, fd[rows, cols], (tokens, d_model),
                           device=dev)
    pairs = []
    for e in range(n_experts):
        tok = np.nonzero((assign == e).any(axis=1))[0]
        cap_e = max(len(tok), 1)
        g = CSR.from_numpy_coo(np.arange(len(tok)), tok,
                               np.ones(len(tok), np.float32),
                               (cap_e, tokens), device=dev)
        pairs.append((g, f))
    return pairs, fd, assign


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def moe_dispatch_demo(device=None) -> dict:
    """Plan and run the dispatch fleet; assert each expert's output equals
    its gathered oracle rows; time the batched execute against a loop of
    per-expert planned products (host clock)."""
    dev = resolve_device(device)
    print(f"== batched MoE dispatch: {N_EXPERTS} experts, top-{TOP_K}, "
          f"{T} tokens, d={D_MODEL}, on {dev} ==")
    pairs, fd, assign = build_dispatch_fleet(device=dev)
    clear_plan_cache()
    plan = plan_batch(pairs)
    print(f"fleet of {plan.n_products} products -> {plan.n_classes} "
          f"capacity classes, algorithms {sorted(set(plan.algorithms))}")
    assert plan.n_classes <= 6, "expert loads should bucket tightly"

    outs = plan.execute(pairs)
    for e, c in enumerate(outs):
        tokens = np.nonzero((assign == e).any(axis=1))[0]
        assert np.array_equal(c.to_dense().cpu().numpy(), fd[tokens])
    print("dispatched features == gathered oracle rows: OK")

    per_expert = [plan_spgemm(g, f, algorithm=plan.algorithms[i])
                  for i, (g, f) in enumerate(pairs)]

    def loop():
        return [p.execute(g, f) for p, (g, f) in zip(per_expert, pairs)]

    def timed(fn, reps=3):
        fn()
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        _sync(dev)
        return (time.perf_counter() - t0) / reps

    t_loop = timed(loop)
    t_bat = timed(lambda: plan.execute(pairs))
    print(f"loop of planned products {t_loop * 1e3:.3f} ms vs batched "
          f"{t_bat * 1e3:.3f} ms per serving step ({plan.n_products} "
          f"products, {plan.n_classes} classes)")
    return {"plan": plan, "pairs": pairs, "outs": outs, "fd": fd,
            "assign": assign}


def diagonal_blocks(device=None) -> list:
    """The demo's fleet: 12 R-MAT blocks of 16 x 16, ER and G500 in turn,
    edge factors 1-3, seeds 40-51 (the reference's)."""
    dev = resolve_device(device)
    return [rmat_csr(4, 1 + (i % 3), "G500" if i % 2 else "ER",
                     seed=40 + i, device=dev) for i in range(12)]


def block_diagonal_demo(device=None) -> dict:
    """Square every block with one batched power plan; assert each square
    equals its dense float64 one and that the plan needs fewer class
    executors than products x stages."""
    print("== block-diagonal squaring (DBCSR-style fleet) ==")
    blocks = diagonal_blocks(device)
    clear_plan_cache()
    plan = plan_batch_power(blocks, 2)
    outs = plan.execute(blocks)
    for a, c in zip(blocks, outs):
        d = a.to_dense().to(torch.float64)
        assert torch.allclose(c.to_dense().to(torch.float64), d @ d,
                              atol=1e-3)
    print(f"{plan.n_products} blocks squared with {plan.n_classes} "
          f"class executors (vs {plan.n_products * plan.n_stages} "
          f"per-product)")
    assert plan.n_classes < plan.n_products * plan.n_stages
    kinds = plan_cache_stats()["kinds"]
    print(f"plan cache kinds: batch={kinds['batch']}, "
          f"batch_power={kinds['batch_power']}")
    return {"plan": plan, "blocks": blocks, "outs": outs}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    moe_dispatch_demo(args.device)
    block_diagonal_demo(args.device)
    print("moe_dispatch_batch: OK")


if __name__ == "__main__":
    main()
