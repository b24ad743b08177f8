"""Batched MoE dispatch as a fleet of SpGEMMs (twin of
``examples/moe_dispatch_batch.py``'s ``moe_dispatch_demo``).

Expert ``e``'s dispatch is the product ``G_e @ F`` of its one-hot token
gather matrix with a sparse feature matrix ``F`` that every expert shares:
a fleet of products sharing one B.  ``plan_batch`` inspects the fleet once
and buckets it into a few p2 capacity classes; every serving step then runs
one batched hash kernel launch per bin index and class instead of one
planned product per expert, and reads ``F`` in place, never copied per
expert.

The reference example's other parts wait for later slices of the port:
its ``shard_batch`` lines (``core/distributed.py``) and
``block_diagonal_demo`` (``plan_batch_power``, ``core/chain.py``).

Run:  PYTHONPATH=src python -m repro_torch.examples.moe_dispatch_batch
      (``--device cpu`` runs the kernels' plain versions on the CPU)
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import CSR, clear_plan_cache, plan_batch, plan_spgemm
from repro_torch.core.formats import resolve_device

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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    moe_dispatch_demo(args.device)
    print("moe_dispatch_batch: OK")


if __name__ == "__main__":
    main()
