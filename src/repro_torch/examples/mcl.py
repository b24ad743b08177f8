"""Markov clustering (MCL, van Dongen 2000) on the planned SpGEMM engine.
Twin of the repository's ``examples/mcl.py``.

MCL finds graph clusters by iterating a row-stochastic flow matrix M:

  * **expand**  -- M <- M @ M, a planned SpGEMM (the A^2 shape of
    ``core.chain.plan_power``) that runs the hash numeric kernel on the
    card.  Flow spreads along paths;
  * **inflate** -- M <- row_normalize(M ** r): sharpens strong flows and
    starves weak ones;
  * **prune**   -- drop entries below a threshold and renormalize, keeping
    the matrix sparse as it converges.

Every iteration's M has another sparsity pattern.  ``plan_spgemm(...,
bucket_caps=True)`` rounds the static capacities (``cap_c``/``flop_cap``)
up to powers of two, so iterations whose rounded sizes coincide share
their allocations; :func:`main` asserts that the pairs repeat.  Expansion
products run the hash family unsorted: nothing downstream needs sorted
rows (the paper's C8 finding on an iterative workload).

    PYTHONPATH=src python -m repro_torch.examples.mcl [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.core import CSR, lowest_p2, plan_cache_stats, plan_spgemm
from repro_torch.core.formats import prefix_sum, resolve_device


def clustered_graph(n_clusters: int = 3, size: int = 12, p_in: float = 0.6,
                    p_out: float = 0.02, seed: int = 0, device=None) -> CSR:
    """Planted-partition graph, the reference's draw: dense blocks at
    ``p_in``, cross edges at ``p_out``; symmetric, no self loops (MCL adds
    its own)."""
    n = n_clusters * size
    rng = np.random.default_rng(seed)
    dense = rng.random((n, n))
    labels = np.repeat(np.arange(n_clusters), size)
    same = labels[:, None] == labels[None, :]
    adj = np.where(same, dense < p_in, dense < p_out)
    adj = np.triu(adj, k=1)
    adj = (adj | adj.T).astype(np.float32)
    return CSR.from_dense(torch.from_numpy(adj).to(resolve_device(device)))


def _row_sums(c: CSR, v: torch.Tensor) -> torch.Tensor:
    return torch.zeros(c.n_rows, dtype=v.dtype, device=v.device).index_add_(
        0, c.row_ids().long(), v)


def row_normalize(c: CSR) -> CSR:
    """Make each row of ``c`` sum to 1 (rows with no mass stay zero)."""
    v = torch.where(c.valid_mask(), c.data, 0)
    s = _row_sums(c, v)
    s = torch.where(s == 0, 1.0, s)
    return dataclasses.replace(c, data=v / s[c.row_ids().long()])


def inflate(c: CSR, power: float) -> CSR:
    """MCL inflation: elementwise power then row renormalization."""
    v = torch.where(c.valid_mask(), c.data, 0) ** power
    return row_normalize(dataclasses.replace(c, data=v))


def prune(c: CSR, threshold: float, cap_out: int) -> CSR:
    """Drop entries below ``threshold``, compact to ``cap_out`` slots,
    renormalize rows.

    The compaction is a stable sort of the drop mask, so the entries of a
    row keep their order and an unsorted expansion stays a valid unsorted
    CSR.  Pruning only removes entries, so the input's capacity is always
    a safe ``cap_out``.
    """
    keep = c.valid_mask() & (c.data >= threshold)
    order = torch.argsort((~keep).to(torch.int8), stable=True)
    lane = torch.arange(cap_out, device=c.device)
    src = order[torch.clamp(lane, max=c.cap - 1)]      # pad or truncate
    nnz = torch.clamp(keep.sum(), max=cap_out).to(torch.int32)
    valid = lane < nnz
    indices = torch.where(valid, c.indices[src], 0).to(torch.int32)
    data = torch.where(valid, c.data[src], 0).to(c.dtype)
    row_nnz = torch.zeros(c.n_rows, dtype=torch.int32,
                          device=c.device).index_add_(
        0, c.row_ids().long(), keep.to(torch.int32))
    out = CSR(prefix_sum(row_nnz).to(torch.int32), indices, data, nnz,
              c.shape, sorted_cols=c.sorted_cols)
    return row_normalize(out)


def _with_self_loops(a: CSR) -> CSR:
    d = a.to_dense().clone()
    d.fill_diagonal_(1.0)
    return CSR.from_dense(d)


def mcl(a: CSR, inflation: float = 1.5, threshold: float = 1e-3,
        max_iters: int = 40, tol: float = 1e-5, caps: list | None = None):
    """Run MCL to convergence on ``a``'s device; returns ``(labels,
    n_iters)``.

    ``labels[i]`` is the cluster id of vertex ``i``: in the converged
    row-stochastic limit, row i's mass sits on i's attractor set, so the
    argmax column names the cluster (canonicalized to 0..k-1).  ``caps``,
    when given, gets each iteration's expansion ``(cap_c, flop_cap)``.
    """
    m = row_normalize(_with_self_loops(a))
    n_iters = 0
    buf_cap = None
    for n_iters in range(1, max_iters + 1):
        # expand: planned A^2 with p2 capacities, on the hash kernel
        plan = plan_spgemm(m, m, algorithm="hash", bucket_caps=True)
        if caps is not None:
            caps.append((plan.cap_c, plan.flop_cap))
        nxt = inflate(plan.execute(m, m), inflation)
        # the flow matrix lives in a fixed-cap buffer; grow it only if
        # pruning would drop live entries
        kept = int((nxt.valid_mask() & (nxt.data >= threshold)).sum())
        if buf_cap is None or kept > buf_cap:
            buf_cap = lowest_p2(max(kept, 1))
        nxt = prune(nxt, threshold, buf_cap)
        delta = float((nxt.to_dense() - m.to_dense()).abs().max())
        m = nxt
        if delta < tol:
            break
    attractor = m.to_dense().argmax(dim=1).cpu().numpy()
    _, labels = np.unique(attractor, return_inverse=True)
    return labels, n_iters


def recovers(labels: np.ndarray, n_clusters: int, size: int) -> bool:
    """Is ``labels`` the planted partition: constant within each planted
    block and distinct across blocks?"""
    truth = np.repeat(np.arange(n_clusters), size)
    blocks = [set(labels[truth == k]) for k in range(n_clusters)]
    return all(len(s) == 1 for s in blocks) and \
        len({next(iter(s)) for s in blocks}) == n_clusters


def run(n_clusters: int, size: int, device=None, **kw) -> dict:
    """Cluster one planted-partition graph and check the partition and the
    repeat of the p2 capacity pairs; returns what it measured."""
    a = clustered_graph(n_clusters, size, seed=0, device=device)
    print(f"graph: {a.n_rows} vertices, {int(a.nnz)} edges, "
          f"{n_clusters} planted clusters, on {a.device}")
    caps: list = []
    labels, n_iters = mcl(a, caps=caps, **kw)
    assert recovers(labels, n_clusters, size), \
        "MCL must recover the planted clusters"
    distinct = len(set(caps))
    print(f"MCL converged in {n_iters} iterations; recovered all "
          f"{n_clusters} planted clusters; {distinct} distinct p2 "
          f"(cap_c, flop_cap) pairs over {n_iters} expansions")
    assert distinct < n_iters or n_iters <= 2, \
        "bucketed capacities should repeat across drifting iterations"
    return {"n_iters": n_iters, "caps": caps, "labels": labels}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    run(3, 12, device=args.device)
    stats = plan_cache_stats()
    print(f"plan cache: {stats['misses']} inspections, {stats['hits']} "
          f"hits")
    print("mcl: OK")


if __name__ == "__main__":
    main()
