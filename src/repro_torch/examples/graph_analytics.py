"""Graph analytics on the SpGEMM engine: the paper's two application
scenarios (sections 5.5-5.6) end to end on the port.  Twin of the
repository's ``examples/graph_analytics.py``.

  * triangle counting: reorder by degree, split A = L + U, then one masked
    product ``plan_spgemm(L, U, mask=A_perm)`` -- the mask prunes
    non-closing wedges inside the product, so the wedge matrix is never
    materialized;
  * multi-source BFS, two ways: the paper's dense tall-skinny SpMM frontier
    stack (``core.spmm``: the hand-written CUDA SpMM kernel on the card),
    and a masked-frontier variant, one boolean product per hop with the
    complemented visited mask.

Every sparse product goes through ``plan_spgemm`` + ``plan.execute``, so a
repeated query over the same graph skips straight to the numeric phase via
the structure-keyed plan cache.

    PYTHONPATH=src python -m repro_torch.examples.graph_analytics [--device cpu]

The mesh-scale triangle count of the reference example waits for the port
of ``core/distributed.py``.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import CSR, plan_cache_stats, plan_spgemm, spmm
from repro_torch.data.rmat import rmat_csr, symmetrize, triangular_split


def wedge_sum(c: CSR) -> float:
    """Sum of the valid entries of a wedge-count matrix, exactly.

    Each count is an integer below 2^24, exact in float32, but their sum
    need not be: it is taken in float64.  (The reference sums in float32,
    which rounds once the sum passes 2^24.)
    """
    return float(torch.where(c.valid_mask(), c.data, 0)
                 .to(torch.float64).sum())


def triangle_count(a: CSR) -> int:
    """Triangles via masked wedges: tri = sum(L@U under mask A_perm) / 2.

    The planned masked product runs the sort-based fallback, as in the
    reference.
    """
    L, U, adj = triangular_split(a, return_adjacency=True, device=a.device)
    plan = plan_spgemm(L, U, mask=adj, semiring="plus_times")
    c = plan.execute(L, U)
    return int(round(wedge_sum(c) / 2))


def multi_source_bfs(a: CSR, sources, n_hops: int) -> torch.Tensor:
    """Hop distances ``(n, len(sources))`` int32, -1 where not reached --
    the dense frontier stack, one SpMM per hop."""
    n, k = a.n_rows, len(sources)
    dev = a.device
    frontier = torch.zeros((n, k), dtype=torch.float32, device=dev)
    frontier[torch.as_tensor(sources, device=dev),
             torch.arange(k, device=dev)] = 1.0
    dist = torch.where(frontier > 0, 0, -1).to(torch.int32)
    for hop in range(1, n_hops + 1):
        frontier = (spmm(a, frontier) > 0).to(torch.float32)
        newly = (frontier > 0) & (dist < 0)
        dist = torch.where(newly, hop, dist).to(torch.int32)
    return dist


def _frontier_csr(rows, cols, shape, cap, device):
    vals = np.ones(len(rows), np.float32)
    return CSR.from_numpy_coo(np.asarray(rows), np.asarray(cols), vals,
                              shape, cap=cap, device=device)


def _coo_of(c: CSR):
    v = c.valid_mask().cpu().numpy()
    return c.row_ids().cpu().numpy()[v], c.indices.cpu().numpy()[v]


def multi_source_bfs_masked(a: CSR, sources, n_hops: int) -> torch.Tensor:
    """Masked-frontier BFS: sparse frontiers, visited retired by the mask.

    Each hop is one planned boolean-semiring product with the complemented
    visited mask, so the frontier CSR only ever holds newly discovered
    vertices; the plan's symbolic phase is the frontier-size oracle
    (``plan.nnz_c``).  Hop structures depend only on (graph, sources), so
    re-issuing the same BFS hits the plan cache on every hop.
    """
    n, k = a.n_rows, len(sources)
    dev = a.device
    cap = n * k
    rows, cols = np.asarray(sources), np.arange(k)
    frontier = _frontier_csr(rows, cols, (n, k), cap, dev)
    visited = frontier
    dist = np.full((n, k), -1, np.int32)
    dist[rows, cols] = 0
    for hop in range(1, n_hops + 1):
        # bucket_caps: power-of-two capacities, as the reference
        plan = plan_spgemm(a, frontier, algorithm="hash",
                           semiring="boolean", mask=visited,
                           complement_mask=True, bucket_caps=True)
        if plan.nnz_c == 0:
            break
        nxt = plan.execute(a, frontier)
        nr, nc = _coo_of(nxt)
        dist[nr, nc] = hop
        vr, vc = _coo_of(visited)
        visited = _frontier_csr(np.concatenate([vr, nr]),
                                np.concatenate([vc, nc]), (n, k), cap, dev)
        frontier = _frontier_csr(nr, nc, (n, k), cap, dev)
    return torch.from_numpy(dist).to(dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the graph (default: cuda)")
    device = ap.parse_args(argv).device

    # undirected graph from an R-MAT pattern
    a = symmetrize(rmat_csr(8, 8, "G500", seed=1, device=device),
                   device=device)
    ad = a.to_dense().cpu().numpy()
    print(f"graph: {a.n_rows} vertices, {int(a.nnz)} edges (directed nnz), "
          f"device {a.device}")

    tri = triangle_count(a)
    brute = int(np.trace(np.linalg.matrix_power(ad.astype(np.int64), 3)) // 6)
    print(f"triangles: masked L@U -> {tri}, brute force -> {brute}")
    assert tri == brute

    sources = [0, 17, 42, 100]
    dist = multi_source_bfs(a, sources, n_hops=6)

    t0 = time.perf_counter()
    dist_m = multi_source_bfs_masked(a, sources, n_hops=6)
    t_first = time.perf_counter() - t0
    assert torch.equal(dist, dist_m), \
        "masked-frontier BFS must agree with the dense frontier stack"
    reached = (dist >= 0).sum(dim=0).tolist()
    print(f"multi-source BFS from {sources}: reached per source {reached} "
          f"(dense SpMM == masked boolean SpGEMM)")

    # serving shape: the same query again -- every hop hits the plan cache
    before = plan_cache_stats()
    t0 = time.perf_counter()
    dist_r = multi_source_bfs_masked(a, sources, n_hops=6)
    t_repeat = time.perf_counter() - t0
    after = plan_cache_stats()
    assert torch.equal(dist_m, dist_r)
    hops_hit = after["hits"] - before["hits"]
    assert after["misses"] == before["misses"], \
        "repeat BFS must not plan anything new"
    print(f"repeat BFS: {hops_hit} cached plans (no schedule/symbolic/"
          f"recipe recomputation), {t_first:.3f}s -> {t_repeat:.3f}s")
    # repeat triangle count hits the cache too (reweighted-graph pattern)
    assert triangle_count(a) == brute
    print(f"plan cache: {plan_cache_stats()}")


if __name__ == "__main__":
    main()
