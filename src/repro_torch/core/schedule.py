"""Light-weight load-balanced scheduling (paper section 4.1, Fig. 6).

Port of ``repro.core.schedule``.  ``RowsToThreads``: count flop per output
row, prefix-sum, then find each bin's start row with a binary search
(``LOWBND``).  The bins and the per-bin power-of-two hash-table sizes are
the plan arrays the hash kernels take.

Flop prefix sums accumulate in int64 (the reference's x64 branch), so the
equal-flop partition cannot wrap at any size a card holds; per-row flop
stays int32 as in the reference.  What must still fit int32 is the total
flop, because the ESC expansion of :func:`repro_torch.core.spgemm.symbolic`
numbers its products with int32 positions in the reference -- the guard
below raises before a product that large is planned.
"""
from __future__ import annotations

import torch

from .formats import CSR, prefix_sum

#: largest total flop the symbolic expansion may number.
_I32_MAX = 2**31 - 1
_I32_MIN = -2**31


def guard_i32_flop(flop: torch.Tensor, what: str = "symbolic") -> None:
    """Raise ``OverflowError`` when the total flop does not fit int32."""
    total = int(flop.to(torch.int64).sum())
    if total > _I32_MAX:
        raise OverflowError(
            f"{what}: total flop {total} overflows the int32 expansion "
            f"positions; shard the product")


def flops_per_row(a: CSR, b: CSR) -> torch.Tensor:
    """``flop[i] = sum_{k in a_i*} nnz(b_k*)`` -- Fig. 6 step 1 (int32).

    Both the load-balance weight and the hash-table sizing bound: row i of
    C touches at most ``flop[i]`` distinct columns.
    """
    k = a.indices.long()
    rnz = (b.indptr[k + 1] - b.indptr[k]).to(torch.int64)
    rnz = torch.where(a.valid_mask(), rnz, torch.zeros_like(rnz))
    cs = prefix_sum(rnz)
    ip = a.indptr.long()
    return (cs[ip[1:]] - cs[ip[:-1]]).to(torch.int32)


def masked_row_bound(flop: torch.Tensor, mask: CSR,
                     complement: bool = False) -> torch.Tensor:
    """Per-row nnz(C) upper bound under a structural mask."""
    mrow = mask.row_nnz().to(flop.dtype)
    lim = (mask.n_cols - mrow) if complement else mrow
    return torch.minimum(flop, lim)


def lowbnd(vec: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """Minimum id such that ``vec[id] >= value`` (Fig. 6 line 14)."""
    return torch.searchsorted(vec, value, right=False).to(torch.int32)


def rows_to_bins(flop: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Fig. 6 step 2: equal-flop partition; returns offsets ``(n_bins+1,)``
    int32 with ``offsets[0] == 0`` and ``offsets[-1] == n_rows``."""
    m = flop.shape[0]
    ps = prefix_sum(flop.to(torch.int64))
    total = ps[-1]
    targets = (total * torch.arange(1, n_bins, dtype=torch.int64,
                                    device=flop.device)) // n_bins
    # bin b starts at the first row whose cumulative flop reaches target b
    cuts = lowbnd(ps[1:].contiguous(), targets + 1)
    offsets = torch.cat([
        torch.zeros(1, dtype=torch.int32, device=flop.device), cuts,
        torch.full((1,), m, dtype=torch.int32, device=flop.device)])
    return torch.clamp(offsets, max=m)


def bin_row_assignment(offsets: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Inverse view: bin id of every row, ``(n_rows,)``."""
    r = torch.arange(n_rows, dtype=torch.int32, device=offsets.device)
    return (torch.searchsorted(offsets, r, right=True) - 1).to(torch.int32)


def bin_flop(flop: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Total flop per bin ``(n_bins,)`` int64 -- the balance metric."""
    ps = prefix_sum(flop.to(torch.int64))
    o = offsets.long()
    return ps[o[1:]] - ps[o[:-1]]


def max_flop_per_bin_row(flop: torch.Tensor,
                         offsets: torch.Tensor) -> torch.Tensor:
    """Per-bin max row flop ``(n_bins,)`` (Fig. 7 lines 5-12).  An empty
    bin holds the int32 minimum, the identity of the reference's
    ``segment_max``."""
    n_bins = offsets.shape[0] - 1
    bins = bin_row_assignment(offsets, flop.shape[0]).long()
    out = torch.full((n_bins,), _I32_MIN, dtype=torch.int32,
                     device=flop.device)
    return out.scatter_reduce_(0, bins, flop.to(torch.int32), "amax",
                               include_self=True)


def make_schedule_eager(a: CSR, b: CSR, n_bins: int):
    """Fig. 6 pipeline: ``(flop, offsets, bin_table_size)`` where the last
    is the per-bin bound ``min(N_col, max-row-flop-in-bin)`` of Fig. 7
    line 10 (power-of-two rounding happens in :func:`bin_table_sizes`)."""
    flop = flops_per_row(a, b)
    offsets = rows_to_bins(flop, n_bins)
    tsize = torch.clamp(max_flop_per_bin_row(flop, offsets), max=b.n_cols)
    return flop, offsets, tsize


def chained_flop_bound(row_nnz_prev, b: CSR) -> torch.Tensor:
    """A-priori per-row flop bound for the next product of a chain, int32.

    Before the intermediate ``C_k`` of a chain exists, the previous
    stage's symbolic counts ``row_nnz_prev = nnz(c_k,i*)`` are exact, and
    row ``i`` of stage ``k+1`` touches at most one row of ``B`` per
    intermediate entry:

        flop_{k+1}[i] <= nnz(c_k,i*) * max_j nnz(b_j*)

    Once ``core.chain.plan_chain`` materializes the intermediate, the
    exact :func:`flops_per_row` replaces this bound.
    """
    row_nnz_prev = torch.as_tensor(row_nnz_prev, device=b.device)
    bmax = b.row_nnz().max().to(torch.int32) if b.n_rows else \
        torch.zeros((), dtype=torch.int32, device=b.device)
    return row_nnz_prev.to(torch.int32) * bmax


def lowest_p2(x: int) -> int:
    """Minimum ``2^n >= x`` (Fig. 7 line 12)."""
    p = 1
    while p < x:
        p *= 2
    return p


def lowest_p2_arr(x: torch.Tensor) -> torch.Tensor:
    """:func:`lowest_p2` over an int32 tensor, with the reference's float32
    log2 and exactness patch-up (exact for values below 2^24)."""
    x = torch.clamp(x.to(torch.int32), min=1)
    e = torch.ceil(torch.log2(x.to(torch.float32))).to(torch.int32)
    p = torch.ones_like(x) << torch.clamp(e, 0, 30)
    return torch.where(p < x, p * 2, p)


def bin_table_sizes(tsize: torch.Tensor, n_cols: int, table_size: int,
                    floor: int = 1) -> torch.Tensor:
    """Per-bin hash-table sizes (Fig. 7 lines 9-12): the lowest power of
    two ``>= min(tsize_b, n_cols) + 1`` (the +1 keeps the load factor below
    1 so linear probes end), clamped into ``[floor, table_size]``."""
    t = torch.clamp(tsize.to(torch.int32), max=n_cols) + 1
    return torch.clamp(lowest_p2_arr(t), max(floor, 1), table_size)


#: default propagation-blocking bucket budget: the average number of
#: partial products a column bucket should hold (the reference's value).
PB_BUCKET_BUDGET = 2048


def pb_bucket_layout(n_cols: int, n_buckets: int | None = None, *,
                     total_flop: int | None = None,
                     budget: int = PB_BUCKET_BUDGET) -> tuple:
    """Column-bucket layout for propagation-blocking SpGEMM:
    ``(bucket_w, n_buckets)``, ``bucket_w`` a power of two, column ``c`` in
    bucket ``c // bucket_w``, and ``ceil(n_cols / bucket_w)`` buckets.

    With ``n_buckets=None`` the count is the least that keeps the average
    bucket at ``<= budget`` products (never more buckets than columns);
    an explicit count is honoured up to the power-of-two rounding of
    ``bucket_w``, which may return fewer buckets.
    """
    if n_cols < 1:
        raise ValueError(f"n_cols must be at least 1, got {n_cols}")
    if n_buckets is None:
        want = max(1, -(-(total_flop or 0) // budget))
        n_buckets = min(want, n_cols)
    n_buckets = max(1, min(int(n_buckets), n_cols))
    bucket_w = lowest_p2(-(-n_cols // n_buckets))
    return bucket_w, -(-n_cols // bucket_w)
