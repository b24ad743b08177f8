"""Static-capacity CSR and block CSR for PyTorch (port of
``repro.core.formats``).

The paper (Nagasaka et al. 2018) stores matrices in CSR with exact-size
allocations obtained from a *symbolic* phase.  The port keeps the JAX
package's static-capacity contract so that plans, capacities and kernel
arguments line up one for one: ``indices``/``data`` have a fixed capacity
``cap``, the live prefix length is the scalar ``nnz``, and every padded
tail slot holds ``indices == 0`` / ``data == 0``.

Every builder takes an explicit ``device=``.  With no device given the
tensors go to ``cuda``; with no CUDA present that raises -- nothing falls
back to the CPU on its own.  The tests pass ``device="cpu"``.

:class:`BCSR` keeps the same contract over ``(bm, bn)`` tiles at a fixed
block capacity ``bcap``; :func:`csr_to_bcsr` and :func:`bcsr_to_csr`
convert sparsely on the operand's device, where the reference converts
on the host with numpy.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point puts its tensors on: ``cuda`` unless the
    caller names another one; raises when CUDA is wanted but absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run on the CPU")
    return device


def lexsort(keys) -> torch.Tensor:
    """``np.lexsort`` for tensors: the last key is the primary one.

    Successive stable sorts from the least significant key, so equal keys
    keep their input order, exactly as ``jnp.lexsort``.
    """
    order = torch.argsort(keys[0], stable=True)
    for k in keys[1:]:
        order = order[torch.argsort(k[order], stable=True)]
    return order


def memo_on_versions(obj, name: str, tensors, compute):
    """``compute()``, memoized on the frozen instance ``obj`` under
    ``name`` and keyed on the version counters of ``tensors``, the arrays
    ``compute`` reads: a write in place bumps a counter, so the value is
    computed again.  Reading a counter is host work and needs no sync.
    An inference tensor has no counter: its part of the key is fixed, so
    its value is memoized once per instance and a write in place to it is
    not seen."""
    stamp = tuple(None if t.is_inference() else t._version for t in tensors)
    hit = obj.__dict__.get(name)
    if hit is not None and hit[0] == stamp:
        return hit[1]
    value = compute()
    # ``name`` is a caller's underscore-prefixed memo slot, not a field
    object.__setattr__(  # verify: allow(frozen-plan-immutability) -- memo
        obj, name, (stamp, value))
    return value


@dataclass(frozen=True)
class CSR:
    """Compressed sparse rows with static capacity.

    Attributes:
      indptr:  ``(n_rows + 1,) int32`` row pointer array.
      indices: ``(cap,) int32`` column ids, row-major; padded with 0.
      data:    ``(cap,)`` values; padded with 0.
      nnz:     0-dim int32 tensor, the live prefix length.
      shape:   static ``(n_rows, n_cols)``.
      sorted_cols: are column ids sorted within each row?  Part of the type,
        like Table 1's "Sortedness" column (the paper's C8 finding).

    The tensors may be written in place.  What the package memoizes on an
    instance (its structure digest, its host ``nnz``) is keyed on the
    version counters of ``indptr``, ``indices`` and ``nnz``
    (:func:`memo_on_versions`), so a write in place is seen and the next
    ``plan_*`` call plans again.  Inference tensors (made under
    ``torch.inference_mode()``) have no version counter: what is memoized
    on them is computed once per instance, and a write in place to them is
    not seen, so make a new instance after one.
    """
    indptr: torch.Tensor
    indices: torch.Tensor
    data: torch.Tensor
    nnz: torch.Tensor
    shape: Tuple[int, int]
    sorted_cols: bool = True

    @property
    def cap(self) -> int:
        return self.indices.shape[0]

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.indices.device

    # ---- construction ----------------------------------------------------
    @staticmethod
    def from_dense(x: torch.Tensor, cap: int | None = None) -> "CSR":
        """Build a sorted CSR from a dense matrix on its own device."""
        m, n = x.shape
        if cap is None:
            cap = m * n
        flat = x.reshape(-1)
        pos = torch.nonzero(flat != 0).reshape(-1)
        nnz = int(pos.shape[0])         # like the reference: not clipped
        pos = pos[:cap]
        live = int(pos.shape[0])
        cols = torch.zeros(cap, dtype=torch.int32, device=x.device)
        vals = torch.zeros(cap, dtype=x.dtype, device=x.device)
        cols[:live] = (pos % n).to(torch.int32)
        vals[:live] = flat[pos]
        counts = (x != 0).sum(dim=1)
        indptr = prefix_sum(counts).to(torch.int32)
        return CSR(indptr, cols, vals, _scalar(nnz, x.device), (m, n), True)

    @staticmethod
    def from_numpy_coo(rows, cols, vals, shape: Tuple[int, int],
                       cap: int | None = None, sum_duplicates: bool = True,
                       device=None) -> "CSR":
        """Host-side builder (numpy), row-major; duplicates summed in
        float64 as the reference does."""
        m, n = shape
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        vals = np.asarray(vals)
        if sum_duplicates and rows.size:
            key = rows * n + cols
            uniq, inv = np.unique(key, return_inverse=True)
            acc = np.zeros(uniq.shape[0], dtype=np.float64)
            np.add.at(acc, inv, vals.astype(np.float64))
            rows, cols = uniq // n, uniq % n
            vals = acc.astype(vals.dtype)
        else:
            order = np.lexsort((cols, rows))
            rows, cols, vals = rows[order], cols[order], vals[order]
        nnz = int(rows.size)
        if cap is None:
            cap = max(nnz, 1)
        if nnz > cap:
            raise ValueError(f"nnz {nnz} exceeds capacity {cap}")
        indices = np.zeros(cap, np.int32)
        data = np.zeros(cap, vals.dtype if vals.size else np.float32)
        indices[:nnz] = cols
        data[:nnz] = vals
        counts = np.bincount(rows, minlength=m)
        indptr = np.zeros(m + 1, np.int32)
        np.cumsum(counts, out=indptr[1:])
        return CSR.from_numpy(indptr, indices, data, nnz, (m, n), True,
                              device=device)

    @staticmethod
    def from_numpy(indptr, indices, data, nnz, shape, sorted_cols=True,
                   device=None) -> "CSR":
        """Lossless builder from host arrays -- the bridge the tests use to
        hand one operand to both this package and the JAX reference."""
        dev = resolve_device(device)
        return CSR(
            torch.from_numpy(np.array(indptr, np.int32)).to(dev),
            torch.from_numpy(np.array(indices, np.int32)).to(dev),
            torch.from_numpy(np.array(data)).to(dev),
            _scalar(int(np.asarray(nnz)), dev), tuple(int(s) for s in shape),
            bool(sorted_cols))

    def to_numpy(self):
        """``(indptr, indices, data, nnz, shape, sorted_cols)`` on the host."""
        return (self.indptr.cpu().numpy(), self.indices.cpu().numpy(),
                self.data.cpu().numpy(), int(self.nnz), self.shape,
                self.sorted_cols)

    # ---- views ------------------------------------------------------------
    def valid_mask(self) -> torch.Tensor:
        return torch.arange(self.cap, device=self.device) < self.nnz

    def row_ids(self) -> torch.Tensor:
        """Row id of every slot ``(cap,)``; padded slots clamp to the last
        row."""
        e = torch.arange(self.cap, dtype=torch.int32, device=self.device)
        r = torch.searchsorted(self.indptr, e, right=True) - 1
        return r.clamp(0, max(self.n_rows - 1, 0)).to(torch.int32)

    def row_nnz(self) -> torch.Tensor:
        return self.indptr[1:] - self.indptr[:-1]

    def contains(self, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
        """Structural membership of ``(rows[i], cols[i])``; needs
        ``sorted_cols`` (one binary search per query on row-major keys)."""
        key = rows.to(torch.int64) * self.n_cols + cols.to(torch.int64)
        return sorted_keys_contain(csr_sorted_keys(self), key)

    def to_dense(self) -> torch.Tensor:
        """Dense view (tests only)."""
        out = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        v = torch.where(self.valid_mask(), self.data,
                        torch.zeros((), dtype=self.dtype, device=self.device))
        # out of place: under torch.func.vmap the values may be batched
        # while the zeros are not
        return out.index_put((self.row_ids().long(), self.indices.long()), v,
                             accumulate=True)

    def sort_rows(self) -> "CSR":
        """Sort column ids within each row (the optional epilogue, whose
        cost is Eq. 2's ``sum nnz(c_i*) log nnz(c_i*)`` term)."""
        rows = torch.where(self.valid_mask(), self.row_ids(),
                           torch.full((), self.n_rows, dtype=torch.int32,
                                      device=self.device))
        order = lexsort((self.indices, rows))
        return CSR(self.indptr, self.indices[order], self.data[order],
                   self.nnz, self.shape, sorted_cols=True)

    def with_unsorted_flag(self) -> "CSR":
        """Same arrays, ``sorted_cols=False``: the metadata downgrade that
        asks for select-order handling (routes a product away from heap)."""
        return dataclasses.replace(self, sorted_cols=False)


def csr_transpose(a: CSR, cap: int | None = None, return_perm: bool = False):
    """``A^T`` as a sorted row-major CSR of shape ``(n_cols, n_rows)``, on
    the operand's device (the reference transposes on the host).

    A stable sort on (col, row) -- within each row of ``A^T`` the original
    row ids come out ascending, so the result is ``sorted_cols`` whatever
    the order of ``a``'s rows -- then a ``bincount`` and ``cumsum`` of the
    columns for the row pointer.  With ``return_perm=True`` also returns
    the int32 gather ``perm`` of shape ``(cap,)`` with ``A^T.data ==
    A.data[perm]`` over the live prefix; the padded tail gathers slot 0
    and must be masked by the caller.  ``perm`` depends only on A's
    pattern, which lets ``core.chain.plan_gram`` freeze it and re-gather
    values alone on a repeat execute.  Arrays are bitwise the
    reference's.
    """
    m, n = a.shape
    nnz = int(a.nnz)
    dev = a.device
    rows = _live_rows(a.indptr, m, nnz)
    cols = a.indices[:nnz].long()
    vals = a.data[:nnz]
    perm = lexsort((rows, cols))
    if cap is None:
        cap = max(a.cap, 1)
    if nnz > cap:
        raise ValueError(f"transpose nnz {nnz} exceeds capacity {cap}")
    indices = torch.zeros(cap, dtype=torch.int32, device=dev)
    data = torch.zeros(cap, dtype=vals.dtype if nnz else torch.float32,
                       device=dev)
    indices[:nnz] = rows[perm].to(torch.int32)
    data[:nnz] = vals[perm]
    indptr = prefix_sum(torch.bincount(cols, minlength=n)[:n])
    t = CSR(indptr.to(torch.int32), indices, data, _scalar(nnz, dev), (n, m),
            sorted_cols=True)
    if not return_perm:
        return t
    perm_full = torch.zeros(cap, dtype=torch.int32, device=dev)
    perm_full[:nnz] = perm.to(torch.int32)
    return t, perm_full


def _scalar(v: int, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32, device=device)


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Exclusive-then-inclusive prefix sum, ``(n+1,)``: ``ps[0] = 0``."""
    return torch.cat([torch.zeros(1, dtype=x.dtype, device=x.device),
                      torch.cumsum(x, 0, dtype=x.dtype)])


#: sentinel key for padded slots of :func:`csr_sorted_keys`.
_KEY_SENTINEL = 2**63 - 1


def csr_sorted_keys(a: CSR) -> torch.Tensor:
    """Globally sorted int64 ``row * n_cols + col`` keys of a row-major
    CSR, sentinel-padded."""
    if not a.sorted_cols:
        raise ValueError("sorted keys need sorted_cols (call sort_rows first)")
    key = a.row_ids().to(torch.int64) * a.n_cols + a.indices.to(torch.int64)
    return torch.where(a.valid_mask(), key,
                       torch.full((), _KEY_SENTINEL, dtype=torch.int64,
                                  device=a.device))


def sorted_keys_contain(keys: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Membership of ``key`` (any shape) in sorted sentinel-padded keys."""
    cap = keys.shape[0]
    pos = torch.searchsorted(keys, key.contiguous(), right=False)
    hit = keys[pos.clamp(0, cap - 1)] == key
    return hit & (pos < cap)


@dataclass(frozen=True)
class BCSR:
    """Block CSR: dense ``(bm, bn)`` tiles in a CSR layout over the block
    grid (port of ``repro.core.formats.BCSR``).

    The unit of sparsity is a tile, so a "row" of Gustavson's algorithm
    becomes a *block row*, and the accumulator hashes block-column ids
    while the kernel forms ``(bm x bk) @ (bk x bn)`` tile products.

    Attributes:
      indptr:  ``(n_brows + 1,) int32`` block-row pointer.
      indices: ``(bcap,) int32`` block-column ids; padded with 0.
      blocks:  ``(bcap, bm, bn)`` tiles; padded with zero tiles.
      nnzb:    0-dim int32 tensor, the live prefix length.
      shape:   static logical ``(n_rows, n_cols)``; a ragged edge lives in a
        partial last block row/column (storage padding, cropped by
        :meth:`to_dense`).
      block:   static ``(bm, bn)``.

    As for :class:`CSR`, a write in place to ``indptr``, ``indices`` or
    ``nnzb`` is seen: the structure digest memoized on the instance is
    keyed on their version counters, and ``plan_bcsr`` plans again (not
    for inference tensors, which have no counter).
    """
    indptr: torch.Tensor
    indices: torch.Tensor
    blocks: torch.Tensor
    nnzb: torch.Tensor
    shape: Tuple[int, int]
    block: Tuple[int, int]

    @property
    def bcap(self) -> int:
        return self.indices.shape[0]

    @property
    def grid(self) -> Tuple[int, int]:
        """Block grid, ceil-divided."""
        bm, bn = self.block
        return (-(-self.shape[0] // bm), -(-self.shape[1] // bn))

    @property
    def dtype(self):
        return self.blocks.dtype

    @property
    def device(self) -> torch.device:
        return self.indices.device

    @staticmethod
    def from_dense(x: torch.Tensor, block: Tuple[int, int],
                   bcap: int | None = None) -> "BCSR":
        """Tile a dense matrix on its own device; a tile is stored when any
        of its cells is nonzero.  ``bcap`` defaults to the exact count."""
        m, n = x.shape
        bm, bn = block
        gm, gn = -(-m // bm), -(-n // bn)
        pm, pn = gm * bm - m, gn * bn - n
        if pm or pn:
            x = torch.nn.functional.pad(x, (0, pn, 0, pm))
        tiles = x.reshape(gm, bm, gn, bn).permute(0, 2, 1, 3)
        occ = (tiles != 0).reshape(gm * gn, bm * bn).any(dim=1)
        nnzb = int(occ.sum())
        if bcap is None:
            bcap = max(nnzb, 1)
        order = torch.argsort((~occ).to(torch.int8), stable=True)[:bcap]
        valid = torch.arange(bcap, device=x.device) < nnzb
        bcols = torch.where(valid, (order % max(gn, 1)).to(torch.int32), 0)
        blocks = tiles.reshape(gm * gn, bm, bn)[order]
        blocks = torch.where(valid[:, None, None], blocks, 0).to(x.dtype)
        counts = occ.reshape(gm, gn).sum(dim=1)
        return BCSR(prefix_sum(counts).to(torch.int32),
                    bcols.to(torch.int32), blocks, _scalar(nnzb, x.device),
                    (m, n), (bm, bn))

    @staticmethod
    def from_numpy(indptr, indices, blocks, nnzb, shape, block,
                   device=None) -> "BCSR":
        """Lossless builder from host arrays (the bridge to and from
        ``repro.core.BCSR`` that the tests use)."""
        dev = resolve_device(device)
        return BCSR(
            torch.from_numpy(np.array(indptr, np.int32)).to(dev),
            torch.from_numpy(np.array(indices, np.int32)).to(dev),
            torch.from_numpy(np.array(blocks)).to(dev),
            _scalar(int(np.asarray(nnzb)), dev),
            tuple(int(s) for s in shape), tuple(int(s) for s in block))

    def to_numpy(self):
        """``(indptr, indices, blocks, nnzb, shape, block)`` on the host."""
        return (self.indptr.cpu().numpy(), self.indices.cpu().numpy(),
                self.blocks.cpu().numpy(), int(self.nnzb), self.shape,
                self.block)

    def valid_mask(self) -> torch.Tensor:
        return torch.arange(self.bcap, device=self.device) < self.nnzb

    def brow_ids(self) -> torch.Tensor:
        """Block-row id of every slot ``(bcap,)``; padded slots clamp to
        the last block row."""
        e = torch.arange(self.bcap, dtype=torch.int32, device=self.device)
        r = torch.searchsorted(self.indptr, e, right=True) - 1
        return r.clamp(0, max(self.grid[0] - 1, 0)).to(torch.int32)

    def to_dense(self) -> torch.Tensor:
        """Dense view, cropped to the logical shape (tests only)."""
        gm, gn = self.grid
        bm, bn = self.block
        dense = torch.zeros((gm, gn, bm, bn), dtype=self.dtype,
                            device=self.device)
        v = torch.where(self.valid_mask()[:, None, None], self.blocks, 0)
        # out of place: under torch.func.vmap the tiles may be batched
        # while the zeros are not
        dense = dense.index_put((self.brow_ids().long(),
                                 self.indices.long()), v.to(self.dtype),
                                accumulate=True)
        dense = dense.permute(0, 2, 1, 3).reshape(gm * bm, gn * bn)
        return dense[:self.shape[0], :self.shape[1]]


def _live_rows(indptr: torch.Tensor, n_rows: int, live: int) -> torch.Tensor:
    """Row id of each of the first ``live`` slots of a row pointer."""
    ip = indptr.long()
    rows = torch.repeat_interleave(
        torch.arange(n_rows, device=ip.device), ip.diff(),
        output_size=int(ip[-1]))
    return rows[:live]


def csr_to_bcsr(a: CSR, block: Tuple[int, int],
                bcap: int | None = None) -> BCSR:
    """Re-tile a scalar CSR into block CSR on the CSR's device.

    A sparse pass (no dense staging): each entry's block key
    ``(row // bm) * gn + col // bn``, one sorted ``torch.unique`` for the
    block ids and each entry's tile, and a scatter of the values into the
    tiles.  Block columns come out sorted within block rows; unsorted input
    rows give the same result.  ``bcap`` pins the capacity (default: the
    exact block count) and raises ``ValueError`` when the blocks do not
    fit.  Ragged shapes land in a ceil-divided grid.
    """
    bm, bn = block
    m, n = a.shape
    gm, gn = -(-m // bm), -(-n // bn)
    nnz = int(a.nnz)
    dev = a.device
    rows = _live_rows(a.indptr, m, nnz)
    cols = a.indices[:nnz].long()
    vals = a.data[:nnz]
    key = (rows // bm) * gn + cols // bn
    uniq, inv = torch.unique(key, sorted=True, return_inverse=True)
    nnzb = int(uniq.shape[0])
    if bcap is None:
        bcap = max(nnzb, 1)
    if nnzb > bcap:
        raise ValueError(f"block nnz {nnzb} exceeds capacity {bcap}")
    blocks = torch.zeros((bcap, bm, bn),
                         dtype=vals.dtype if nnz else torch.float32,
                         device=dev)
    if nnz:
        blocks[inv, rows % bm, cols % bn] = vals
    bcols = torch.zeros(bcap, dtype=torch.int32, device=dev)
    bcols[:nnzb] = (uniq % gn).to(torch.int32)
    counts = torch.bincount(uniq // gn, minlength=gm)[:gm]
    return BCSR(prefix_sum(counts).to(torch.int32), bcols, blocks,
                _scalar(nnzb, dev), (m, n), (bm, bn))


def bcsr_to_csr(a: BCSR, cap: int | None = None, prune: bool = True) -> CSR:
    """Flatten a block CSR to scalar CSR, sorted row-major, on its device.

    Every in-tile cell of a stored block is emitted except cells past the
    logical shape (ragged tile padding, always cropped) and, with
    ``prune`` (the default), cells that hold zero -- so
    ``bcsr_to_csr(csr_to_bcsr(a, block))`` keeps ``a``'s nnz.  With
    ``prune=False`` every stored cell inside the shape becomes an entry.

    The block columns are sorted within each block row (a product's come
    out unsorted).  Each scalar row of a block row then spans a known run
    of the row-major order, so the tiles are scattered straight to their
    places, and one prefix sum of the keep mask gives the row pointer.
    Each (block row, block column) is stored once, so no two cells meet
    and nothing is summed.
    """
    bm, bn = a.block
    m, n = a.shape
    gm, gn = a.grid
    nnzb = int(a.nnzb)
    dev = a.device
    tile = bm * bn
    total = nnzb * tile
    ip = a.indptr.long()
    brows = _live_rows(a.indptr, gm, nnzb)
    bcols = a.indices[:nnzb].long()
    perm = torch.sort(brows * gn + bcols, stable=True)[1]
    # first cell of scalar row r * bm + ii: block row r's strip starts at
    # ip[r] * tile, and each of its rows is (its block count) * bn wide
    ii = torch.arange(bm, device=dev)
    row_start = (ip[:-1] * tile)[:, None] \
        + ii[None, :] * (ip.diff() * bn)[:, None]
    q = torch.arange(nnzb, device=dev) - ip[brows]
    jj = torch.arange(bn, device=dev)
    pos = ((row_start[brows] + (q * bn)[:, None])[:, :, None]
           + jj).reshape(-1)
    vals = torch.empty(total, dtype=a.dtype, device=dev)
    vals[pos] = a.blocks[:nnzb][perm].reshape(-1)
    cols = torch.empty(total, dtype=torch.int32, device=dev)
    cols[pos] = ((bcols[perm] * bn)[:, None, None] + jj).expand(
        nnzb, bm, bn).reshape(-1).to(torch.int32)
    keep = vals != 0 if prune else torch.ones(total, dtype=torch.bool,
                                              device=dev)
    if gn * bn > n:
        keep &= cols < n
    bounds = torch.cat([row_start.reshape(-1),
                        torch.full((1,), total, device=dev)])[:m + 1]
    if gm * bm > m:                 # rows past m: ragged tile padding
        keep[int(bounds[m]):] = False
    kept = torch.zeros(total + 1, dtype=torch.long, device=dev)
    torch.cumsum(keep, 0, out=kept[1:])     # kept cells before each cell
    indptr = kept[bounds]
    live = keep.nonzero().squeeze(1)
    nnz = int(live.shape[0])
    if cap is None:
        cap = max(nnz, 1)
    if nnz > cap:
        raise ValueError(f"nnz {nnz} exceeds capacity {cap}")
    indices = torch.zeros(cap, dtype=torch.int32, device=dev)
    data = torch.zeros(cap, dtype=a.dtype if nnz else torch.float32,
                       device=dev)
    indices[:nnz] = cols[live]
    data[:nnz] = vals[live]
    return CSR(indptr.to(torch.int32), indices, data, _scalar(nnz, dev),
               (m, n), True)
