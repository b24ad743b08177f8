"""Static-capacity CSR for PyTorch (port of ``repro.core.formats``).

The paper (Nagasaka et al. 2018) stores matrices in CSR with exact-size
allocations obtained from a *symbolic* phase.  The port keeps the JAX
package's static-capacity contract so that plans, capacities and kernel
arguments line up one for one: ``indices``/``data`` have a fixed capacity
``cap``, the live prefix length is the scalar ``nnz``, and every padded
tail slot holds ``indices == 0`` / ``data == 0``.

Every builder takes an explicit ``device=``.  With no device given the
tensors go to ``cuda``; with no CUDA present that raises -- nothing falls
back to the CPU on its own.  The tests pass ``device="cpu"``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point puts its tensors on: ``cuda`` unless the
    caller names another one; raises when CUDA is wanted but absent."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def lexsort(keys) -> torch.Tensor:
    """``np.lexsort`` for tensors: the last key is the primary one.

    Successive stable sorts from the least significant key, so equal keys
    keep their input order, exactly as ``jnp.lexsort``.
    """
    order = torch.argsort(keys[0], stable=True)
    for k in keys[1:]:
        order = order[torch.argsort(k[order], stable=True)]
    return order


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
        out.index_put_((self.row_ids().long(), self.indices.long()), v,
                       accumulate=True)
        return out

    def sort_rows(self) -> "CSR":
        """Sort column ids within each row (the optional epilogue, whose
        cost is Eq. 2's ``sum nnz(c_i*) log nnz(c_i*)`` term)."""
        rows = torch.where(self.valid_mask(), self.row_ids(),
                           torch.full((), self.n_rows, dtype=torch.int32,
                                      device=self.device))
        order = lexsort((self.indices, rows))
        return CSR(self.indptr, self.indices[order], self.data[order],
                   self.nnz, self.shape, sorted_cols=True)


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
