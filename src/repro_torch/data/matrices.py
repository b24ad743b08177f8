"""Synthetic proxy suite for the paper's Table 2 (26 SuiteSparse matrices);
port of ``repro.data.matrices``.

SuiteSparse is not available offline, so each matrix is replaced by a
synthetic proxy matched on the statistics the paper's evaluation keys on:
dimension ``n``, ``nnz(A)``, ``flop(A^2)`` and ``nnz(A^2)`` -- hence the same
compression ratio CR = flop/nnz(A^2), the x-axis of Figs. 14/17 and the
decision variable of Table 4.  Profiles are scaled down by
``SCALE_DIVISOR``; CR and edge factor are scale-free.

Each proxy mixes three pattern families to hit the target flop/nnz ratios:
  * banded/stencil rows (regular FEM-like: cant, consph, pwtk, ...)
  * power-law rows (graphs: wb-edu, webbase, patents, ...)
  * uniform random rows (ER-like: mc2depi, majorbasis, ...)

The draws are the reference's, in its order, on the host with numpy; the
CSR goes to ``device=`` (``cuda`` unless the caller names another).  One
difference: the reference seeds a proxy with ``hash(profile.name)``, which
changes with ``PYTHONHASHSEED``; this module uses a content digest
(:func:`name_digest`), so a proxy is the same in every process.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np

from repro_torch.core.formats import CSR

#: (name, n, nnz, flop(A^2), nnz(A^2)) in raw counts -- Table 2 (millions).
TABLE2 = [
    ("2cubes_sphere",   101_492,  1_647_264,   27_450_606,   8_974_526),
    ("cage12",          130_228,  2_032_536,   34_610_826,  15_231_874),
    ("cage15",        5_154_859, 99_199_551, 2_078_631_615, 929_023_247),
    ("cant",             62_451,  4_007_383,  269_486_473,  17_440_029),
    ("conf5_4-8x8-05",   49_152,  1_916_928,   74_760_192,  10_911_744),
    ("consph",           83_334,  6_010_480,  463_845_030,  26_539_736),
    ("cop20k_A",        121_192,  2_624_331,   79_883_385,  18_705_069),
    ("delaunay_n24", 16_777_216, 100_663_202,  633_914_372, 347_322_258),
    ("filter3D",        106_437,  2_707_179,   85_957_185,  20_161_619),
    ("hood",            220_542, 10_768_436,  562_028_117,  34_242_181),
    ("m133-b3",         200_200,    800_800,    3_203_200,   3_182_751),
    ("mac_econ_fwd500", 206_500,  1_273_389,    7_556_897,   6_704_899),
    ("majorbasis",      160_000,  1_750_416,   19_178_064,   8_243_392),
    ("mario002",        389_874,  2_097_566,   12_829_364,   6_449_598),
    ("mc2depi",         525_825,  2_100_225,    8_391_680,   5_245_952),
    ("mono_500Hz",      169_410,  5_036_288,  204_030_968,  41_377_964),
    ("offshore",        259_789,  4_242_673,   71_342_515,  23_356_245),
    ("patents_main",    240_547,    560_943,    2_604_790,   2_281_308),
    ("pdb1HYS",          36_417,  4_344_765,  555_322_659,  19_594_581),
    ("poisson3Da",       13_514,    352_762,   11_770_796,   2_957_530),
    ("pwtk",            217_918, 11_634_424,  626_054_402,  32_772_236),
    ("rma10",            46_835,  2_374_001,  156_480_259,   7_900_917),
    ("scircuit",        170_998,    958_936,    8_676_313,   5_222_525),
    ("shipsec1",        140_874,  7_813_404,  450_639_288,  24_086_412),
    ("wb-edu",        9_845_725, 57_156_537, 1_559_579_990, 630_077_764),
    ("webbase-1M",    1_000_005,  3_105_536,   69_524_195,  51_111_996),
]

#: Default downscale factor of the proxies.
SCALE_DIVISOR = 256


@dataclass(frozen=True)
class MatrixProfile:
    name: str
    n: int
    nnz: int
    flop: int          # flop(A^2) of the original
    nnz_c: int         # nnz(A^2) of the original

    @property
    def edge_factor(self) -> float:
        return self.nnz / self.n

    @property
    def compression_ratio(self) -> float:
        return self.flop / self.nnz_c


def profiles() -> list[MatrixProfile]:
    return [MatrixProfile(*row) for row in TABLE2]


def name_digest(name: str) -> int:
    """A proxy's seed offset: the CRC-32 of its name mod 2^16, the same in
    every process (the reference's ``hash(name)`` is salted per process)."""
    return zlib.crc32(name.encode()) % (1 << 16)


def _power_law_degrees(rng, n, mean_deg, skew=2.0):
    raw = rng.pareto(skew, n) + 1.0
    deg = np.maximum(1, (raw / raw.mean() * mean_deg).astype(np.int64))
    return np.minimum(deg, n - 1)


def synth_proxy(profile: MatrixProfile, seed: int = 0,
                divisor: int = SCALE_DIVISOR, cap: int | None = None,
                device=None) -> CSR:
    """Build a proxy with ~n/divisor rows matching edge factor and CR.

    CR = flop/nnz(C) is controlled by the *overlap regularity* of rows:
    banded rows (all neighbors adjacent) maximize index collisions -> high
    CR; scattered power-law rows minimize them -> CR ~ 1.  Each row gets a
    band of width w around a center, w fit from the target CR, plus a
    power-law degree spread for skewed targets.
    """
    rng = np.random.default_rng(seed + name_digest(profile.name))
    n = max(64, profile.n // divisor)
    ef = max(1.0, profile.edge_factor)
    target_cr = profile.compression_ratio
    # banded share: high CR needs clustered columns
    banded_share = float(np.clip((target_cr - 1.0) / max(ef, 1.0), 0.0, 0.95))
    deg = _power_law_degrees(rng, n, ef) if target_cr < 3.0 else \
        np.maximum(1, rng.poisson(ef, n))
    rows_list, cols_list = [], []
    centers = rng.integers(0, n, n)
    for i in range(n):
        d = int(deg[i])
        nb = int(round(d * banded_share))
        band = (centers[i] + np.arange(nb)) % n
        rest = rng.integers(0, n, d - nb)
        cols_i = np.concatenate([band, rest])
        rows_list.append(np.full(cols_i.shape[0], i, np.int64))
        cols_list.append(cols_i.astype(np.int64))
    rows = np.concatenate(rows_list)
    cols = np.concatenate(cols_list)
    vals = rng.uniform(0.5, 1.5, rows.shape[0]).astype(np.float32)
    return CSR.from_numpy_coo(rows, cols, vals, (n, n), cap=cap,
                              device=device)


def suite(divisor: int = SCALE_DIVISOR, seed: int = 0,
          max_matrices: int | None = None, device=None):
    """Yield (profile, CSR) for the proxy suite, in Table 2's order."""
    ps = profiles()
    if max_matrices is not None:
        ps = ps[:max_matrices]
    for p in ps:
        yield p, synth_proxy(p, seed=seed, divisor=divisor, device=device)
