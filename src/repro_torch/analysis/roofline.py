"""SpGEMM roofline on one NVIDIA H100 (port of the SpGEMM half of
``repro.analysis.roofline``).

Two ideal-time terms per product::

    compute_s = flops       / peak rate   (FP32_FLOPS by default)
    memory_s  = bytes_moved / HBM_BW

The card's rates are defined here once; ``chip_smoke.py`` and the autotune
DB read them from this module.  The reference's dry-run half (calibrated
XLA totals for TPU meshes, ``analyze``, ``render_markdown``) has no
counterpart here yet.
"""
from __future__ import annotations

#: HBM3 bandwidth, bytes/s (H100 SXM5 80GB HBM3, 700 W, NVIDIA data sheet)
HBM_BW = 3.35e12
#: IEEE fp32 on the CUDA cores, FLOP/s (H100 SXM5 80GB HBM3, 700 W, NVIDIA
#: data sheet); the SpGEMM kernels multiply in fp32 there and use no TF32
FP32_FLOPS = 67e12
#: dense bf16 on the tensor cores, FLOP/s (H100 SXM5 80GB HBM3, 700 W,
#: NVIDIA data sheet); the flash and SSD tensor-core kernels' peak
BF16_FLOPS = 989e12


def spgemm_traffic_bytes(*, n_rows: float, nnz_a: float, flop: float,
                         nnz_c: float, itemsize: int = 4) -> float:
    """Model HBM traffic of one C = A*B numeric phase, in bytes.

    As the paper's Sec. 2 access pattern: A is read once (indices and
    values), every multiply-add reads one B entry (index and value), and C
    is written once (indices and values) with one indptr over the rows.
    The accumulators are taken to stay on chip, so this is a lower bound
    and the roofline fraction an upper bound.
    """
    index_size = 4   # int32 indices whatever the value width
    a_bytes = nnz_a * (index_size + itemsize)
    b_bytes = flop * (index_size + itemsize)
    c_bytes = nnz_c * (index_size + itemsize) + (n_rows + 1) * index_size
    return a_bytes + b_bytes + c_bytes


def spgemm_roofline(flops: float, bytes_moved: float, seconds: float,
                    peak_flops: float = FP32_FLOPS,
                    hbm_bw: float = HBM_BW) -> dict:
    """Place one measured SpGEMM run on the roofline.

    Returns the two ideal-time terms, which one binds (``bound``), the
    achieved fraction of that roof (``roof_fraction``) and the achieved
    rates: the context the autotune DB keeps with every winner.
    """
    compute_s = flops / peak_flops
    memory_s = bytes_moved / hbm_bw
    bound = "memory" if memory_s >= compute_s else "compute"
    ideal_s = max(compute_s, memory_s)
    seconds = max(seconds, 1e-12)
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "bound": bound,
        "roof_fraction": ideal_s / seconds,
        "achieved_gflops": flops / seconds / 1e9,
        "achieved_gbps": bytes_moved / seconds / 1e9,
        "intensity_flop_per_byte": flops / max(bytes_moved, 1.0),
    }
