"""Hand-written CUDA SpMM kernel (CSR times dense) and its wrapper.

``csrc/spmm.cu`` replaces the Pallas kernel ``spmm_call`` of
``repro/kernels/spmm/kernel.py``; its header gives the design.  A
classifying kernel (which replaces no TPU kernel) lists the rows by live
length on the device in ``ref.N_CLASSES`` power-of-two classes: rows of at
most 256 nonzeros take a warp each, longer rows a whole block each.  Then
one persistent launch takes the block rows first, longest class first
(four producer warps bring the X rows into a ring in shared memory -- by
bulk copies or through registers as the shape allows -- and consumer warps
over k add in slot order), then the warp rows, longest class first.
Nothing is read back to the host: the grid is the card's resident blocks,
and blocks and warps pop rows with atomic counters.  The kernels are built
like the others (:mod:`repro_torch.kernels._build`): ``nvcc`` for
``sm_90a`` at first use, a plain C interface, ``ctypes``.

:func:`spmm_call` takes the kernel's arguments and, optionally, the row
lists (:func:`classify`; ``ops.spmm_kernel`` memoizes them on the CSR).
On CPU tensors it runs the plain version of ``ref.py``; on CUDA tensors it
launches the kernels or raises -- a build or launch failure is never
answered with the plain version.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import torch

from .. import _build
from . import ref

#: Launch counters: ``spmm`` gains one where the wrapper launches the SpMM
#: kernel, ``classify`` where it launches the classifying kernel,
#: ``plain`` where it runs the plain version.
KERNEL_CALLS = {"spmm": 0, "classify": 0, "plain": 0}

#: How the SpMM launches bring long rows' X rows into shared memory, one
#: count a launch, picked from the shape and X's address before the launch:
#: ``bulk`` (``cp.async.bulk``, 1-D TMA) where X and its rows are 16-byte
#: aligned, else ``register`` (2-byte loads into registers, then shared
#: stores).
COPY_PATHS = {"bulk": 0, "register": 0}

#: X's dtypes the kernel takes, with their code in the C interface.
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: the length classes' names, by their upper bound in live nonzeros; the
#: first four take a warp a row, the others a block
CLASS_NAMES = tuple(f"<={b}" for b in ref.CLASS_BOUNDS) \
    + (f">{ref.CLASS_BOUNDS[-1]}",)

SOURCE = Path(__file__).parent / "csrc" / "spmm.cu"
_P = ctypes.c_void_p
_FUNCTIONS = {
    "spmm_launch": [ctypes.c_int] * 7 + [ctypes.c_longlong] + [_P] * 10,
    "spmm_classify": [ctypes.c_int] * 2 + [ctypes.c_longlong] + [_P] * 5,
    "spmm_shape": [ctypes.c_int] * 2 + [_P],
}
_lib = None


class RowClasses(NamedTuple):
    """The classifying kernel's output, on the card: ``counts``
    ``(N_CLASSES,) int32`` rows per class, ``lists`` the row ids, each
    class's at the sum of the earlier classes' rooms
    (``ref.class_rooms``)."""
    counts: torch.Tensor
    lists: torch.Tensor


def build() -> dict:
    """Compile (if this source was not built yet) and load the library;
    returns :func:`repro_torch.kernels._build.load`'s record."""
    global _lib
    info = _build.load(SOURCE, _FUNCTIONS)
    _lib = info["lib"]
    return info


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def vector_width(k: int, itemsize: int, ptr: int) -> int:
    """X elements a lane loads at once on a short row: the least power of
    two with 32 of them covering k, at most 16 bytes, halved until it
    divides k and X's address is aligned to it."""
    vw = 1
    while 32 * vw < k and 2 * vw * itemsize <= 16:
        vw *= 2
    while vw > 1 and (k % vw or ptr % (vw * itemsize)):
        vw //= 2
    return vw


def bulk_copies(k: int, itemsize: int, ptr: int) -> bool:
    """Whether long rows' X rows reach shared memory by bulk copies (X's
    address and its rows 16-byte aligned), else through registers."""
    return (k * itemsize) % 16 == 0 and ptr % 16 == 0


def launch_shape(dtype: torch.dtype = torch.float32, vw: int = 1) -> dict:
    """The SpMM kernel's launch shape on the current card (builds the
    library): threads and dynamic shared memory a block, resident blocks an
    SM, SMs, short rows a warp pops at once, the long-row threshold, ring
    stages and bytes a stage."""
    build()
    out = (ctypes.c_int * 8)()
    err = _lib.spmm_shape(DTYPES[dtype], vw, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"spmm shape query failed: CUDA error {err}")
    keys = ("threads", "smem_bytes", "blocks_per_sm", "sms", "chunk_rows",
            "long_row", "stages", "stage_bytes")
    return dict(zip(keys, out))


def _check_shapes(indptr, indices, data, x, nnz) -> None:
    if indptr.dim() != 1 or indptr.shape[0] < 1:
        raise ValueError(f"indptr must be (m + 1,), got {tuple(indptr.shape)}")
    if indices.dim() != 1 or data.shape != indices.shape:
        raise ValueError(f"indices and data must be (cap,) alike, got "
                         f"{tuple(indices.shape)} and {tuple(data.shape)}")
    if x.dim() != 2:
        raise ValueError(f"x must be (n, k), got {tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise ValueError(f"x must be float32, bfloat16 or float16, got "
                         f"{x.dtype}")
    if nnz.dim() != 0:
        raise ValueError(f"nnz must be a 0-dim tensor, got "
                         f"{tuple(nnz.shape)}")


def classify(indptr, nnz, cap: int) -> RowClasses:
    """The classifying kernel on the card: the rows of a CSR with row
    pointer ``indptr``, ``cap`` slots and live length ``nnz`` (0-dim int32)
    listed by live length (``ref.row_classes_plain``'s classes, each list
    in no order)."""
    dev = indptr.device
    _build.check_tensor("indptr", indptr, torch.int32, dev)
    _build.check_tensor("nnz", nnz, torch.int32, dev)
    m = indptr.shape[0] - 1
    build()
    counts = torch.zeros(ref.N_CLASSES, dtype=torch.int32, device=dev)
    lists = torch.empty(sum(ref.class_rooms(m, cap)), dtype=torch.int32,
                        device=dev)
    err = _lib.spmm_classify(m, cap, lists.shape[0], nnz.data_ptr(),
                             indptr.data_ptr(), counts.data_ptr(),
                             lists.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"spmm classify launch failed: CUDA error {err}")
    KERNEL_CALLS["classify"] += 1
    return RowClasses(counts, lists)


def row_classes(indptr, nnz, cap: int):
    """``(counts (N_CLASSES,) int32, rows)``: ``rows[c]`` class c's row ids
    -- on a card the classifying kernel's lists (in no order), read back;
    on the CPU ``ref.row_classes_plain`` (ascending)."""
    if indptr.device.type == "cpu":
        return ref.row_classes_plain(indptr, nnz, cap)
    cls = classify(indptr, nnz, cap)
    counts = cls.counts.tolist()
    rows, off = [], 0
    for c, room in enumerate(ref.class_rooms(indptr.shape[0] - 1, cap)):
        rows.append(cls.lists[off:off + min(counts[c], room)])
        off += room
    return torch.tensor([r.shape[0] for r in rows], dtype=torch.int32,
                        device=indptr.device), rows


def spmm_call(indptr, indices, data, x, nnz,
              classes: RowClasses | None = None) -> torch.Tensor:
    """``y (m, k)`` in ``x``'s dtype: ``y[i] = sum_j data[j] * x[indices[j]]``
    over row ``i``'s slots below ``min(nnz, cap)``, in float32 in slot
    order; ``nnz`` is a 0-dim int32 tensor (the CSR's live length).

    ``classes``: :func:`classify`'s lists for this ``indptr``, ``nnz`` and
    capacity (the SpMM launch alone); without them a card call classifies
    first.  Ignored on the CPU.
    """
    _check_shapes(indptr, indices, data, x, nnz)
    dev = x.device
    if dev.type == "cpu":
        for t in (indptr, indices, data, nnz):
            if t.device != dev:
                raise ValueError(f"operands on {t.device} and {dev}: the "
                                 f"SpMM kernel takes tensors on one device")
        KERNEL_CALLS["plain"] += 1
        return ref.spmm_plain(indptr, indices, data, x, nnz)
    index = x.get_device()
    for name, t, dtype in (("indptr", indptr, torch.int32),
                           ("indices", indices, torch.int32),
                           ("nnz", nnz, torch.int32),
                           ("data", data, torch.float32),
                           ("x", x, x.dtype)):
        _build.check_tensor(name, t, dtype, index)
    m = indptr.shape[0] - 1
    n, k = x.shape
    cap = indices.shape[0]
    if m == 0 or n == 0 or k == 0 or cap == 0:
        return torch.zeros((m, k), dtype=x.dtype, device=dev)
    build()
    if classes is None:
        classes = classify(indptr, nnz, cap)
    _build.check_tensor("classes.counts", classes.counts, torch.int32,
                        index)
    _build.check_tensor("classes.lists", classes.lists, torch.int32, index)
    if classes.counts.shape != (ref.N_CLASSES,):
        raise ValueError(f"classes.counts must be ({ref.N_CLASSES},), got "
                         f"{tuple(classes.counts.shape)}")
    itemsize = x.element_size()
    vw = vector_width(k, itemsize, x.data_ptr())
    bulk = bulk_copies(k, itemsize, x.data_ptr())
    y = torch.empty((m, k), dtype=x.dtype, device=dev)
    pops = torch.empty(2, dtype=torch.int32, device=dev)
    err = _lib.spmm_launch(
        DTYPES[x.dtype], vw, int(bulk), m, n, k, cap, classes.lists.shape[0],
        nnz.data_ptr(), indptr.data_ptr(), indices.data_ptr(),
        data.data_ptr(), x.data_ptr(), y.data_ptr(), classes.counts.data_ptr(),
        classes.lists.data_ptr(), pops.data_ptr(),
        torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"spmm launch failed: CUDA error {err}")
    KERNEL_CALLS["spmm"] += 1
    COPY_PATHS["bulk" if bulk else "register"] += 1
    return y
