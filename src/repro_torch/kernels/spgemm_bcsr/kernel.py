"""Hand-written CUDA block-row hash SpGEMM kernel over BCSR and its
wrapper.

``csrc/spgemm_bcsr.cu`` replaces the Pallas kernels ``numeric_call`` (with
its scalar and vector probes) and ``batched_numeric_call`` (the same over
a fleet of members) of ``repro/kernels/spgemm_bcsr/kernel.py``; its header
says how the design maps the TPU's sequential grids onto the card.  Every
block row probes a table sized from its own output count; the
single-product kernel runs rows by class (:data:`CLASS_NAMES`): two
classifying kernels, which replace no TPU kernel, list each class's rows
in device memory, longest A-block count first, and one persistent launch
per class that can hold rows runs them -- tables in one block's shared
memory of four sizes, larger ones in device memory.  It is built like the
other kernels (:mod:`repro_torch.kernels._build`): ``nvcc`` for
``sm_90a`` at first use, a plain C interface, ``ctypes``.

:func:`numeric_call` takes the arguments of the reference's compiled
``numeric_call``, and :func:`batched_numeric_call` takes them with a
member axis on any of them; :func:`row_classes` is the classifying
kernels alone.
On CPU tensors they run the plain versions of ``ref.py``; on CUDA tensors
they launch the kernel or raise -- a build or launch failure is never
answered with the plain version.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build
from ..spgemm_hash.kernel import batched_launches
from . import ref

#: Launch counters.  ``numeric``/``numeric_vector`` gain one where the
#: wrapper launches its kernel (one call covers every row), ``plain`` where
#: it runs the plain version, and ``symbolic`` where ``ops.bcsr_inspect``
#: runs a block-level inspection (which launches the hash symbolic kernel,
#: counted by that kernel's own counters).  ``batched_numeric`` /
#: ``batched_numeric_vector`` gain one per CUDA launch of the batched grid
#: (one per bin index that holds rows in any member), ``batched_plain`` one
#: per run of the batched plain version.
KERNEL_CALLS = {"symbolic": 0, "numeric": 0, "numeric_vector": 0,
                "plain": 0, "batched_numeric": 0,
                "batched_numeric_vector": 0, "batched_plain": 0}

#: The single-product kernel's row classes (``ref.CLASS_SMEM``): staged
#: in 30 / 54 / 111 / 225 KB of one block's shared memory, or direct
#: (keys in device memory, tiles summed in place in the output).
CLASS_NAMES = ref.CLASS_NAMES
#: Launches of the single-product kernel's parts, extra to
#: :data:`KERNEL_CALLS` (one ``numeric``/``numeric_vector`` per call stays
#: the proof of path): ``classify`` per run of the classifying kernels,
#: one per class launch under its :data:`CLASS_NAMES` name, ``plain`` per
#: run of :func:`row_classes`' plain version.
CLASS_CALLS = dict.fromkeys(("classify",) + CLASS_NAMES + ("plain",), 0)

#: Largest table (keys + float32 tiles) a batched launch plans to keep in
#: shared memory, in bytes (the batched geometry, :func:`launch_list`).
SMEM_BUDGET = 128 * 1024
#: A block's dynamic shared memory in a batched launch with a workspace
#: (rows that fit run staged, the rest direct): the largest class's.
MAX_SMEM = ref.CLASS_SMEM[-1]
#: Blocks of the direct class, each with a workspace of keys and map.
GLOBAL_BLOCKS = 264
#: The classifying kernels' counts: one per (class, A-block bucket), then
#: each class kernel's pop counter.
_N_COUNTS = len(CLASS_NAMES) * (ref.LEN_BUCKETS + 1)

#: The array arguments of :func:`numeric_call`, in order, and their
#: dimensions.  An argument of :func:`batched_numeric_call` has one more (a
#: leading member axis), or has these and is shared by every member.
ARG_NAMES = ("offsets", "bin_tsize", "indptr_a", "indptr_b", "indptr_c",
             "a_bcol", "a_blk", "b_bcol", "b_blk")
ARG_DIMS = (1, 1, 1, 1, 1, 1, 3, 1, 3)

SOURCE = Path(__file__).parent / "csrc" / "spgemm_bcsr.cu"
_P, _L = ctypes.c_void_p, ctypes.c_longlong
_FUNCTIONS = {
    "spgemm_bcsr_classify": [ctypes.c_int] * 7 + [_P] * 13,
    "spgemm_bcsr_class_shape": [ctypes.c_int] * 2 + [_P],
    "spgemm_bcsr_class_launch": [ctypes.c_int] * 12 + [_P] * 16,
    "spgemm_bcsr_numeric": [ctypes.c_int] * 14 + [_P] * 16,
    # ints; each array pointer before its member stride (offsets,
    # bin_tsize, indptr_a, a_bcol, a_blk, indptr_b, b_bcol, b_blk,
    # indptr_c); outputs, errors, workspace and the stream
    "spgemm_bcsr_batched_launch":
        [ctypes.c_int] * 15 + [_P, _L] * 9 + [_P] * 5,
}
_lib = None
_shapes: dict = {}


def build() -> dict:
    """Compile (if this source was not built yet) and load the library;
    returns :func:`repro_torch.kernels._build.load`'s record."""
    global _lib
    info = _build.load(SOURCE, _FUNCTIONS)
    _lib = info["lib"]
    return info


def _ptr(t):
    return None if t is None else t.data_ptr()


def class_shape(cls: int, vector: bool) -> dict:
    """The launch shape of class ``cls``'s kernel on the current card:
    ``{"threads", "smem_bytes", "resident_blocks"`` (its persistent
    grid), ``"registers"}``.  Cached per class, probe mode and device."""
    build()
    key = (cls, bool(vector), torch.cuda.current_device())
    if key not in _shapes:
        out = (ctypes.c_int * 4)()
        err = _lib.spgemm_bcsr_class_shape(int(vector), cls, out)
        if err != 0:
            raise RuntimeError(f"spgemm_bcsr class {CLASS_NAMES[cls]}: "
                               f"occupancy query failed: CUDA error {err}")
        _shapes[key] = dict(zip(("threads", "smem_bytes",
                                 "resident_blocks", "registers"),
                                list(out)))
        if _shapes[key]["resident_blocks"] < 1:
            raise RuntimeError(f"spgemm_bcsr class {CLASS_NAMES[cls]}: no "
                               f"block of {_shapes[key]} fits the card")
    return _shapes[key]


def _check_operands(indptr_a, indptr_b, indptr_c, a_bcol, a_blk, b_bcol,
                    b_blk):
    dev = a_bcol.device
    for name, t in (("indptr_a", indptr_a), ("indptr_b", indptr_b),
                    ("indptr_c", indptr_c), ("a_bcol", a_bcol),
                    ("b_bcol", b_bcol)):
        _build.check_tensor(name, t, torch.int32, dev)
    for name, t in (("a_blk", a_blk), ("b_blk", b_blk)):
        _build.check_tensor(name, t, torch.float32, dev)
        if t.dim() != 3:
            raise ValueError(f"{name} must be (bcap, rows, cols), got "
                             f"{tuple(t.shape)}")
    if a_blk.shape[2] != b_blk.shape[1]:
        raise ValueError(f"inner tile sizes differ: A tiles "
                         f"{tuple(a_blk.shape[1:])}, B tiles "
                         f"{tuple(b_blk.shape[1:])}")
    if indptr_c.shape != indptr_a.shape:
        raise ValueError("indptr_c and indptr_a must both be (gm + 1,)")
    if min(a_blk.shape[1:]) < 1 or b_blk.shape[2] < 1:
        raise ValueError(f"empty tiles: A {tuple(a_blk.shape[1:])}, B "
                         f"{tuple(b_blk.shape[1:])}")


def _aligned(t) -> int:
    """1 when ``t``'s data may be copied 16 bytes at a time."""
    return int(t.data_ptr() % 16 == 0)


def classify_rows(vector, offsets, bin_tsize, table_size, indptr_a,
                  indptr_b, indptr_c, a_bcol, block, errors):
    """The classifying kernels alone: ``(counts, work)``: ``counts`` the
    (class, bucket) row counts (``classes * LEN_BUCKETS``) then the class
    kernels' pop counters (zero); ``work`` rows ``row_tsz``, ``row_key``,
    ``row_rank`` and the class lists (:func:`launch_class` takes them)."""
    dev = a_bcol.device
    m = indptr_a.shape[0] - 1
    for name, t in (("offsets", offsets), ("bin_tsize", bin_tsize)):
        _build.check_tensor(name, t, torch.int32, dev)
    n_keys = len(CLASS_NAMES) * ref.LEN_BUCKETS
    counts = torch.zeros(n_keys + len(CLASS_NAMES), dtype=torch.int32,
                         device=dev)
    work = torch.empty(4, max(m, 1), dtype=torch.int32, device=dev)
    err = _lib.spgemm_bcsr_classify(
        m, bin_tsize.shape[0], table_size, int(vector), *block,
        _ptr(offsets), _ptr(bin_tsize), _ptr(indptr_a), _ptr(a_bcol),
        _ptr(indptr_b), _ptr(indptr_c), _ptr(counts), _ptr(work[0]),
        _ptr(work[1]), _ptr(work[2]), _ptr(work[3]), _ptr(errors),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"spgemm_bcsr classify launch failed: CUDA "
                           f"error {err}")
    CLASS_CALLS["classify"] += 1
    return counts, work


def launch_class(cls, counts, work, *, pdl, table_size, vector, indptr_a,
                 indptr_b, indptr_c, a_bcol, a_blk, b_bcol, b_blk, out_bcol,
                 out_blk, errors):
    """One class's persistent launch over the rows that
    :func:`classify_rows` listed (``counts``, ``work``; the class's pop
    counter must be zero); ``pdl``: as a programmatic dependent of the
    launch before it."""
    dev = a_bcol.device
    bm, bk = a_blk.shape[1], a_blk.shape[2]
    bn = b_blk.shape[2]
    ws_keys, ws_tsz = None, 0
    if cls == len(CLASS_NAMES) - 1:
        grid, ws_tsz = GLOBAL_BLOCKS, table_size
        ws_keys = torch.empty(grid * 2 * ws_tsz, dtype=torch.int32,
                              device=dev)
    else:
        grid = class_shape(cls, vector)["resident_blocks"]
    n_keys = len(CLASS_NAMES) * ref.LEN_BUCKETS
    err = _lib.spgemm_bcsr_class_launch(
        int(vector), cls, int(pdl), out_bcol.shape[0], b_bcol.shape[0], bm,
        bk, bn, _aligned(a_blk), _aligned(b_blk), grid, ws_tsz, _ptr(counts),
        _ptr(counts[n_keys:]), _ptr(work[3]), _ptr(work[0]),
        _ptr(indptr_a), _ptr(a_bcol), _ptr(a_blk), _ptr(indptr_b),
        _ptr(b_bcol), _ptr(b_blk), _ptr(indptr_c), _ptr(out_bcol),
        _ptr(out_blk), _ptr(errors), _ptr(ws_keys),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"spgemm_bcsr launch failed for class "
                           f"{CLASS_NAMES[cls]}: CUDA error {err}")
    CLASS_CALLS[CLASS_NAMES[cls]] += 1


def _launch_classes(vector, offsets, bin_tsize, table_size, indptr_a,
                    indptr_b, indptr_c, a_bcol, a_blk, b_bcol, b_blk,
                    out_bcol, out_blk, errors, ints):
    """The classifying kernels, then one persistent launch per class that
    can hold rows (:func:`ref.launch_classes`), the largest first, in one
    call of the library; no host synchronisation.  ``ints``: the address
    of the classes' counts and pop counters (zeroed) and 4 m work ints."""
    dev = a_bcol.device
    bm, bk = a_blk.shape[1], a_blk.shape[2]
    bn = b_blk.shape[2]
    m = indptr_a.shape[0] - 1
    build()
    if m < 1:
        return
    for name, t in (("offsets", offsets), ("bin_tsize", bin_tsize)):
        _build.check_tensor(name, t, torch.int32, dev)
    classes = ref.launch_classes((bm, bk, bn), table_size, out_bcol.shape[0])
    ws_keys = None
    if classes[0] == len(CLASS_NAMES) - 1:
        ws_keys = torch.empty(GLOBAL_BLOCKS * 2 * table_size,
                              dtype=torch.int32, device=dev)
    err = _lib.spgemm_bcsr_numeric(
        int(vector), m, bin_tsize.shape[0], table_size,
        out_bcol.shape[0], b_bcol.shape[0], bm, bk, bn, _aligned(a_blk),
        _aligned(b_blk), classes[0], classes[-1], GLOBAL_BLOCKS,
        _ptr(offsets), _ptr(bin_tsize), _ptr(indptr_a), _ptr(a_bcol),
        _ptr(a_blk), _ptr(indptr_b), _ptr(b_bcol), _ptr(b_blk),
        _ptr(indptr_c), ints, ints + 4 * _N_COUNTS, _ptr(out_bcol),
        _ptr(out_blk), _ptr(errors), _ptr(ws_keys),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"spgemm_bcsr numeric launch failed: CUDA error "
                           f"{err}")
    CLASS_CALLS["classify"] += 1
    for cls in classes:
        CLASS_CALLS[CLASS_NAMES[cls]] += 1


def row_classes(offsets, bin_tsize, indptr_a, indptr_b, indptr_c, a_bcol, *,
                table_size: int, vector: bool, block,
                errors: torch.Tensor | None = None):
    """The single-product kernel's row classes alone: ``(counts (classes,
    LEN_BUCKETS) int32, rows, row_tsz (m,) int32)`` as
    ``ref.row_classes_plain`` returns them (on a card each class's rows
    in its pop order, free within a bucket).  ``block`` is ``(bm, bk,
    bn)``.

    On a card it runs the classifying kernels as the numeric wrapper does
    (``errors``: as for :func:`numeric_call`, gaining one per row whose
    table cannot hold its output or that ``indptr_c`` leaves empty but that
    has pairs); on the CPU the plain version.
    """
    if a_bcol.device.type == "cpu":
        CLASS_CALLS["plain"] += 1
        return ref.row_classes_plain(offsets, bin_tsize, indptr_a, indptr_c,
                                     table_size=table_size, vector=vector,
                                     block=block)
    dev = a_bcol.device
    for name, t in (("indptr_a", indptr_a), ("indptr_b", indptr_b),
                    ("indptr_c", indptr_c), ("a_bcol", a_bcol)):
        _build.check_tensor(name, t, torch.int32, dev)
    build()
    own = errors is None
    if own:
        errors = torch.zeros(1, dtype=torch.int32, device=dev)
    _build.check_tensor("errors", errors, torch.int32, dev)
    m = indptr_a.shape[0] - 1
    counts, work = classify_rows(vector, offsets, bin_tsize, table_size,
                                 indptr_a, indptr_b, indptr_c, a_bcol,
                                 tuple(block), errors)
    if own:
        _build.raise_on_errors(errors, "spgemm_bcsr classify")
    n_cls = len(CLASS_NAMES)
    grid = counts[:n_cls * ref.LEN_BUCKETS].view(n_cls, ref.LEN_BUCKETS)
    per = grid.sum(1).tolist()
    rows, at = [], 0
    for c in range(n_cls):
        rows.append(work[3, at:at + per[c]].clone())
        at += per[c]
    row_tsz = work[0, :m].clone()
    row_tsz[work[1, :m] < 0] = 0
    return grid.clone(), rows, row_tsz


def numeric_call(offsets, bin_tsize, indptr_a, indptr_b, indptr_c, a_bcol,
                 a_blk, b_bcol, b_blk, *, bcap_c: int, table_size: int,
                 vector: bool, errors: torch.Tensor | None = None):
    """``(out_bcol (bcap_c,) int32, out_blk (bcap_c, bm, bn) float32)``:
    each block row's blocks at ``indptr_c``, block columns unsorted, the
    tail zero.

    ``errors`` (CUDA only): a 1-element int32 tensor that gains one per
    block row whose table cannot hold its output, per probe that found its
    table full and per block row whose flushed count disagrees with
    ``indptr_c`` -- zero on every valid plan.  Without it
    the wrapper reads its own count after the launch and raises if it is
    not zero.
    """
    if a_bcol.device.type == "cpu":
        KERNEL_CALLS["plain"] += 1
        return ref.numeric_plain(offsets, bin_tsize, indptr_a, indptr_b,
                                 indptr_c, a_bcol, a_blk, b_bcol, b_blk,
                                 bcap_c=bcap_c, table_size=table_size,
                                 vector=vector)
    _check_operands(indptr_a, indptr_b, indptr_c, a_bcol, a_blk, b_bcol,
                    b_blk)
    dev = a_bcol.device
    m = max(indptr_a.shape[0] - 1, 0)
    # one zeroed allocation: out_bcol, the own errors count, the classes'
    # counts and pop counters, the classifier's 4 m work ints
    ints = torch.zeros(bcap_c + 1 + _N_COUNTS + 4 * m, dtype=torch.int32,
                       device=dev)
    out_bcol = ints[:bcap_c]
    out_blk = torch.zeros((bcap_c, a_blk.shape[1], b_blk.shape[2]),
                          dtype=torch.float32, device=dev)
    own = errors is None
    if own:
        errors = ints[bcap_c:bcap_c + 1]
    _build.check_tensor("errors", errors, torch.int32, dev)
    _launch_classes(vector, offsets, bin_tsize, table_size, indptr_a,
                    indptr_b, indptr_c, a_bcol, a_blk, b_bcol, b_blk,
                    out_bcol, out_blk, errors,
                    ints.data_ptr() + 4 * (bcap_c + 1))
    KERNEL_CALLS["numeric_vector" if vector else "numeric"] += 1
    if own:
        _build.raise_on_errors(errors, "spgemm_bcsr numeric")
    return out_bcol, out_blk


def batched_numeric_call(offsets, bin_tsize, indptr_a, indptr_b, indptr_c,
                         a_bcol, a_blk, b_bcol, b_blk, *, n_members: int,
                         bcap_c: int, table_size: int, vector: bool,
                         errors: torch.Tensor | None = None):
    """:func:`numeric_call` for every member of a fleet: ``(out_bcol
    (n, bcap_c) int32, out_blk (n, bcap_c, bm, bn) float32)``.

    Each array argument either has a leading member axis of ``n_members``
    or has :func:`numeric_call`'s shape and is shared by every member: it
    goes to the kernel as it is, read in place with member stride 0, and
    is never copied per member.  The wrapper reads the bins back to lay
    out its launches (:func:`launch_list`); the kernel itself checks each
    member's bins against the block rows it is given.  ``errors`` as for
    :func:`numeric_call`, one counter for all members.
    """
    args = (offsets, bin_tsize, indptr_a, indptr_b, indptr_c, a_bcol, a_blk,
            b_bcol, b_blk)
    strides, views = _build.member_layout(ARG_NAMES, args, ARG_DIMS,
                                          n_members)
    if a_bcol.device.type == "cpu":
        KERNEL_CALLS["batched_plain"] += 1
        return ref.batched_numeric_plain(
            *args, n_members=n_members, bcap_c=bcap_c,
            table_size=table_size, vector=vector)
    dev = a_bcol.device
    for name, t in zip(ARG_NAMES[:2], args[:2]):
        _build.check_tensor(name, t, torch.int32, dev)
    _check_operands(*views[2:])
    if errors is not None:
        _build.check_tensor("errors", errors, torch.int32, dev)
    bm, bn = a_blk.shape[-2], b_blk.shape[-1]
    bk = a_blk.shape[-1]
    tile = bm * bn
    build()
    launches = launch_list(offsets, bin_tsize, n_members=n_members,
                           n_rows=indptr_a.shape[-1] - 1,
                           table_size=table_size, tile=tile, vector=vector)
    out_bcol = torch.zeros(n_members, bcap_c, dtype=torch.int32, device=dev)
    out_blk = torch.zeros((n_members, bcap_c, bm, bn), dtype=torch.float32,
                          device=dev)
    own = errors is None
    if own:
        errors = torch.zeros(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    a16 = _aligned(a_blk)
    b16 = _aligned(b_blk)
    key = "batched_numeric_vector" if vector else "batched_numeric"
    # the C interface's order: the schedule, A's arrays, B's, indptr_c
    pairs = [v for i in (0, 1, 2, 5, 6, 3, 7, 8, 4)
             for v in (_ptr(args[i]), strides[i])]
    for launch in launches:
        smem, ws_tsz = batched_smem(launch, (bm, bk, bn))
        ws_keys = None
        if ws_tsz:
            ws_keys = torch.empty(launch["grid_x"] * n_members * 2 * ws_tsz,
                                  dtype=torch.int32, device=dev)
        err = _lib.spgemm_bcsr_batched_launch(
            int(vector), launch["bin"], indptr_a.shape[-1] - 1, table_size,
            smem, ws_tsz, bcap_c, bm, bk, bn, a16, b16, b_bcol.shape[-1],
            launch["grid_x"], n_members, *pairs, _ptr(out_bcol),
            _ptr(out_blk), _ptr(errors), _ptr(ws_keys), stream)
        if err != 0:
            raise RuntimeError(f"spgemm_bcsr batched launch failed for bin "
                               f"{launch['bin']}: CUDA error {err}")
        KERNEL_CALLS[key] += 1
    if own:
        _build.raise_on_errors(errors, "spgemm_bcsr batched numeric")
    return out_bcol, out_blk


def launch_list(offsets, bin_tsize, *, n_members: int, n_rows: int,
                table_size: int, tile: int, vector: bool) -> list:
    """The launches of :func:`batched_numeric_call` for this schedule
    (stacked ``(n, ...)`` or shared 1-D bins): the hash batched kernel's
    geometry (``spgemm_hash.kernel.batched_launches``), with the shared
    memory of :data:`SMEM_BUDGET` counted in slots of ``tile`` float32
    lanes plus a key."""
    bounds = offsets.tolist()
    sizes = bin_tsize.tolist()
    if offsets.dim() == 1:
        bounds = [bounds] * n_members
    if bin_tsize.dim() == 1:
        sizes = [sizes] * n_members
    return batched_launches(bounds, sizes, table_size, n_rows, vector,
                            smem_slots=SMEM_BUDGET // (4 * (1 + tile)))


def batched_smem(launch: dict, block) -> tuple:
    """``(dynamic shared memory bytes, workspace slots)`` of one batched
    launch of :func:`launch_list` for ``block`` ``(bm, bk, bn)`` tiles.
    Without a workspace, room for the launch's largest table full
    (``ref.row_bytes``), where it fits :data:`MAX_SMEM`; with one (or when
    it does not fit), :data:`MAX_SMEM`, rows that fit run staged and the
    rest direct with the launch's largest table (``ws_tsz``) of keys and
    map per member and x block."""
    bm, bk, bn = block
    ws_tsz = launch["ws_tsz"]
    if not ws_tsz:
        cap = launch["smem_slots"]
        smem = ref.row_bytes(cap, cap, bm, bk, bn)
        if smem <= MAX_SMEM:
            return smem, 0
        ws_tsz = cap
    return MAX_SMEM, ws_tsz
