"""Hand-written CUDA hash SpGEMM kernels (paper Figs. 7 and 8) and their
wrappers.

``csrc/spgemm_hash.cu`` replaces the Pallas kernels of
``repro/kernels/spgemm_hash/kernel.py`` (``numeric_call``,
``symbolic_call``, the ``_probe_vector`` mode of both, and
``batched_symbolic_call`` and ``batched_numeric_call``, the two phases over
a fleet); its header says how the design maps the TPU's sequential bin
grid onto the card.  Every row probes a table sized from its own output
count (numeric) or product count (symbolic), at most its bin's.  Both
phases, of a fleet or of a single product (the fleet of one member), run
rows by table class (:data:`CLASS_NAMES`): a classifying kernel, which
replaces no TPU kernel, lists every member's rows by class in device
memory, and one persistent launch per class that can hold rows runs
every member's rows of that class -- tables of up to :data:`SMEM_SLOTS`
in one block's shared memory, up to :data:`CLUSTER_SLOTS` across a
thread-block cluster's distributed shared memory, larger ones in a
device-memory workspace.  The symbolic phase takes B's width
(``n_cols``) and, where B has at most ``ref.BITMAP_COLS`` columns, puts
every row whose table would pass ``ref.bitmap_above(n_cols)`` slots on
one more class, ``bitmap`` (:data:`SYMBOLIC_CLASS_NAMES`): one block a row
counts its distinct columns in a shared-memory bitmap of B's columns.
It is
compiled with ``nvcc`` for ``sm_90a`` at first use, into a shared library
with a plain C interface under ``build/torch_ext/`` at the root of the
checkout, and loaded with ``ctypes``.  Nothing is compiled at import, so
the module imports on a machine without CUDA.

:func:`symbolic_call` and :func:`numeric_call` take the reference
builders' arguments; :func:`batched_symbolic_call` and
:func:`batched_numeric_call` take them with a member axis on any of them;
:func:`row_classes` and :func:`batched_row_classes` are the classifying
kernel alone.
On CPU tensors they run the plain versions of
``ref.py``; on CUDA tensors they launch the kernel or raise -- a build or
launch failure is never answered with the plain version.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build
from . import ref

#: Vector probe width: slots compared per step in hash_vector mode.
CHUNK = 8

#: Launch counters.  A wrapper adds one where it launches its kernel (the
#: single-product counters one a call; the batched counters one per CUDA
#: launch of a class kernel, one per class that the fleet's largest table
#: allows; the classifying launch, and the single product's class
#: launches, count in :data:`CLASS_CALLS`).
#: ``plain`` counts the single-product wrappers' runs of the plain
#: versions and ``batched_plain`` the batched wrappers' -- zero on a card
#: proves the main path never took them.
KERNEL_CALLS = {"symbolic": 0, "numeric": 0, "symbolic_vector": 0,
                "numeric_vector": 0, "batched_symbolic": 0,
                "batched_symbolic_vector": 0, "batched_numeric": 0,
                "batched_numeric_vector": 0, "plain": 0, "batched_plain": 0}

#: Largest table of one block's shared memory: 16,384 slots, 128 KB of
#: key + value; the slice each block of a cluster holds.
SMEM_SLOTS = 16384
#: Largest table in a cluster's distributed shared memory: 8 slices.
CLUSTER_SLOTS = 8 * SMEM_SLOTS
#: The class kernels' table classes (either phase), by the largest table
#: of each (``ref.CLASS_SLOTS``; the last, past ``CLUSTER_SLOTS``, in
#: device memory) and the blocks that hold one (a cluster past one).
CLASS_NAMES = ("smem_1024", "smem_4096", "smem_16384", "cluster_2",
               "cluster_4", "cluster_8", "global")
CLASS_BLOCKS = (1, 1, 1, 2, 4, 8, 1)
#: The symbolic phase's classes: the table classes and, when B's bitmap
#: fits one block, ``bitmap`` (one block a row), which takes every row
#: whose table passes ``ref.bitmap_above(n_cols)`` slots.
BITMAP_CLASS = len(CLASS_NAMES)
SYMBOLIC_CLASS_NAMES = CLASS_NAMES + ("bitmap",)
#: Blocks that share the device-memory tables of the global class.
GLOBAL_BLOCKS = 264

#: Launches of the class-ordered runs' parts, extra to
#: :data:`KERNEL_CALLS` (one ``numeric``/``symbolic`` and their
#: ``_vector`` twins per single-product call stays the proof of path):
#: ``classify`` per run of the classifying kernel (single product or
#: fleet, either phase), one per class launch under its
#: :data:`SYMBOLIC_CLASS_NAMES` name, ``plain`` per run of
#: :func:`row_classes`' or :func:`batched_row_classes`' plain version.
CLASS_CALLS = dict.fromkeys(("classify",) + SYMBOLIC_CLASS_NAMES
                            + ("plain",), 0)

#: Ints of the classifying kernels' ``counts``: each class's listed pairs,
#: then the class kernels' pop counters.
COUNT_INTS = 2 * len(SYMBOLIC_CLASS_NAMES)
#: A fleet's (member, row) pairs must number fewer: the lists hold int32.
MAX_PAIRS = 2 ** 31

SOURCE = Path(__file__).parent / "csrc" / "spgemm_hash.cu"
_P, _L = ctypes.c_void_p, ctypes.c_longlong


class _Fleet(ctypes.Structure):
    """The source's ``Fleet``: each array's address and member stride, the
    outputs, the output capacity (the numeric outputs' member stride), the
    sizes, B's width (-1 in the numeric phase) and the table above which a
    symbolic row goes to the bitmap class (0: no bitmap class)."""
    _fields_ = ([(f"{name}{sfx}", t) for name in (
        "offsets", "bin_tsize", "indptr_a", "a_idx", "a_val", "indptr_b",
        "b_idx", "b_val", "indptr_c") for sfx, t in (("", _P), ("_s", _L))]
        + [("out_cols", _P), ("out_vals", _P), ("row_nnz", _P),
           ("cap_c", _L), ("n", ctypes.c_int), ("m", ctypes.c_int),
           ("n_bins", ctypes.c_int), ("table_size", ctypes.c_int),
           ("n_cols", ctypes.c_int), ("bitmap_above", ctypes.c_int)])


_FLEET = ctypes.POINTER(_Fleet)
_FUNCTIONS = {
    "spgemm_hash_classify": [ctypes.c_int] * 2 + [_FLEET] + [_P] * 6,
    "spgemm_hash_class_shape": [ctypes.c_int] * 4 + [_P],
    "spgemm_hash_class_launch": [ctypes.c_int] * 5 + [_FLEET] + [_P] * 7,
}

#: The array arguments of :func:`numeric_call`, in order.  An argument of
#: :func:`batched_numeric_call` has a leading member axis or is 1-D and
#: shared by every member; :func:`batched_symbolic_call` takes the same
#: arrays but ``indptr_c``.
ARG_NAMES = ("offsets", "bin_tsize", "indptr_a", "indptr_b", "indptr_c",
             "a_idx", "a_val", "b_idx", "b_val")
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


def class_shape(cls: int, vector: bool, numeric: bool = True,
                n_cols: int = 0) -> dict:
    """The launch shape of class ``cls``'s kernel (``numeric``: the
    numeric phase's, else the symbolic one's; ``n_cols``: B's width, which
    sizes the symbolic ``bitmap`` class) on the current card:
    ``{"blocks"`` (a cluster), ``"threads"``, ``"smem_bytes"``,
    ``"resident_blocks"`` (its persistent grid), ``"resident_clusters"``
    (``cudaOccupancyMaxActiveClusters``, 0 below two blocks)``}``.
    Cached per class, phase, probe mode, bitmap width and device."""
    build()
    if cls != BITMAP_CLASS:
        n_cols = 0
    key = (cls, bool(numeric), bool(vector), n_cols,
           torch.cuda.current_device())
    if key not in _shapes:
        out = (ctypes.c_int * 5)()
        err = _lib.spgemm_hash_class_shape(int(numeric), int(vector), cls,
                                           n_cols, out)
        if err != 0:
            raise RuntimeError(f"spgemm_hash class "
                               f"{SYMBOLIC_CLASS_NAMES[cls]}: occupancy "
                               f"query failed: CUDA error {err}")
        _shapes[key] = dict(zip(("blocks", "threads", "smem_bytes",
                                 "resident_blocks", "resident_clusters"),
                                list(out)))
        if _shapes[key]["resident_blocks"] < 1:
            raise RuntimeError(f"spgemm_hash class "
                               f"{SYMBOLIC_CLASS_NAMES[cls]}: no block of "
                               f"{_shapes[key]} fits the card")
    return _shapes[key]


def _check_operands(indptr_a, indptr_b, a_idx, a_val, b_idx, b_val,
                    indptr_c, errors):
    dev = a_idx.device
    for name, t in (("indptr_a", indptr_a), ("indptr_b", indptr_b),
                    ("a_idx", a_idx), ("b_idx", b_idx)):
        _build.check_tensor(name, t, torch.int32, dev)
    for name, t in (("a_val", a_val), ("b_val", b_val)):
        _build.check_tensor(name, t, torch.float32, dev)
    if indptr_c is not None:
        _build.check_tensor("indptr_c", indptr_c, torch.int32, dev)
    _build.check_tensor("errors", errors, torch.int32, dev)


def _bins_holding_rows(bounds, sizes, table_size, m, vector, who="") -> list:
    """``(b, r0, r1, tsz)`` of every bin of one schedule (host lists) that
    holds rows; raises ``ValueError`` for bins that do not partition ``m``
    rows or tables that are not powers of two (at least :data:`CHUNK` in
    vector mode).  ``who`` names the member in the messages."""
    if len(bounds) != len(sizes) + 1 or \
            any(not 0 <= r0 <= r1 <= m for r0, r1 in zip(bounds, bounds[1:])):
        raise ValueError(f"{who}bin offsets {bounds} do not partition {m} "
                         f"rows into {len(sizes)} bins")
    bins = []
    for b, tsz in enumerate(sizes):
        r0, r1 = bounds[b], bounds[b + 1]
        if r1 <= r0:
            continue
        tsz = min(int(tsz), table_size)
        if tsz < 1 or tsz & (tsz - 1) or (vector and tsz < CHUNK):
            raise ValueError(f"{who}bin {b}: table size {tsz} is not a power "
                             f"of two{' >= CHUNK' if vector else ''}")
        bins.append((b, r0, r1, tsz))
    return bins


def _bin_tables(offsets, bin_tsize, table_size, m, vector) -> list:
    """``(r0, r1, tsz)`` of every bin that holds rows, from the schedule
    read back to the host (the execute's only synchronisation), checked
    as :func:`_bins_holding_rows` does."""
    return [x[1:] for x in _bins_holding_rows(
        offsets.tolist(), bin_tsize.tolist(), table_size, m, vector)]


def launch_classes(largest: int, bitmap_above: int = 0) -> tuple:
    """The table classes launched when no row's plan table exceeds
    ``largest`` slots: every class up to the one that holds ``largest``
    (none for 0).  With ``bitmap_above`` (``ref.bitmap_above``: the
    symbolic phase on a B whose bitmap fits one block) the rows whose
    table passes it go to :data:`BITMAP_CLASS` instead: the classes up to
    the one that holds ``bitmap_above``, then the bitmap class when
    ``largest`` passes it."""
    if largest <= 0:
        return ()
    top = min(largest, bitmap_above) if bitmap_above > 0 else largest
    classes = tuple(range(1 + sum(s < top for s in ref.CLASS_SLOTS)))
    if 0 < bitmap_above < largest:
        classes += (BITMAP_CLASS,)
    return classes


def fleet_table(bounds, sizes, table_size: int, n_rows: int,
                vector: bool) -> int:
    """The largest plan table, ``min(sizes[e][b], table_size)``, of any
    bin that holds rows in any member of a fleet (0 when none does), from
    the schedules as host lists: ``bounds[e]`` member e's bin offsets,
    ``sizes[e]`` its per-bin table sizes.  It decides
    :func:`launch_classes` and the global class's workspace; a plan
    computes it once.  Raises ``ValueError`` as
    :func:`_bins_holding_rows` does."""
    if not bounds or len(sizes) != len(bounds):
        raise ValueError(f"a fleet of {len(bounds)} members with "
                         f"{len(sizes)} bin size lists")
    largest = 0
    for e, (bd, sz) in enumerate(zip(bounds, sizes)):
        for _, _, _, tsz in _bins_holding_rows(bd, sz, table_size, n_rows,
                                               vector, f"member {e}: "):
            largest = max(largest, tsz)
    return largest


#: Set to a list to have every classifying and class launch bracketed by
#: CUDA events: each launch appends ``(phase, "classify" or the class
#: name, start, end)``.  Measurement only (``chip_smoke.py``); ``None``
#: on the main path.
CLASS_EVENTS = None


def _marked(phase: str, name: str, launch):
    """``launch()``, bracketed by CUDA events into :data:`CLASS_EVENTS`
    when that is a list."""
    if CLASS_EVENTS is None:
        return launch()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    marks[0].record()
    out = launch()
    marks[1].record()
    CLASS_EVENTS.append((phase, name, *marks))
    return out


def _fleet(args: dict, strides: dict, *, n: int, m: int, table_size: int,
           cap_c: int = 0, out_cols=None, out_vals=None, row_nnz=None,
           n_cols: int | None = None) -> _Fleet:
    """The C interface's ``Fleet`` of ``n`` members of ``m`` rows:
    :data:`ARG_NAMES` -> tensor (each stacked or shared) with their member
    strides (absent: 0).  ``n_cols``: the symbolic phase's B width, shared
    by every member, which sizes its bitmap class (``ref.bitmap_above``);
    ``None`` in the numeric phase, which has none."""
    fields = {}
    for name in ARG_NAMES:
        fields[name] = _ptr(args.get(name))
        fields[f"{name}_s"] = strides.get(name, 0)
    f = _Fleet(**fields)
    f.out_cols, f.out_vals = _ptr(out_cols), _ptr(out_vals)
    f.row_nnz = _ptr(row_nnz)
    f.cap_c, f.n, f.m = cap_c, n, m
    f.n_bins, f.table_size = args["bin_tsize"].shape[-1], table_size
    f.n_cols = -1 if n_cols is None else n_cols
    f.bitmap_above = 0 if n_cols is None else ref.bitmap_above(n_cols)
    return f


def _classify(numeric: bool, fleet: _Fleet, classes: tuple, errors, dev):
    """The classifying kernels over the fleet's ``n * m`` (member, row)
    pairs, for the class launches ``classes``: ``(counts (COUNT_INTS,),
    list (n * m,), row_tsz (n * m,))``, ``counts[:8]`` each class's pairs
    (:data:`SYMBOLIC_CLASS_NAMES`), ``list`` the entries ``e * m + i``
    class after class, ``row_tsz`` each pair's table (0: none), the pop
    counters zero."""
    pairs = fleet.n * fleet.m
    if pairs >= MAX_PAIRS:
        raise ValueError(f"{fleet.n} members of {fleet.m} rows: the row "
                         f"lists hold fewer than 2^31 entries")
    # one allocation; the classifying call zeroes the counts
    work = torch.empty(COUNT_INTS + 3 * max(pairs, 1), dtype=torch.int32,
                       device=dev)
    counts = work[:COUNT_INTS]
    lst, row_tsz, row_rank = work[COUNT_INTS:].view(3, -1)
    launched = sum(1 << c for c in classes)
    err = _marked("numeric" if numeric else "symbolic", "classify",
                  lambda: _lib.spgemm_hash_classify(
                      int(numeric), launched, ctypes.byref(fleet),
                      _ptr(counts), _ptr(lst), _ptr(row_tsz), _ptr(row_rank),
                      _ptr(errors),
                      torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"spgemm_hash classify launch failed: CUDA "
                           f"error {err}")
    CLASS_CALLS["classify"] += 1
    return counts, lst, row_tsz


def _run_classes(numeric: bool, vector: bool, fleet: _Fleet, largest: int,
                 errors, dev) -> int:
    """Classify the fleet's rows, then one persistent launch per class
    that ``largest`` allows (:func:`launch_classes`; the symbolic phase's
    bitmap class where the fleet turns it on), smallest first, each over
    every member's rows of its class.  Returns the class launches."""
    classes = launch_classes(largest, fleet.bitmap_above)
    if not classes or fleet.n * fleet.m == 0:
        return 0
    counts, lst, row_tsz = _classify(numeric, fleet, classes, errors, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    phase = "numeric" if numeric else "symbolic"
    for cls in classes:
        ws_keys = ws_vals = None
        ws_tsz = 0
        if cls == len(CLASS_NAMES) - 1:
            grid, ws_tsz = GLOBAL_BLOCKS, largest
            ws_keys = torch.empty(grid * ws_tsz, dtype=torch.int32,
                                  device=dev)
            if numeric:
                ws_vals = torch.empty(grid * ws_tsz, dtype=torch.float32,
                                      device=dev)
        else:
            # as many blocks as the card holds, but no more than pairs
            shape = class_shape(cls, vector, numeric, fleet.n_cols)
            grid = min(shape["resident_blocks"],
                       -(-fleet.n * fleet.m // shape["blocks"])
                       * shape["blocks"])
        name = SYMBOLIC_CLASS_NAMES[cls]
        err = _marked(phase, name,
                      lambda: _lib.spgemm_hash_class_launch(
                          int(numeric), int(vector), cls, grid, ws_tsz,
                          ctypes.byref(fleet), _ptr(counts), _ptr(lst),
                          _ptr(row_tsz), _ptr(errors), _ptr(ws_keys),
                          _ptr(ws_vals), stream))
        if err != 0:
            raise RuntimeError(f"spgemm_hash {phase} launch failed for "
                               f"class {name}: CUDA error {err}")
        CLASS_CALLS[name] += 1
    return len(classes)


def _launch_single(numeric: bool, vector: bool, args: dict, errors, *,
                   table_size: int, cap_c: int = 0, out_cols=None,
                   out_vals=None, row_nnz=None, n_cols=None) -> None:
    """The single product as the fleet of one member, either phase
    (``args``: :data:`ARG_NAMES` -> tensor, without ``indptr_c`` for the
    symbolic one, with B's width ``n_cols``): its bins read back for the
    largest table, one classifying launch, then one persistent launch per
    class that can hold rows, over the arrays as they are."""
    dev = args["a_idx"].device
    build()
    m = args["indptr_a"].shape[0] - 1
    bins = _bin_tables(args["offsets"], args["bin_tsize"], table_size, m,
                       vector)
    if not bins:
        return
    _build.check_tensor("offsets", args["offsets"], torch.int32, dev)
    _build.check_tensor("bin_tsize", args["bin_tsize"], torch.int32, dev)
    fleet = _fleet(args, {}, n=1, m=m, table_size=table_size, cap_c=cap_c,
                   out_cols=out_cols, out_vals=out_vals, row_nnz=row_nnz,
                   n_cols=n_cols)
    _run_classes(numeric, vector, fleet, max(t for _, _, t in bins), errors,
                 dev)


def _class_lists(counts, lst) -> list:
    """Each class's entries of the classifying kernel's list."""
    sizes = counts[:len(SYMBOLIC_CLASS_NAMES)].tolist()
    starts = [sum(sizes[:c]) for c in range(len(sizes))]
    return [lst[s0:s0 + k] for s0, k in zip(starts, sizes)]


def row_classes(offsets, bin_tsize, indptr_a, indptr_b, indptr_c, a_idx, *,
                table_size: int, errors: torch.Tensor | None = None):
    """The numeric kernel's row classes alone: ``(counts (7,) int32, rows,
    row_tsz (m,) int32)``, ``rows[c]`` class c's row ids (in no order on
    a card, ascending in the plain version) and ``row_tsz`` each listed
    row's table (0 for a row with no output).

    On a card it runs the classifying kernel as the numeric wrapper does
    (``errors``: as for :func:`numeric_call`, gaining one per row that
    ``indptr_c`` leaves empty but that has products); on the CPU
    ``ref.row_classes_plain``.
    """
    if a_idx.device.type == "cpu":
        CLASS_CALLS["plain"] += 1
        return ref.row_classes_plain(offsets, bin_tsize, indptr_c,
                                     table_size=table_size)
    counts, pairs, row_tsz = batched_row_classes(
        offsets, bin_tsize, indptr_a, indptr_b, indptr_c, a_idx,
        n_members=1, table_size=table_size, errors=errors)
    return counts, [x[:, 1].to(torch.int32) for x in pairs], row_tsz[0]


def batched_row_classes(offsets, bin_tsize, indptr_a, indptr_b, indptr_c,
                        a_idx, *, n_members: int, table_size: int,
                        numeric: bool = True,
                        errors: torch.Tensor | None = None,
                        n_cols: int | None = None):
    """The classifying kernel alone, for either phase of a fleet:
    ``(counts (k,) int32, pairs, row_tsz (n, m) int32)``, ``pairs[c]``
    class c's ``(member, row)`` pairs as an ``(k, 2)`` int64 tensor (in no
    order on a card, ascending in the plain version), ``row_tsz`` each
    pair's table (0: no table); k is 7 (:data:`CLASS_NAMES`), or 8
    (:data:`SYMBOLIC_CLASS_NAMES`) for the symbolic phase with a bitmap
    class.  Arguments are stacked or shared as for
    :func:`batched_numeric_call`; ``numeric=False`` sizes tables from each
    row's product count, ignores ``indptr_c`` (pass ``None``) and needs
    ``n_cols``, B's width, which decides its bitmap class
    (``ref.bitmap_above``).

    On a card it runs the classifying kernel as the class-ordered
    wrappers do (``errors`` as for them); on the CPU
    ``ref.batched_row_classes_plain``.
    """
    n = n_members
    n_cols = None if numeric else ref.need_width(n_cols)
    if a_idx.device.type == "cpu":
        CLASS_CALLS["plain"] += 1
        return ref.batched_row_classes_plain(
            offsets, bin_tsize, indptr_a, indptr_b, indptr_c, a_idx,
            n_members=n, table_size=table_size, numeric=numeric,
            n_cols=n_cols)
    dev = a_idx.device
    args = {"offsets": offsets, "bin_tsize": bin_tsize,
            "indptr_a": indptr_a, "indptr_b": indptr_b, "a_idx": a_idx}
    if numeric:
        args["indptr_c"] = indptr_c
    for name, t in args.items():
        _build.check_tensor(name, t, torch.int32, dev)
    strides = _strides(args, n)
    own = errors is None
    if own:
        errors = torch.zeros(1, dtype=torch.int32, device=dev)
    _build.check_tensor("errors", errors, torch.int32, dev)
    build()
    m = indptr_a.shape[-1] - 1
    if numeric:
        m = min(m, indptr_c.shape[-1] - 1)
    largest = fleet_table(_host_rows(offsets, n), _host_rows(bin_tsize, n),
                          table_size, m, False)
    fleet = _fleet(args, strides, n=n, m=m, table_size=table_size,
                   n_cols=n_cols)
    n_all = len(SYMBOLIC_CLASS_NAMES if fleet.bitmap_above else CLASS_NAMES)
    classes = launch_classes(largest, fleet.bitmap_above)
    if not classes or n * m == 0:
        empty = torch.zeros(0, 2, dtype=torch.int64, device=dev)
        return (torch.zeros(n_all, dtype=torch.int32, device=dev),
                [empty] * n_all,
                torch.zeros(n, m, dtype=torch.int32, device=dev))
    counts, lst, row_tsz = _classify(numeric, fleet, classes, errors, dev)
    if own:
        _build.raise_on_errors(errors, "spgemm_hash classify")
    pairs = [torch.stack((x // m, x % m), 1).long()
             for x in _class_lists(counts, lst)[:n_all]]
    return (counts[:n_all].clone(), pairs,
            row_tsz[:n * m].view(n, m).clone())


def symbolic_call(offsets, bin_tsize, indptr_a, indptr_b, a_idx, a_val,
                  b_idx, b_val, *, table_size: int, vector: bool,
                  errors: torch.Tensor | None = None,
                  n_cols: int) -> torch.Tensor:
    """Distinct columns per output row, ``(m,) int32``.

    On a card the rows run by class as :func:`numeric_call`'s do (one
    classifying launch, then one launch per class the schedule's largest
    table allows), each row's table sized from its product count.
    ``n_cols``: B's width.  Where B has at most ``ref.BITMAP_COLS``
    columns, the rows whose table would pass ``ref.bitmap_above(n_cols)``
    slots count their columns in a bitmap; past it they take the larger
    table classes: clusters and device memory.

    ``errors`` (CUDA only): a 1-element int32 tensor that gains one per
    probe that found its table full (a bitmap row: one when its count
    passes its table) -- zero on every valid plan.  Without it the wrapper
    reads its own count after the launch and raises if it is not zero.
    """
    if a_idx.device.type == "cpu":
        KERNEL_CALLS["plain"] += 1
        return ref.symbolic_plain(offsets, bin_tsize, indptr_a, indptr_b,
                                  a_idx, a_val, b_idx, b_val,
                                  table_size=table_size, vector=vector)
    m = indptr_a.shape[0] - 1
    dev = a_idx.device
    row_nnz = torch.zeros(m, dtype=torch.int32, device=dev)
    own = errors is None
    if own:
        errors = torch.zeros(1, dtype=torch.int32, device=dev)
    _check_operands(indptr_a, indptr_b, a_idx, a_val, b_idx, b_val, None,
                    errors)
    args = {"offsets": offsets, "bin_tsize": bin_tsize,
            "indptr_a": indptr_a, "indptr_b": indptr_b, "a_idx": a_idx,
            "a_val": a_val, "b_idx": b_idx, "b_val": b_val}
    _launch_single(False, vector, args, errors, table_size=table_size,
                   row_nnz=row_nnz, n_cols=n_cols)
    KERNEL_CALLS["symbolic_vector" if vector else "symbolic"] += 1
    if own:
        _build.raise_on_errors(errors, "spgemm_hash symbolic")
    return row_nnz


def numeric_call(offsets, bin_tsize, indptr_a, indptr_b, indptr_c, a_idx,
                 a_val, b_idx, b_val, *, cap_c: int, table_size: int,
                 vector: bool, errors: torch.Tensor | None = None):
    """``(cols (cap_c,) int32, vals (cap_c,) float32)``: each row's
    entries at ``indptr_c``, unsorted, the tail zero.

    ``errors`` (CUDA only): a 1-element int32 tensor that gains one per
    row whose flushed count disagrees with ``indptr_c`` and per probe that
    found its table full -- zero on every valid plan.  Without it the
    wrapper reads its own count after the launch and raises if it is not
    zero.
    """
    if a_idx.device.type == "cpu":
        KERNEL_CALLS["plain"] += 1
        return ref.numeric_plain(offsets, bin_tsize, indptr_a, indptr_b,
                                 indptr_c, a_idx, a_val, b_idx, b_val,
                                 cap_c=cap_c, table_size=table_size,
                                 vector=vector)
    dev = a_idx.device
    out_cols = torch.zeros(cap_c, dtype=torch.int32, device=dev)
    out_vals = torch.zeros(cap_c, dtype=torch.float32, device=dev)
    own = errors is None
    if own:
        errors = torch.zeros(1, dtype=torch.int32, device=dev)
    _check_operands(indptr_a, indptr_b, a_idx, a_val, b_idx, b_val,
                    indptr_c, errors)
    args = dict(zip(ARG_NAMES, (offsets, bin_tsize, indptr_a, indptr_b,
                                indptr_c, a_idx, a_val, b_idx, b_val)))
    _launch_single(True, vector, args, errors, table_size=table_size,
                   cap_c=cap_c, out_cols=out_cols, out_vals=out_vals)
    KERNEL_CALLS["numeric_vector" if vector else "numeric"] += 1
    if own:
        _build.raise_on_errors(errors, "spgemm_hash numeric")
    return out_cols, out_vals


def _host_rows(t, n: int) -> list:
    """A schedule array as host lists, one per member (a shared 1-D array
    repeated)."""
    rows = t.tolist()
    return rows if t.dim() == 2 else [rows] * n


def _strides(args: dict, n: int) -> dict:
    """A batched wrapper's arguments (:data:`ARG_NAMES` -> tensor) checked
    for ``n >= 1`` members: name -> member stride
    (:func:`_build.member_stride`; every argument is 1-D when shared).
    Unlike :func:`_build.member_layout` it makes no member views: they
    cost ``core.batch``'s executor host time on every class launch."""
    if n < 1:
        raise ValueError(f"n_members must be at least 1, got {n}")
    return {name: _build.member_stride(name, t, 1, n)
            for name, t in args.items()}


def _batched(numeric: bool, args: dict, strides: dict, *, n_members: int,
             cap_c: int, table_size: int, vector: bool, errors, largest,
             n_cols=None):
    """Run one phase over every member by table class: one classifying
    launch, then one launch per class that the fleet's largest table
    allows, each over every member's rows of its class.

    ``args``: :data:`ARG_NAMES` (without ``indptr_c`` for the symbolic
    phase) -> tensor, each stacked or shared, with :func:`_strides`'
    ``strides``; ``largest``: :func:`fleet_table` of the schedule, or
    ``None`` to read it back here; ``n_cols``: B's width (symbolic, for
    the bitmap class).  Returns ``row_nnz (n, m)`` (symbolic) or ``(cols,
    vals)``, each ``(n, cap_c)`` (numeric).
    """
    dev = args["a_idx"].device
    for name, t in args.items():
        _build.check_tensor(name, t, torch.float32 if name.endswith("_val")
                            else torch.int32, dev)
    if args["a_val"].shape[-1] != args["a_idx"].shape[-1] or \
            args["b_val"].shape[-1] != args["b_idx"].shape[-1]:
        raise ValueError("values and column ids of an operand differ in "
                         "shape")
    if errors is not None:
        _build.check_tensor("errors", errors, torch.int32, dev)
    build()
    n = n_members
    n_rows = args["indptr_a"].shape[-1] - 1
    if numeric:
        n_rows = min(n_rows, args["indptr_c"].shape[-1] - 1)
    if largest is None:
        largest = fleet_table(_host_rows(args["offsets"], n),
                              _host_rows(args["bin_tsize"], n),
                              table_size, n_rows, vector)
    if numeric:
        out_cols = torch.zeros(n, cap_c, dtype=torch.int32, device=dev)
        out_vals = torch.zeros(n, cap_c, dtype=torch.float32, device=dev)
        row_nnz = None
    else:
        out_cols = out_vals = None
        row_nnz = torch.zeros(n, n_rows, dtype=torch.int32, device=dev)
    own = errors is None
    if own:
        errors = torch.zeros(1, dtype=torch.int32, device=dev)
    phase = "numeric" if numeric else "symbolic"
    key = f"batched_{phase}_vector" if vector else f"batched_{phase}"
    fleet = _fleet(args, strides, n=n, m=n_rows, table_size=table_size,
                   cap_c=cap_c, out_cols=out_cols, out_vals=out_vals,
                   row_nnz=row_nnz, n_cols=None if numeric else n_cols)
    KERNEL_CALLS[key] += _run_classes(numeric, vector, fleet, largest,
                                      errors, dev)
    if own:
        _build.raise_on_errors(errors, f"spgemm_hash batched {phase}")
    return (out_cols, out_vals) if numeric else row_nnz


def batched_symbolic_call(offsets, bin_tsize, indptr_a, indptr_b, a_idx,
                          a_val, b_idx, b_val, *, n_members: int,
                          table_size: int, vector: bool,
                          errors: torch.Tensor | None = None,
                          largest: int | None = None,
                          n_cols: int) -> torch.Tensor:
    """:func:`symbolic_call` for every member of a fleet: ``(n, m)
    int32``, member e's distinct columns per row of ``A_e @ B_e``.

    Each array argument either has a leading member axis of ``n_members``
    or has :func:`symbolic_call`'s shape and is shared by every member: it
    goes to the kernel as it is, read in place with member stride 0, and
    is never copied per member (a value fleet on one plan shares its
    schedule and index arrays).  Every member's rows run by table class,
    each row's table sized from its product count: one classifying launch,
    then one launch per class that ``largest`` allows
    (:func:`launch_classes`).  ``largest``: :func:`fleet_table` of this
    schedule; without it the wrapper reads the bins back and computes it.
    ``n_cols`` (B's width, every member's) and ``errors`` as for
    :func:`symbolic_call`, one counter for all members.
    """
    args = dict(zip(ARG_NAMES[:4] + ARG_NAMES[5:],
                    (offsets, bin_tsize, indptr_a, indptr_b, a_idx, a_val,
                     b_idx, b_val)))
    strides = _strides(args, n_members)
    if a_idx.device.type == "cpu":
        KERNEL_CALLS["batched_plain"] += 1
        return ref.batched_symbolic_plain(*args.values(),
                                          n_members=n_members,
                                          table_size=table_size,
                                          vector=vector)
    return _batched(False, args, strides, n_members=n_members, cap_c=0,
                    table_size=table_size, vector=vector, errors=errors,
                    largest=largest, n_cols=n_cols)


def batched_numeric_call(offsets, bin_tsize, indptr_a, indptr_b, indptr_c,
                         a_idx, a_val, b_idx, b_val, *, n_members: int,
                         cap_c: int, table_size: int, vector: bool,
                         errors: torch.Tensor | None = None,
                         largest: int | None = None):
    """:func:`numeric_call` for every member of a fleet:
    ``(cols (n, cap_c) int32, vals (n, cap_c) float32)``.

    Each array argument is stacked or shared as for
    :func:`batched_symbolic_call`: ``core.batch`` stacks a class's
    schedules and ``indptr_c`` per member, a value fleet on one plan
    shares them.  Rows run by table class as there, each row's table
    sized from its output count.  ``largest`` and ``errors`` as there (a
    plan computes ``largest`` once from its host lists).
    """
    args = dict(zip(ARG_NAMES, (offsets, bin_tsize, indptr_a, indptr_b,
                                indptr_c, a_idx, a_val, b_idx, b_val)))
    strides = _strides(args, n_members)
    if a_idx.device.type == "cpu":
        KERNEL_CALLS["batched_plain"] += 1
        return ref.batched_numeric_plain(
            *args.values(), n_members=n_members, cap_c=cap_c,
            table_size=table_size, vector=vector)
    return _batched(True, args, strides, n_members=n_members, cap_c=cap_c,
                    table_size=table_size, vector=vector, errors=errors,
                    largest=largest)
