"""Hand-written CUDA block-row hash SpGEMM kernel over BCSR and its
wrapper.

``csrc/spgemm_bcsr.cu`` replaces the Pallas kernels ``numeric_call`` (with
its scalar and vector probes) and ``batched_numeric_call`` (the same over
a fleet of members) of ``repro/kernels/spgemm_bcsr/kernel.py``; its header
says how the design maps the TPU's sequential grids onto the card.  Every
block row probes a table sized from its own output count; the kernel runs
work items by class (:data:`CLASS_NAMES`) -- a block row of one member,
or of a group of members where the fleet shares every index array: two
classifying kernels, which replace no TPU kernel, list each class's items
in device memory, longest A-block count first, and one persistent launch
per class that can hold items runs them -- tables in one block's shared
memory of four sizes, larger ones in device memory.  The single product
is the fleet of one member.  It is built like the other kernels
(:mod:`repro_torch.kernels._build`): ``nvcc`` for ``sm_90a`` at first
use, a plain C interface, ``ctypes``.

:func:`numeric_call` takes the arguments of the reference's compiled
``numeric_call``, and :func:`batched_numeric_call` takes them with a
member axis on any of them; :func:`row_classes` and
:func:`batched_row_classes` are the classifying kernels alone, and
:func:`prepare`, :func:`classify`, :func:`launch_class` and :func:`run`
the steps of one call, for measurement.
On CPU tensors they run the plain versions of ``ref.py``; on CUDA tensors
they launch the kernel or raise -- a build or launch failure is never
answered with the plain version.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build
from . import ref

#: Launch counters.  ``numeric``/``numeric_vector`` gain one where
#: :func:`numeric_call` launches its kernels, ``batched_numeric`` /
#: ``batched_numeric_vector`` one where :func:`batched_numeric_call` does
#: (one call covers every row of every member: one classification and the
#: class launches of :data:`CLASS_CALLS`), ``plain`` / ``batched_plain``
#: where they run their plain versions, and ``symbolic`` where
#: ``ops.bcsr_inspect`` runs a block-level inspection (which launches the
#: hash symbolic kernel, counted by that kernel's own counters).
KERNEL_CALLS = {"symbolic": 0, "numeric": 0, "numeric_vector": 0,
                "plain": 0, "batched_numeric": 0,
                "batched_numeric_vector": 0, "batched_plain": 0}

#: The kernel's item classes (``ref.CLASS_SMEM``): staged in 30 / 54 /
#: 111 / 225 KB of one block's shared memory, or direct (keys in device
#: memory, tiles summed in place in the output).
CLASS_NAMES = ref.CLASS_NAMES
#: Launches of the kernel's parts, single product and fleets alike, extra
#: to :data:`KERNEL_CALLS` (one count a call stays the proof of path):
#: ``classify`` per run of the classifying kernels, one per class launch
#: under its :data:`CLASS_NAMES` name, ``plain`` per run of
#: :func:`row_classes`' or :func:`batched_row_classes`' plain version.
CLASS_CALLS = dict.fromkeys(("classify",) + CLASS_NAMES + ("plain",), 0)

#: Blocks of the direct class, each with a workspace of keys and map.
GLOBAL_BLOCKS = 264
#: The classifying kernels' counts: one per (class, A-block bucket), then
#: each class kernel's pop counter.
_N_COUNTS = len(CLASS_NAMES) * (ref.LEN_BUCKETS + 1)
_N_KEYS = len(CLASS_NAMES) * ref.LEN_BUCKETS
#: (member, row) pairs a fleet may have: the item lists hold int32 ids.
MAX_PAIRS = 2 ** 31 - 1

#: The array arguments of :func:`numeric_call`, in order, and their
#: dimensions.  An argument of :func:`batched_numeric_call` has one more (a
#: leading member axis), or has these and is shared by every member.
ARG_NAMES = ("offsets", "bin_tsize", "indptr_a", "indptr_b", "indptr_c",
             "a_bcol", "a_blk", "b_bcol", "b_blk")
ARG_DIMS = (1, 1, 1, 1, 1, 1, 3, 1, 3)

SOURCE = Path(__file__).parent / "csrc" / "spgemm_bcsr.cu"
_P, _L = ctypes.c_void_p, ctypes.c_longlong


class _Fleet(ctypes.Structure):
    """The source's ``Fleet``: each array's address and member stride, the
    outputs, the sizes, the tile shape, whether A's / B's tiles may be
    copied 16 bytes at a time, and whether every index array is shared."""
    _fields_ = ([(f"{name}{sfx}", t) for name in (
        "offsets", "bin_tsize", "indptr_a", "a_bcol", "a_blk", "indptr_b",
        "b_bcol", "b_blk", "indptr_c") for sfx, t in (("", _P), ("_s", _L))]
        + [("out_bcol", _P), ("out_blk", _P)]
        + [(name, ctypes.c_int) for name in (
            "n", "m", "n_bins", "table_size", "bcap_c", "b_bcol_len", "bm",
            "bk", "bn", "a16", "b16", "grouped")])


_FLEET = ctypes.POINTER(_Fleet)
_FUNCTIONS = {
    "spgemm_bcsr_classify": [ctypes.c_int, _FLEET] + [_P] * 4,
    "spgemm_bcsr_class_shape": [ctypes.c_int] * 2 + [_P],
    "spgemm_bcsr_class_launch": [ctypes.c_int] * 5 + [_FLEET] + [_P] * 5,
    "spgemm_bcsr_numeric": [ctypes.c_int, _FLEET] + [ctypes.c_int] * 3
                           + [_P] * 5,
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


def _aligned(t, stride: int) -> int:
    """1 when every member's tiles of ``t`` (``stride`` floats apart) may
    be copied 16 bytes at a time."""
    return int(t.data_ptr() % 16 == 0 and stride % 4 == 0)


#: The position in :data:`ARG_NAMES` of each array of the source's
#: ``Fleet``, in its order, and of the index arrays.
_FLEET_ORDER = (0, 1, 2, 5, 6, 3, 7, 8, 4)
_INDEX_AT = (0, 1, 2, 3, 4, 5, 7)


class Call:
    """One call of the kernel, prepared (:func:`prepare`): the ``Fleet``
    the C interface takes, the outputs, one zeroed allocation of ints (the
    members' block columns, the own ``errors`` count, the classes' counts
    and pop counters, the classifier's work), the classes to launch and
    the direct class's workspace.  ``args``: the arrays in
    :data:`ARG_NAMES` order (None for tiles the call does not take),
    ``strides`` their member strides; ``bcap_c`` None: the classifying
    kernels alone (no outputs, no class to launch)."""

    __slots__ = ("n", "m", "vector", "grouped", "units", "ints", "errors",
                 "out_bcol", "out_blk", "fleet", "classes", "ws_keys",
                 "stream", "ptrs", "_at")

    def __init__(self, args, strides, *, n: int, bcap_c, table_size: int,
                 vector: bool, errors, block):
        dev = args[5].device
        m = args[2].shape[-1] - 1
        self.n, self.m, self.vector = n, m, bool(vector)
        self.grouped = grouped = not any(strides[i] for i in _INDEX_AT)
        pairs = n * m
        self.units = units = m if grouped else pairs
        work = 4 * units + pairs if pairs <= MAX_PAIRS else 0
        outputs = bcap_c is not None
        bcap_c = bcap_c or 0
        at = self._at = n * bcap_c
        # one zeroed allocation: out_bcol, the own errors count, the
        # classes' counts and pop counters, the classifier's work
        self.ints = ints = torch.zeros(at + 1 + _N_COUNTS + work,
                                       dtype=torch.int32, device=dev)
        self.out_bcol = ints[:at].view(n, bcap_c)
        bm, bk, bn = block
        self.out_blk = torch.zeros((n, bcap_c, bm, bn), dtype=torch.float32,
                                   device=dev) if outputs else None
        base = ints.data_ptr()
        self.errors = ints[at:at + 1] if errors is None else errors
        counts = base + 4 * (at + 1)
        fields = []
        for i in _FLEET_ORDER:
            fields += (_ptr(args[i]), strides[i])
        a16 = 0 if args[6] is None else _aligned(args[6], strides[6])
        b16 = 0 if args[8] is None else _aligned(args[8], strides[8])
        self.fleet = _Fleet(
            *fields, base, _ptr(self.out_blk), n, m, args[1].shape[-1],
            table_size, bcap_c, args[7].shape[-1] if args[7] is not None
            else 0, bm, bk, bn, a16, b16, int(grouped))
        self.classes = ref.launch_classes(
            block, table_size, bcap_c, n if grouped else 1,
            (strides[6] != 0, strides[8] != 0)) if outputs and pairs else ()
        self.ws_keys = None
        if len(CLASS_NAMES) - 1 in self.classes:
            self.ws_keys = torch.empty(GLOBAL_BLOCKS * 2 * table_size,
                                       dtype=torch.int32, device=dev)
        self.ptrs = (counts, counts + 4 * _N_COUNTS, self.errors.data_ptr(),
                     _ptr(self.ws_keys))
        self.stream = torch.cuda.current_stream(dev).cuda_stream

    @property
    def counts(self):
        """The classes' counts per (class, A-block bucket), then their pop
        counters."""
        return self.ints[self._at + 1:self._at + 1 + _N_COUNTS]

    @property
    def work(self):
        """The classifier's work: each unit's table, key, rank and group,
        then the item list."""
        return self.ints[self._at + 1 + _N_COUNTS:]

    def items(self) -> list:
        """Each class's items as ``(k, 3)`` int64 ``(first member,
        members, row)`` in pop order, from the classifier's counts and
        list (a host read)."""
        n, m, units, work = self.n, self.m, self.units, self.work
        per = self.counts[:_N_KEYS].view(len(CLASS_NAMES), -1).sum(1)
        ids = work[4 * units:4 * units + int(per.sum())].long()
        x, row = ids // max(m, 1), ids % max(m, 1)
        if self.grouped:
            g = work[3 * units:4 * units].long()[row]
            first = x * g
            members = torch.minimum(g, n - first)
        else:
            first, members = x, torch.ones_like(x)
        out = torch.stack((first, members, row), 1)
        return list(out.split(per.tolist()))


def prepare(offsets, bin_tsize, indptr_a, indptr_b, indptr_c, a_bcol, a_blk,
            b_bcol, b_blk, *, n_members: int, bcap_c: int, table_size: int,
            vector: bool, errors: torch.Tensor | None = None) -> Call:
    """A call of :func:`batched_numeric_call`'s kernels on these
    arguments, checked and allocated but not launched (``errors`` as
    there; without it the call's own count)."""
    args = (offsets, bin_tsize, indptr_a, indptr_b, indptr_c, a_bcol, a_blk,
            b_bcol, b_blk)
    strides, views = _build.member_layout(ARG_NAMES, args, ARG_DIMS,
                                          n_members)
    return _prepare(args, strides, views, n_members, bcap_c, table_size,
                    vector, errors)


def _prepare(args, strides, views, n, bcap_c, table_size, vector,
             errors) -> Call:
    """:func:`prepare` with the member layout known: ``views`` are member
    0's arrays."""
    dev = args[5].device
    _build.check_tensor("offsets", views[0], torch.int32, dev)
    _build.check_tensor("bin_tsize", views[1], torch.int32, dev)
    _check_operands(*views[2:])
    if errors is not None:
        _build.check_tensor("errors", errors, torch.int32, dev)
    build()
    a_blk, b_blk = args[6], args[8]
    return Call(args, strides, n=n, bcap_c=bcap_c, table_size=table_size,
                vector=vector, errors=errors,
                block=(a_blk.shape[-2], a_blk.shape[-1], b_blk.shape[-1]))


def classify(call: Call) -> None:
    """The classifying kernels of ``call``: every class's items listed
    (``call.counts`` zero, as :func:`prepare` leaves them)."""
    counts, work, errors, _ = call.ptrs
    err = _lib.spgemm_bcsr_classify(int(call.vector),
                                    ctypes.byref(call.fleet), counts, work,
                                    errors, call.stream)
    if err != 0:
        raise RuntimeError(f"spgemm_bcsr classify launch failed: CUDA "
                           f"error {err}")
    CLASS_CALLS["classify"] += 1


def launch_class(call: Call, cls: int, *, pdl: bool = False) -> None:
    """Class ``cls``'s persistent launch over the items :func:`classify`
    listed (the class's pop counter, ``call.counts[_N_KEYS + cls]``, must
    be zero); ``pdl``: as a programmatic dependent of the launch before
    it."""
    err = _lib.spgemm_bcsr_class_launch(
        int(call.vector), cls, int(pdl), GLOBAL_BLOCKS,
        call.fleet.table_size, ctypes.byref(call.fleet), *call.ptrs,
        call.stream)
    if err != 0:
        raise RuntimeError(f"spgemm_bcsr launch failed for class "
                           f"{CLASS_NAMES[cls]}: CUDA error {err}")
    CLASS_CALLS[CLASS_NAMES[cls]] += 1


def run(call: Call) -> None:
    """The whole call in one call of the library: the classifying
    kernels, then one persistent launch per class that can hold items
    (``call.classes``), the largest first, the later ones as programmatic
    dependent launches; no host synchronisation."""
    if not call.classes:  # no row, or the classifying kernels alone
        return
    err = _lib.spgemm_bcsr_numeric(
        int(call.vector), ctypes.byref(call.fleet), call.classes[0],
        call.classes[-1], GLOBAL_BLOCKS, *call.ptrs, call.stream)
    if err != 0:
        raise RuntimeError(f"spgemm_bcsr numeric launch failed: CUDA error "
                           f"{err}")
    CLASS_CALLS["classify"] += 1
    for cls in call.classes:
        CLASS_CALLS[CLASS_NAMES[cls]] += 1


def row_classes(offsets, bin_tsize, indptr_a, indptr_b, indptr_c, a_bcol, *,
                table_size: int, vector: bool, block,
                errors: torch.Tensor | None = None):
    """The single product's row classes alone: ``(counts (classes,
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
    args = (offsets, bin_tsize, indptr_a, indptr_b, indptr_c, a_bcol, None,
            None, None)
    counts, items, row_tsz = _classes(args, (0,) * len(ARG_NAMES), 1,
                                      table_size, vector, tuple(block),
                                      errors)
    return counts, [x[:, 2].to(torch.int32) for x in items], row_tsz[0]


def batched_row_classes(offsets, bin_tsize, indptr_a, indptr_b, indptr_c,
                        a_bcol, a_blk, b_bcol, b_blk, *, n_members: int,
                        table_size: int, vector: bool,
                        errors: torch.Tensor | None = None):
    """The classifying kernels alone for a fleet, the arguments as for
    :func:`batched_numeric_call`: ``(counts (classes, LEN_BUCKETS) int32,
    items, unit_tsz (n, m) int32)`` as ``ref.batched_row_classes_plain``
    returns them: ``items[c]`` class c's ``(first member, members, row)``
    (on a card in pop order, free within a bucket), ``unit_tsz`` each
    member's row tables.

    On a card it runs the classifying kernels as the numeric wrapper does
    (``errors`` as there: one per member of each row the table cannot
    hold); on the CPU the plain version.
    """
    args = (offsets, bin_tsize, indptr_a, indptr_b, indptr_c, a_bcol, a_blk,
            b_bcol, b_blk)
    strides, _ = _build.member_layout(ARG_NAMES, args, ARG_DIMS, n_members)
    if a_bcol.device.type == "cpu":
        CLASS_CALLS["plain"] += 1
        return ref.batched_row_classes_plain(
            *args, n_members=n_members, table_size=table_size,
            vector=vector)
    block = (a_blk.shape[-2], a_blk.shape[-1], b_blk.shape[-1])
    return _classes(args[:6] + (None, b_bcol, None), strides, n_members,
                    table_size, vector, block, errors)


def _classes(args, strides, n, table_size, vector, block, errors):
    """The classifying kernels alone on a card, as
    :func:`batched_row_classes` returns them (``args`` in
    :data:`ARG_NAMES` order, the tiles None; ``block``: the tiles'
    shape)."""
    dev = args[5].device
    for name, t in zip(ARG_NAMES, args):
        if t is not None:
            _build.check_tensor(name, t, torch.int32, dev)
    own = errors is None
    if not own:
        _build.check_tensor("errors", errors, torch.int32, dev)
    build()
    call = Call(args, strides, n=n, bcap_c=None, table_size=table_size,
                vector=vector, errors=errors, block=block)
    classify(call)
    if own:
        _build.raise_on_errors(call.errors, "spgemm_bcsr classify")
    grid = call.counts[:_N_KEYS].view(len(CLASS_NAMES), ref.LEN_BUCKETS)
    unit_tsz = call.work[:call.units].clone()
    unit_tsz[call.work[call.units:2 * call.units] < 0] = 0
    if call.grouped:
        unit_tsz = unit_tsz.expand(n, call.m)
    return grid.clone(), call.items(), unit_tsz.reshape(n, call.m).clone()


def _numeric(call: Call, errors, key):
    """Launch a prepared call's kernels and count it under ``key``."""
    run(call)
    KERNEL_CALLS[key] += 1
    if errors is None:
        _build.raise_on_errors(call.errors, "spgemm_bcsr numeric")
    return call.out_bcol, call.out_blk


def numeric_call(offsets, bin_tsize, indptr_a, indptr_b, indptr_c, a_bcol,
                 a_blk, b_bcol, b_blk, *, bcap_c: int, table_size: int,
                 vector: bool, errors: torch.Tensor | None = None):
    """``(out_bcol (bcap_c,) int32, out_blk (bcap_c, bm, bn) float32)``:
    each block row's blocks at ``indptr_c``, block columns unsorted, the
    tail zero.  On a card: :func:`batched_numeric_call`'s kernels at one
    member.

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
    # the fleet of one member: every array shared, member 0's as it is
    args = (offsets, bin_tsize, indptr_a, indptr_b, indptr_c, a_bcol, a_blk,
            b_bcol, b_blk)
    call = _prepare(args, (0,) * len(ARG_NAMES), args, 1, bcap_c,
                    table_size, vector, errors)
    out_bcol, out_blk = _numeric(
        call, errors, "numeric_vector" if vector else "numeric")
    return out_bcol[0], out_blk[0]


def batched_numeric_call(offsets, bin_tsize, indptr_a, indptr_b, indptr_c,
                         a_bcol, a_blk, b_bcol, b_blk, *, n_members: int,
                         bcap_c: int, table_size: int, vector: bool,
                         errors: torch.Tensor | None = None):
    """:func:`numeric_call` for every member of a fleet: ``(out_bcol
    (n, bcap_c) int32, out_blk (n, bcap_c, bm, bn) float32)``.

    Each array argument either has a leading member axis of ``n_members``
    or has :func:`numeric_call`'s shape and is shared by every member: it
    goes to the kernel as it is, read in place with member stride 0, and
    is never copied per member.  One classification lists every member's
    rows by class on the device -- a row of a group of members where
    every index array is shared (a value fleet on one plan: the group
    stages and probes once), else one member's row -- and one persistent
    launch per class that can hold items runs them; the kernels check
    each member's bins against its block rows, and nothing is read back.
    ``errors`` as for :func:`numeric_call`, one counter for all members.
    """
    args = (offsets, bin_tsize, indptr_a, indptr_b, indptr_c, a_bcol, a_blk,
            b_bcol, b_blk)
    if a_bcol.device.type == "cpu":
        _build.member_layout(ARG_NAMES, args, ARG_DIMS, n_members)
        KERNEL_CALLS["batched_plain"] += 1
        return ref.batched_numeric_plain(
            *args, n_members=n_members, bcap_c=bcap_c,
            table_size=table_size, vector=vector)
    call = prepare(*args, n_members=n_members, bcap_c=bcap_c,
                   table_size=table_size, vector=vector, errors=errors)
    return _numeric(call, errors, "batched_numeric_vector" if vector
                    else "batched_numeric")
