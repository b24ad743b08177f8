"""Hand-written CUDA hash SpGEMM kernels (paper Figs. 7 and 8) and their
wrappers.

``csrc/spgemm_hash.cu`` replaces the Pallas kernels of
``repro/kernels/spgemm_hash/kernel.py`` (``numeric_call``,
``symbolic_call``, the ``_probe_vector`` mode of both, and
``batched_symbolic_call`` and ``batched_numeric_call``, the two phases over
a fleet); its header says how the design maps the TPU's sequential bin
grid onto the card.  It is
compiled with ``nvcc`` for ``sm_90a`` at first use, into a shared library
with a plain C interface under ``build/torch_ext/`` at the root of the
checkout, and loaded with ``ctypes``.  Nothing is compiled at import, so
the module imports on a machine without CUDA.

:func:`symbolic_call` and :func:`numeric_call` take the reference
builders' arguments; :func:`batched_symbolic_call` and
:func:`batched_numeric_call` take them with a member axis on any of them.
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

#: Launch counters.  A wrapper adds one where it launches its kernel (one
#: call covers every bin; the batched counters add one per CUDA launch,
#: which is one per bin index that holds rows in any member).  ``plain``
#: counts the single-product wrappers' runs of the plain versions and
#: ``batched_plain`` the batched wrappers' -- zero on a card proves the
#: main path never took them.
KERNEL_CALLS = {"symbolic": 0, "numeric": 0, "symbolic_vector": 0,
                "numeric_vector": 0, "batched_symbolic": 0,
                "batched_symbolic_vector": 0, "batched_numeric": 0,
                "batched_numeric_vector": 0, "plain": 0, "batched_plain": 0}

#: Largest table kept in shared memory: 16,384 slots, 128 KB of key+value.
SMEM_SLOTS = 16384
#: Blocks that share the global-memory tables of a bin with larger tables.
GLOBAL_BLOCKS = 264

SOURCE = Path(__file__).parent / "csrc" / "spgemm_hash.cu"
_P, _L = ctypes.c_void_p, ctypes.c_longlong
_FUNCTIONS = {
    "spgemm_hash_launch": [ctypes.c_int] * 9 + [_P] * 14,
    # ints; each array's pointer before its member stride; outputs, errors,
    # workspace and the stream
    "spgemm_hash_batched_launch":
        [ctypes.c_int] * 12 + [_P, _L] * 9 + [_P] * 7,
}

#: The array arguments of :func:`numeric_call`, in order.  An argument of
#: :func:`batched_numeric_call` has a leading member axis or is 1-D and
#: shared by every member; :func:`batched_symbolic_call` takes the same
#: arrays but ``indptr_c``.
ARG_NAMES = ("offsets", "bin_tsize", "indptr_a", "indptr_b", "indptr_c",
             "a_idx", "a_val", "b_idx", "b_val")
#: the C interface's order of the arrays
_C_ORDER = ("offsets", "bin_tsize", "indptr_a", "a_idx", "a_val",
            "indptr_b", "b_idx", "b_val", "indptr_c")
_lib = None


def build() -> dict:
    """Compile (if this source was not built yet) and load the library;
    returns :func:`repro_torch.kernels._build.load`'s record."""
    global _lib
    info = _build.load(SOURCE, _FUNCTIONS)
    _lib = info["lib"]
    return info


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_bins(numeric, vector, offsets, bin_tsize, table_size, indptr_a,
                 indptr_b, a_idx, a_val, b_idx, b_val, indptr_c, out_cols,
                 out_vals, row_nnz, errors):
    cap_c = 0 if out_cols is None else out_cols.shape[0]
    dev = a_idx.device
    for name, t in (("indptr_a", indptr_a), ("indptr_b", indptr_b),
                    ("a_idx", a_idx), ("b_idx", b_idx)):
        _build.check_tensor(name, t, torch.int32, dev)
    for name, t in (("a_val", a_val), ("b_val", b_val)):
        _build.check_tensor(name, t, torch.float32, dev)
    if indptr_c is not None:
        _build.check_tensor("indptr_c", indptr_c, torch.int32, dev)
    _build.check_tensor("errors", errors, torch.int32, dev)
    build()
    bounds = offsets.tolist()
    sizes = bin_tsize.tolist()
    m = indptr_a.shape[0] - 1
    if len(bounds) != len(sizes) + 1 or \
            any(not 0 <= r0 <= r1 <= m for r0, r1 in zip(bounds, bounds[1:])):
        raise ValueError(f"bin offsets {bounds} do not partition {m} rows "
                         f"into {len(sizes)} bins")
    stream = torch.cuda.current_stream(dev).cuda_stream
    for b, tsz in enumerate(sizes):
        r0, r1 = bounds[b], bounds[b + 1]
        if r1 <= r0:
            continue
        tsz = min(int(tsz), table_size)
        if tsz < 1 or tsz & (tsz - 1) or (vector and tsz < CHUNK):
            raise ValueError(f"bin {b}: table size {tsz} is not a power of "
                             f"two{' >= CHUNK' if vector else ''}")
        ws_keys = ws_vals = None
        if tsz <= SMEM_SLOTS:
            grid, smem = r1 - r0, tsz * (8 if numeric else 4)
            block = 64 if tsz <= 256 else (128 if tsz <= 4096 else 256)
        else:
            grid, smem, block = min(r1 - r0, GLOBAL_BLOCKS), 0, 512
            ws_keys = torch.empty(grid * tsz, dtype=torch.int32, device=dev)
            if numeric:
                ws_vals = torch.empty(grid * tsz, dtype=torch.float32,
                                      device=dev)
        err = _lib.spgemm_hash_launch(
            int(numeric), int(vector), r0, r1, tsz, cap_c, grid, block, smem,
            _ptr(indptr_a), _ptr(a_idx), _ptr(a_val), _ptr(indptr_b),
            _ptr(b_idx), _ptr(b_val), _ptr(indptr_c), _ptr(out_cols),
            _ptr(out_vals), _ptr(row_nnz), _ptr(errors), _ptr(ws_keys),
            _ptr(ws_vals), stream)
        if err != 0:
            raise RuntimeError(f"spgemm_hash launch failed for bin {b}: "
                               f"CUDA error {err}")


def symbolic_call(offsets, bin_tsize, indptr_a, indptr_b, a_idx, a_val,
                  b_idx, b_val, *, table_size: int, vector: bool,
                  errors: torch.Tensor | None = None) -> torch.Tensor:
    """Distinct columns per output row, ``(m,) int32``.

    ``errors`` (CUDA only): a 1-element int32 tensor that gains one per
    probe that found its table full -- zero on every valid plan.  Without
    it the wrapper reads its own count after the launch and raises if it
    is not zero.
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
    _launch_bins(False, vector, offsets, bin_tsize, table_size, indptr_a,
                 indptr_b, a_idx, a_val, b_idx, b_val, None, None, None,
                 row_nnz, errors)
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
    _launch_bins(True, vector, offsets, bin_tsize, table_size, indptr_a,
                 indptr_b, a_idx, a_val, b_idx, b_val, indptr_c, out_cols,
                 out_vals, None, errors)
    KERNEL_CALLS["numeric_vector" if vector else "numeric"] += 1
    if own:
        _build.raise_on_errors(errors, "spgemm_hash numeric")
    return out_cols, out_vals


def batched_launches(bounds, sizes, table_size: int, n_rows: int,
                     vector: bool, *, smem_slots: int = SMEM_SLOTS) -> list:
    """The launches of a batched kernel, either phase, from the fleet's
    bins as host lists: ``bounds[e]`` is member e's bin offsets,
    ``sizes[e]`` its per-bin table sizes.  (A symbolic table holds keys
    only, 4 bytes a slot against the numeric 8, but the kernel keeps the
    same geometry for both, as the single-product kernels do.)

    Returns one ``{"bin", "grid_x", "block", "smem_slots", "ws_tsz"}`` per
    bin index that holds rows in any member.  Member e of bin b probes
    ``min(sizes[e][b], table_size)`` slots: shared memory holds the largest
    such table up to ``smem_slots`` (:data:`SMEM_SLOTS` for this module's
    kernel; the BCSR kernel passes what its tiles leave room for), and the
    members with larger tables use a global workspace of ``ws_tsz`` slots
    per member and x block.  ``block`` is this module's kernel's thread
    count.  Without a workspace there is one x block per row
    of the member with the most rows in the bin; with one, the x blocks
    are capped so that ``grid_x * n_members <= GLOBAL_BLOCKS`` (at least
    one per member), which bounds the workspace as the single-product
    kernel's.  Raises ``ValueError`` for bins that do not partition
    ``n_rows`` rows or tables that are not powers of two (at least
    :data:`CHUNK` in vector mode).
    """
    n = len(bounds)
    if not 0 < n <= 65535 or len(sizes) != n:
        raise ValueError(f"a fleet of {n} members with {len(sizes)} bin "
                         f"size lists (1 to 65,535 members)")
    n_bins = len(sizes[0])
    for e, (bd, sz) in enumerate(zip(bounds, sizes)):
        if len(bd) != n_bins + 1 or len(sz) != n_bins or any(
                not 0 <= r0 <= r1 <= n_rows for r0, r1 in zip(bd, bd[1:])):
            raise ValueError(f"member {e}: bin offsets {bd} do not "
                             f"partition {n_rows} rows into {n_bins} bins")
    launches = []
    for b in range(n_bins):
        rows = smem = ws = 0
        for e in range(n):
            r0, r1 = bounds[e][b], bounds[e][b + 1]
            if r1 <= r0:
                continue
            tsz = min(int(sizes[e][b]), table_size)
            if tsz < 1 or tsz & (tsz - 1) or (vector and tsz < CHUNK):
                raise ValueError(
                    f"member {e}, bin {b}: table size {tsz} is not a power "
                    f"of two{' >= CHUNK' if vector else ''}")
            rows = max(rows, r1 - r0)
            if tsz <= smem_slots:
                smem = max(smem, tsz)
            else:
                ws = max(ws, tsz)
        if not rows:
            continue
        if ws:
            grid_x, block = min(rows, max(1, GLOBAL_BLOCKS // n)), 512
        else:
            grid_x = rows
            block = 64 if smem <= 256 else (128 if smem <= 4096 else 256)
        launches.append({"bin": b, "grid_x": grid_x, "block": block,
                         "smem_slots": smem, "ws_tsz": ws})
    return launches


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
             cap_c: int, table_size: int, vector: bool, errors, launches):
    """Launch the batched kernel of one phase over every member.

    ``args``: :data:`ARG_NAMES` (without ``indptr_c`` for the symbolic
    phase) -> tensor, each stacked or shared, with :func:`_strides`'
    ``strides``.  Returns ``row_nnz (n, m)`` (symbolic) or ``(cols,
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
    if launches is None:
        launches = batched_launches(_host_rows(args["offsets"], n),
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
    stream = torch.cuda.current_stream(dev).cuda_stream
    phase = "numeric" if numeric else "symbolic"
    key = f"batched_{phase}_vector" if vector else f"batched_{phase}"
    pairs = [v for name in _C_ORDER
             for v in (_ptr(args.get(name)), strides.get(name, 0))]
    for launch in launches:
        ws_keys = ws_vals = None
        if launch["ws_tsz"]:
            slots = launch["grid_x"] * n * launch["ws_tsz"]
            ws_keys = torch.empty(slots, dtype=torch.int32, device=dev)
            if numeric:
                ws_vals = torch.empty(slots, dtype=torch.float32,
                                      device=dev)
        err = _lib.spgemm_hash_batched_launch(
            int(numeric), int(vector), launch["bin"], n_rows, table_size,
            launch["smem_slots"], launch["ws_tsz"], cap_c, launch["grid_x"],
            n, launch["block"], launch["smem_slots"] * (8 if numeric else 4),
            *pairs, _ptr(out_cols), _ptr(out_vals), _ptr(row_nnz),
            _ptr(errors), _ptr(ws_keys), _ptr(ws_vals), stream)
        if err != 0:
            raise RuntimeError(f"spgemm_hash batched {phase} launch failed "
                               f"for bin {launch['bin']}: CUDA error {err}")
        KERNEL_CALLS[key] += 1
    if own:
        _build.raise_on_errors(errors, f"spgemm_hash batched {phase}")
    return (out_cols, out_vals) if numeric else row_nnz


def batched_symbolic_call(offsets, bin_tsize, indptr_a, indptr_b, a_idx,
                          a_val, b_idx, b_val, *, n_members: int,
                          table_size: int, vector: bool,
                          errors: torch.Tensor | None = None,
                          launches: list | None = None) -> torch.Tensor:
    """:func:`symbolic_call` for every member of a fleet: ``(n, m)
    int32``, member e's distinct columns per row of ``A_e @ B_e``.

    Each array argument either has a leading member axis of ``n_members``
    or has :func:`symbolic_call`'s shape and is shared by every member: it
    goes to the kernel as it is, read in place with member stride 0, and
    is never copied per member (a value fleet on one plan shares its
    schedule and index arrays).  ``launches``: :func:`batched_launches` of
    this schedule; without it the wrapper reads the bins back and computes
    it.  ``errors`` as for :func:`symbolic_call`, one counter for all
    members.
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
                    launches=launches)


def batched_numeric_call(offsets, bin_tsize, indptr_a, indptr_b, indptr_c,
                         a_idx, a_val, b_idx, b_val, *, n_members: int,
                         cap_c: int, table_size: int, vector: bool,
                         errors: torch.Tensor | None = None,
                         launches: list | None = None):
    """:func:`numeric_call` for every member of a fleet:
    ``(cols (n, cap_c) int32, vals (n, cap_c) float32)``.

    Each array argument is stacked or shared as for
    :func:`batched_symbolic_call`: ``core.batch`` stacks a class's
    schedules and ``indptr_c`` per member, a value fleet on one plan
    shares them.  ``launches`` and ``errors`` as there (a plan computes
    ``launches`` once from its host lists).  (The kernel itself checks
    each member's bins against the rows it is given.)
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
                    launches=launches)
