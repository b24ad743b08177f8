"""Batched SpGEMM: plan and execute fleets of small products (port of
``repro.core.batch``; DESIGN.md section 13).

Serving-shaped traffic is fleets of small independent products: per-expert
MoE dispatch, DBCSR-style batches of block products, per-query masked
products.  :func:`plan_batch` inspects the whole fleet in one pass and
groups the members into p2-bucketed capacity classes, keyed by the
power-of-two-rounded shapes, mask presence and the power-of-two bucket of
the member's total flop: within a same-shape, uniformly masked subfleet
whose flop spans a factor ``R`` there are at most ``ceil(log2 R) + 1``
classes.  Each class has one executor (:func:`_build_class_program`),
built once per class, sortedness and operand sharing, and one algorithm,
chosen from the class's aggregate statistics
(:func:`repro_torch.core.recipe.aggregate_stats`, ``use_case="batch"``).

A hash class runs the hand-written batched numeric kernels
(``kernels/spgemm_hash``): the plan freezes each member's schedule (bin
offsets, per-bin table sizes, ``indptr_c``) stacked along the class axis,
and the executor stacks the members' operands once, padded to the class's
static shape, and launches one classifying kernel and one persistent
kernel per table class over every member's rows.  An
operand that every member of the class shares goes to the kernel once,
never copied per member (the reference's ``vmap(in_axes=None)``).  The
other classes -- ``esc``, ``heap``, ``hash_jnp``, masked members and
non-``plus_times`` semirings -- run the port's torch bodies per padded
member; ``bcsr`` and ``dense`` are rejected, as in the reference.

Padding is capacity-only: the padded tail of a CSR is structurally empty,
so the live prefix of every member's output is what the exact-capacity
per-product planned path produces.  Plans are cached under a
``("batch", ...)`` kind in the shared plan LRU; a repeat execute inspects
nothing and builds no executor.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from .formats import CSR, memo_on_versions
from .plan import cache_lookup, cache_store, structure_key
from .recipe import aggregate_stats, choose_algorithm_from_stats, \
    measure_stats
from .semiring import Semiring, resolve_semiring
from . import schedule as sched
from .spgemm import (_canon_mask, _check_mask, finalize, spgemm_esc,
                     spgemm_hash_jnp, spgemm_heap, symbolic)

#: Fig. 6 bin count of the per-member frozen hash schedules -- the
#: ``plan_spgemm`` default, so a member's schedule is its per-product one.
_HASH_BINS = 8


def _host_nnz(a: CSR) -> int:
    """``int(a.nnz)``, read from the device once per CSR instance and
    memoized on it until ``nnz`` is written in place, as the structure
    digest is: a serving loop that re-executes the same fleet objects pays
    one read per operand, not one per call."""
    return memo_on_versions(a, "_host_nnz", (a.nnz,), lambda: int(a.nnz))


def _pad_csr(a: CSR, n_rows: int, n_cols: int, cap: int) -> CSR:
    """Pad a CSR to a class's static shape and capacity, structure kept:
    extra rows are empty (``indptr`` extends flat at its last value), the
    extra capacity is zeros past the live prefix, and extra columns cost
    nothing, so the padded product's live output prefix is what the
    unpadded product computes."""
    assert n_rows >= a.n_rows and n_cols >= a.n_cols and cap >= a.cap, \
        f"class shape ({n_rows}, {n_cols})/cap {cap} cannot hold " \
        f"{a.shape}/cap {a.cap}"
    ip, ind, dat = a.indptr, a.indices, a.data
    if n_rows > a.n_rows:
        ip = torch.cat([ip, ip[-1:].expand(n_rows - a.n_rows)])
    if cap > a.cap:
        ind = torch.cat([ind, ind.new_zeros(cap - a.cap)])
        dat = torch.cat([dat, dat.new_zeros(cap - a.cap)])
    return CSR(ip, ind, dat, a.nnz, (n_rows, n_cols),
               sorted_cols=a.sorted_cols)


def _stack_index(mats: Sequence[CSR], n_rows: int, cap: int):
    """Gather indices that pad and stack ``mats`` in one pass per array:
    ``(rows, slots)``, ``(n, n_rows + 1)`` into the members' concatenated
    ``indptr`` (row ``r`` of member e reads its row ``min(r, m_e)``, the
    flat tail) and ``(n, cap)`` into their concatenated ``indices``/
    ``data`` plus one trailing zero (slots past a member's capacity)."""
    dev = mats[0].device
    m = torch.tensor([x.n_rows for x in mats], device=dev)
    caps = torch.tensor([x.cap for x in mats], device=dev)
    ip_base = torch.cumsum(m + 1, 0) - (m + 1)
    slot_base = torch.cumsum(caps, 0) - caps
    r = torch.arange(n_rows + 1, device=dev)
    rows = ip_base[:, None] + torch.minimum(r[None, :], m[:, None])
    s = torch.arange(cap, device=dev)
    slots = torch.where(s[None, :] < caps[:, None], slot_base[:, None] + s,
                        sum(x.cap for x in mats))
    return rows, slots


def _stack_csr(mats: Sequence[CSR], n_cols: int, sorted_cols: bool,
               index) -> CSR:
    """Stack ``mats``, padded by ``index`` (:func:`_stack_index`), array by
    array: ``indptr (n, n_rows + 1)``, ``indices``/``data (n, cap)`` and
    ``nnz (n,)`` -- a container of members for the batched kernel, not a
    CSR of one matrix.  ``sorted_cols`` is the class's flag, the AND over
    its members (only the heap path needs it, and a heap class is sorted
    throughout)."""
    rows, slots = index
    ip = torch.cat([x.indptr for x in mats])[rows]
    ind = torch.cat([x.indices for x in mats]
                    + [mats[0].indices.new_zeros(1)])[slots]
    dat = torch.cat([x.data for x in mats]
                    + [mats[0].data.new_zeros(1)])[slots]
    nnz = torch.stack([x.nnz for x in mats])
    return CSR(ip, ind, dat, nnz, (rows.shape[1] - 1, n_cols),
               sorted_cols=sorted_cols)


def _member(stack: CSR, j: int) -> CSR:
    """Member ``j`` of a stacked CSR, at the stack's static shape."""
    return CSR(stack.indptr[j], stack.indices[j], stack.data[j],
               stack.nnz[j], stack.shape, sorted_cols=stack.sorted_cols)


def _build_class_program(cls: "BatchClass",
                         shapes_a: Tuple[Tuple[int, int], ...],
                         shapes_b: Tuple[Tuple[int, int], ...],
                         semiring: str, complement_mask: bool,
                         sorted_output: bool, a_shared: bool = False,
                         b_shared: bool = False):
    """The executor of one capacity class: pad the members to the class's
    static shape, run the class's numeric body, cut the outputs back to the
    members' shapes (``shapes_a``/``shapes_b``, class order).

    With ``a_shared``/``b_shared`` that operand arrives once, as a CSR,
    and is never stacked; otherwise as a tuple of the members' CSRs.  A
    hash class with a frozen schedule stacks the other operand once and
    launches the batched kernel; every other class runs its torch body
    member by member.  The plan memoizes the result per (class,
    sortedness, sharing), so a fleet builds ``n_classes`` executors and a
    repeat execute builds none.
    """
    from repro_torch.kernels.spgemm_hash import ops as hash_ops
    sr = resolve_semiring(semiring)
    algo = cls.algorithm
    (M, K), (_, N) = cls.shape_a, cls.shape_b
    n = cls.n_members
    kernel_hash = algo in ("hash", "hash_vector") and \
        cls.hash_sched is not None
    if algo not in ("esc", "heap", "hash", "hash_vector", "hash_jnp"):
        raise ValueError(f"class holds unknown algorithm {algo!r}")

    if kernel_hash:
        offsets, bin_tsize, indptr_c = cls.hash_sched
        vector = algo == "hash_vector"
        table_size = cls.table_size
        # everything static is cut once: each member's row pointer and
        # nnz views
        statics = [(indptr_c[j, :shapes_a[j][0] + 1], indptr_c[j, M],
                    (shapes_a[j][0], shapes_b[j][1])) for j in range(n)]
        indexes: dict = {}

        def stacked(ops, side, rows, cols, cap, flag):
            if side not in indexes:     # member caps are plan-frozen
                indexes[side] = _stack_index(ops, rows, cap)
            return _stack_csr(ops, cols, flag, indexes[side])

        def fleet(a_in, b_in) -> Tuple[CSR, ...]:
            a_proc = a_in if a_shared else stacked(a_in, "a", M, K,
                                                   cls.cap_a, cls.a_sorted)
            b_proc = b_in if b_shared else stacked(b_in, "b", K, N,
                                                   cls.cap_b, cls.b_sorted)
            cols, vals = hash_ops.spgemm_hash_batched(
                a_proc, b_proc, cls.cap_c, vector=vector,
                table_size=table_size, schedule=(offsets, bin_tsize),
                indptr_c=indptr_c, largest=cls.hash_largest)
            cols = cols.unbind(0)
            vals = vals.to(a_proc.dtype).unbind(0)
            return tuple(finalize(CSR(ip, cols[j], vals[j], nnz, shape,
                                      sorted_cols=False), sorted_output)
                         for j, (ip, nnz, shape) in enumerate(statics))

        return fleet

    def body(a: CSR, b: CSR, mask: Optional[CSR]) -> CSR:
        if algo == "esc":
            return spgemm_esc(a, b, cls.cap_c, flop_cap=cls.flop_cap,
                              semiring=sr, mask=mask,
                              complement_mask=complement_mask)
        if algo == "heap":
            return spgemm_heap(a, b, row_cap=cls.row_cap,
                               k_width=cls.k_width, cap_c=cls.cap_c,
                               semiring=sr, mask=mask,
                               complement_mask=complement_mask)
        # an explicit hash_jnp pin, or a hash class whose request is
        # general (semiring or mask): the sort-based fallback
        return spgemm_hash_jnp(a, b, cls.cap_c, flop_cap=cls.flop_cap,
                               semiring=sr, mask=mask,
                               complement_mask=complement_mask)

    def pad(x, rows, cols, cap, flag):
        return dataclasses.replace(_pad_csr(x, rows, cols, cap),
                                   sorted_cols=flag)

    def fleet(a_in, b_in) -> Tuple[CSR, ...]:
        if a_shared:
            a_one = pad(a_in, M, K, cls.cap_a, cls.a_sorted)
        if b_shared:
            b_one = pad(b_in, K, N, cls.cap_b, cls.b_sorted)
        outs = []
        for j in range(n):
            a_j = a_one if a_shared else pad(a_in[j], M, K, cls.cap_a,
                                             cls.a_sorted)
            b_j = b_one if b_shared else pad(b_in[j], K, N, cls.cap_b,
                                             cls.b_sorted)
            mask = None if cls.mask_parts is None else \
                _member(cls.mask_parts, j)
            c = body(a_j, b_j, mask)
            m_j, n_j = shapes_a[j][0], shapes_b[j][1]
            outs.append(finalize(CSR(c.indptr[:m_j + 1], c.indices, c.data,
                                     c.nnz, (m_j, n_j),
                                     sorted_cols=c.sorted_cols),
                                 sorted_output))
        return tuple(outs)

    return fleet


@dataclass(frozen=True)
class BatchClass:
    """One capacity class: members that share one executor.

    Static shapes and capacities are the p2-rounded class maxima; the
    per-member exact numbers live on the owning :class:`BatchedPlan`.
    ``mask_parts`` holds the members' canonicalized masks, padded to the
    class shape and stacked.
    """
    members: Tuple[int, ...]
    algorithm: str
    shape_a: Tuple[int, int]      # padded (M, K)
    shape_b: Tuple[int, int]      # padded (K, N)
    cap_a: int
    cap_b: int
    cap_c: int
    flop_cap: int
    row_cap: int
    k_width: int
    a_sorted: bool
    b_sorted: bool
    mask_parts: Optional[CSR] = dataclasses.field(repr=False)
    total_flop: int = 0
    #: every member held the same object for this operand at plan time, so
    #: the executor may pass it once instead of stacking N copies --
    #: re-checked by identity at execute time.
    a_shared: bool = False
    b_shared: bool = False
    #: the hash table allocation: the max over the members' own natural
    #: table sizes, each at least ``CHUNK`` (each member's per-bin sizes are clamped against its own
    #: table at plan time, so the larger allocation changes no probe).
    table_size: int = 0
    #: plan-frozen stacked hash schedules for the batched kernel:
    #: ``(offsets (n, n_bins + 1), bin_tsize (n, n_bins), indptr_c (n, M +
    #: 1))`` in class-member order; ``None`` for non-hash or general
    #: classes.
    hash_sched: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] \
        = dataclasses.field(default=None, repr=False)
    #: ``(offsets, bin_tsize)`` of ``hash_sched`` as host lists, read back
    #: once at plan time, with no device read per execute.
    hash_host: Optional[tuple] = dataclasses.field(default=None, repr=False)
    #: the largest bin table of ``hash_host`` (``kernel.fleet_table``):
    #: the table classes the batched kernels launch
    #: (``kernel.launch_classes``) and the global class's workspace.
    hash_largest: int = 0

    @property
    def n_members(self) -> int:
        return len(self.members)


@dataclass(frozen=True)
class BatchedPlan:
    """Frozen inspection of a fleet of products ``[(A_i, B_i), ...]``.

    ``classes[class_of[i]]`` is product ``i``'s capacity class;
    :meth:`execute` runs each class's executor and returns per-product
    CSRs in input order (original shapes, class capacity, exact ``nnz``).
    """
    key: tuple = dataclasses.field(repr=False)
    classes: Tuple[BatchClass, ...] = dataclasses.field(repr=False)
    class_of: Tuple[int, ...]
    semiring: str
    complement_mask: bool
    sorted_output: bool
    shapes_a: Tuple[Tuple[int, int], ...]
    shapes_b: Tuple[Tuple[int, int], ...]
    caps_a: Tuple[int, ...]
    caps_b: Tuple[int, ...]
    nnzs_a: Tuple[int, ...]
    nnzs_b: Tuple[int, ...]
    nnz_cs: Tuple[int, ...]       # exact per-product nnz(C_i)
    total_flop: int

    @property
    def n_products(self) -> int:
        return len(self.class_of)

    @property
    def n_classes(self) -> int:
        return len(self.classes)

    @property
    def algorithms(self) -> Tuple[str, ...]:
        """Per-product resolved algorithm (its class's choice)."""
        return tuple(self.classes[c].algorithm for c in self.class_of)

    @property
    def nnz_c(self) -> int:
        return sum(self.nnz_cs)

    def check_structure(self, pairs: Sequence[Tuple[CSR, CSR]]) -> None:
        """Cheap shapes/caps/nnz check of every member against the plan.
        Shapes and caps are static; each operand's ``nnz`` is read from the
        device once per CSR instance, and again after a write in place
        (:func:`_host_nnz`)."""
        assert len(pairs) == self.n_products, \
            f"plan is for {self.n_products} products, got {len(pairs)}"
        for i, (a, b) in enumerate(pairs):
            assert a.shape == self.shapes_a[i] and \
                b.shape == self.shapes_b[i], \
                f"product {i}: planned {self.shapes_a[i]}x" \
                f"{self.shapes_b[i]}, got {a.shape}x{b.shape}"
            assert a.cap == self.caps_a[i] and b.cap == self.caps_b[i], \
                f"product {i}: operand capacities differ from the " \
                f"planned structure"
            for op, planned in ((a, self.nnzs_a[i]), (b, self.nnzs_b[i])):
                assert _host_nnz(op) == planned, \
                    f"product {i} nnz differs from the planned " \
                    f"structure (replan or clear_plan_cache)"

    def _class_executor(self, ci: int, sorted_output: bool,
                        a_shared: bool, b_shared: bool):
        cache = self.__dict__.get("_executors")
        if cache is None:
            cache = {}
            object.__setattr__(self, "_executors", cache)
        key = (ci, sorted_output, a_shared, b_shared)
        fn = cache.get(key)
        if fn is None:
            cls = self.classes[ci]
            fn = _build_class_program(
                cls, tuple(self.shapes_a[i] for i in cls.members),
                tuple(self.shapes_b[i] for i in cls.members),
                self.semiring, self.complement_mask, sorted_output,
                a_shared=a_shared, b_shared=b_shared)
            cache[key] = fn
        return fn

    def execute(self, pairs: Sequence[Tuple[CSR, CSR]],
                sorted_output: Optional[bool] = None) -> List[CSR]:
        """Numeric phase only, whole fleet: no re-inspection.

        One executor call per capacity class; results come back in input
        order with each product's original shape (capacity is the class's
        ``cap_c``; ``nnz`` is exact).  ``sorted_output`` overrides the
        plan's recorded sortedness for this call, a pure epilogue as in
        ``SpGEMMPlan.execute``.
        """
        pairs = [tuple(p) for p in pairs]
        self.check_structure(pairs)
        so = self.sorted_output if sorted_output is None else sorted_output
        outs: List[Optional[CSR]] = [None] * len(pairs)
        for ci, cls in enumerate(self.classes):
            a_ops = tuple(pairs[i][0] for i in cls.members)
            b_ops = tuple(pairs[i][1] for i in cls.members)
            if cls.algorithm == "heap":
                # the executor stamps the plan-time sorted flags, so an
                # operand downgraded to unsorted since plan time would feed
                # the heap merge out of order: fail loudly instead
                assert all(a.sorted_cols for a in a_ops) and \
                    all(b.sorted_cols for b in b_ops), \
                    "heap class executed with an unsorted operand " \
                    "(structure drifted since plan time; replan)"
            # pass an operand once only when the caller passed one object
            # for the whole class this call (values included)
            a_shared = cls.a_shared and all(a is a_ops[0] for a in a_ops)
            b_shared = cls.b_shared and all(b is b_ops[0] for b in b_ops)
            c_list = self._class_executor(ci, so, a_shared, b_shared)(
                a_ops[0] if a_shared else a_ops,
                b_ops[0] if b_shared else b_ops)
            for j, i in enumerate(cls.members):
                outs[i] = c_list[j]
        return outs

    __call__ = execute


def plan_batch(pairs: Sequence[Tuple[CSR, CSR]], *,
               algorithm: str = "auto",
               semiring: str | Semiring = "plus_times",
               masks: Optional[Sequence[Optional[CSR]]] = None,
               complement_mask: bool = False, sorted_output: bool = False,
               cache: bool = True) -> BatchedPlan:
    """Inspect a fleet of products once; freeze a :class:`BatchedPlan`.

    ``pairs`` is a sequence of ``(A_i, B_i)`` CSRs on one device -- repeat
    the same object to share one A or one B across the fleet (per-expert
    dispatch against one feature matrix).  ``masks`` optionally gives one
    structural mask per product (``None`` entries allowed); masked and
    unmasked members never share a class.

    One pass: per-member flop profile and exact symbolic counts, the p2
    capacity-class grouping, then one recipe choice per class from its
    aggregate statistics (``use_case="batch"``).  ``algorithm`` other than
    ``"auto"`` pins every class.  Cached under a ``("batch", ...)`` key in
    the shared plan LRU.
    """
    pairs = [tuple(p) for p in pairs]
    assert pairs, "a batch needs at least one product"
    n = len(pairs)
    for i, (a, b) in enumerate(pairs):
        assert a.n_cols == b.n_rows, \
            f"batch member {i}: {a.shape} @ {b.shape} shapes do not compose"
    masks = list(masks) if masks is not None else [None] * n
    assert len(masks) == n, \
        f"masks must align with pairs: {len(masks)} != {n}"
    sr = resolve_semiring(semiring)
    if algorithm == "heap":
        for a, b in pairs:
            if not (a.sorted_cols and b.sorted_cols):
                raise AssertionError("heap path requires sorted inputs")
    if algorithm in ("bcsr", "dense"):
        raise NotImplementedError(
            f"the {algorithm} path cannot run under the batched executor; "
            f"pick esc/heap/hash")

    key = ("batch",
           tuple((structure_key(a), structure_key(b),
                  None if m is None else structure_key(m))
                 for (a, b), m in zip(pairs, masks)),
           sr.name, complement_mask, sorted_output, algorithm)
    if cache:
        hit = cache_lookup(key, pairs[0][0].device)
        if hit is not None:
            return hit

    # --- one inspection pass over the fleet ----------------------------
    infos = []
    for (a, b), m in zip(pairs, masks):
        _check_mask(a, b, m)
        m = _canon_mask(m)
        flop = sched.flops_per_row(a, b)
        total_flop = int(flop.to(torch.int64).sum()) if flop.numel() else 0
        # the p2-bucketed expansion bound, as the reference (exact either
        # way)
        row_nnz_c, indptr_c, _, _ = symbolic(
            a, b, mask=m, complement_mask=complement_mask,
            flop_cap=sched.lowest_p2(max(total_flop, 1)))
        stats = measure_stats(a, b, row_nnz_c=row_nnz_c, mask=m,
                              complement_mask=complement_mask)
        a_rows = a.row_nnz()
        infos.append(dict(
            mask=m, total_flop=total_flop, stats=stats, flop=flop,
            indptr_c=indptr_c.to(torch.int32),
            nnz_c=int(row_nnz_c.to(torch.int64).sum()),
            row_cap=max(int(row_nnz_c.max()) if row_nnz_c.numel() else 0,
                        1),
            k_width=max(int(a_rows.max()) if a.n_rows else 0, 1)))

    # --- p2 capacity-class grouping ------------------------------------
    p2 = sched.lowest_p2
    groups: dict = {}
    for i, ((a, b), info) in enumerate(zip(pairs, infos)):
        gk = (p2(max(a.n_rows, 1)), p2(max(a.n_cols, 1)),
              p2(max(b.n_cols, 1)), info["mask"] is not None,
              p2(max(info["total_flop"], 1)))
        groups.setdefault(gk, []).append(i)

    classes: List[BatchClass] = []
    class_of = [0] * n
    for gk in sorted(groups):
        idxs = groups[gk]
        M, K, N = gk[0], gk[1], gk[2]
        masked = gk[3]
        a_sorted = all(pairs[i][0].sorted_cols for i in idxs)
        b_sorted = all(pairs[i][1].sorted_cols for i in idxs)
        algo = algorithm
        if algo == "auto":
            agg = aggregate_stats([infos[i]["stats"] for i in idxs])
            algo = choose_algorithm_from_stats(
                agg, sorted_output, use_case="batch", semiring=sr.name)
        if algo == "heap" and not (a_sorted and b_sorted):
            # the members cannot feed heap; hash keeps the unsorted
            # contract (plan_spgemm's fallback)
            algo = "hash"
        mask_parts = None
        if masked:
            mcap = p2(max(max(infos[i]["mask"].cap for i in idxs), 1))
            ms = [infos[i]["mask"] for i in idxs]
            mask_parts = _stack_csr(ms, N, True, _stack_index(ms, M, mcap))
        # Plan-frozen hash schedules (Fig. 6 + Fig. 7 lines 9-12), one per
        # member over its unpadded structure, stacked along the class axis.
        # Each member's bin sizes clamp against its own natural table, so
        # the class-max table allocation changes no probe.  General
        # requests (semirings, masks) keep the sort-based body instead.
        table_size = hash_largest = 0
        hash_sched = hash_host = None
        if algo in ("hash", "hash_vector") and not masked and \
                sr.name == "plus_times":
            from repro_torch.kernels.spgemm_hash.kernel import CHUNK, \
                fleet_table
            per_off, per_bts, per_ic, tables = [], [], [], []
            for i in idxs:
                b_i = pairs[i][1]
                flop_i = infos[i]["flop"]
                off_i = sched.rows_to_bins(flop_i, _HASH_BINS)
                tsz_i = torch.clamp(sched.max_flop_per_bin_row(flop_i, off_i),
                                    max=b_i.n_cols)
                max_flop = int(flop_i.max()) if flop_i.numel() else 0
                t_i = max(p2(min(max_flop, b_i.n_cols) + 1), CHUNK)
                tables.append(t_i)
                per_off.append(off_i)
                per_bts.append(sched.bin_table_sizes(
                    tsz_i, b_i.n_cols, t_i, floor=CHUNK))
                ip = infos[i]["indptr_c"]
                if M + 1 > ip.shape[0]:      # flat-pad to the class rows
                    ip = torch.cat([ip, ip[-1:].expand(M + 1 - ip.shape[0])])
                per_ic.append(ip)
            table_size = max(tables)
            hash_sched = (torch.stack(per_off), torch.stack(per_bts),
                          torch.stack(per_ic))
            hash_host = (hash_sched[0].tolist(), hash_sched[1].tolist())
            hash_largest = fleet_table(*hash_host, table_size, M,
                                       algo == "hash_vector")
        cls = BatchClass(
            members=tuple(idxs), algorithm=algo, shape_a=(M, K),
            shape_b=(K, N),
            a_shared=all(pairs[i][0] is pairs[idxs[0]][0] for i in idxs),
            b_shared=all(pairs[i][1] is pairs[idxs[0]][1] for i in idxs),
            cap_a=p2(max(max(pairs[i][0].cap for i in idxs), 1)),
            cap_b=p2(max(max(pairs[i][1].cap for i in idxs), 1)),
            cap_c=p2(max(max(infos[i]["nnz_c"] for i in idxs), 1)),
            flop_cap=p2(max(max(infos[i]["total_flop"] for i in idxs), 1)),
            row_cap=p2(max(infos[i]["row_cap"] for i in idxs)),
            k_width=p2(max(infos[i]["k_width"] for i in idxs)),
            a_sorted=a_sorted, b_sorted=b_sorted, mask_parts=mask_parts,
            total_flop=sum(infos[i]["total_flop"] for i in idxs),
            table_size=table_size, hash_sched=hash_sched,
            hash_host=hash_host, hash_largest=hash_largest)
        for i in idxs:
            class_of[i] = len(classes)
        classes.append(cls)

    plan = BatchedPlan(
        key=key, classes=tuple(classes), class_of=tuple(class_of),
        semiring=sr.name, complement_mask=complement_mask,
        sorted_output=sorted_output,
        shapes_a=tuple(a.shape for a, _ in pairs),
        shapes_b=tuple(b.shape for _, b in pairs),
        caps_a=tuple(a.cap for a, _ in pairs),
        caps_b=tuple(b.cap for _, b in pairs),
        nnzs_a=tuple(_host_nnz(a) for a, _ in pairs),
        nnzs_b=tuple(_host_nnz(b) for _, b in pairs),
        nnz_cs=tuple(info["nnz_c"] for info in infos),
        total_flop=sum(info["total_flop"] for info in infos))
    if cache:
        cache_store(key, pairs[0][0].device, plan)
    return plan


def spgemm_batch(pairs: Sequence[Tuple[CSR, CSR]], *,
                 algorithm: str = "auto",
                 semiring: str | Semiring = "plus_times",
                 masks: Optional[Sequence[Optional[CSR]]] = None,
                 complement_mask: bool = False,
                 sorted_output: bool = False,
                 plan: Optional[BatchedPlan] = None,
                 cache: bool = True) -> List[CSR]:
    """One-shot planned fleet product: ``[A_i @ B_i for i in fleet]``.

    Plans (or pulls from the shared cache) and executes.  With ``plan=``
    every other argument except ``pairs`` is ignored, mirroring
    ``spgemm(plan=)``.
    """
    if plan is None:
        plan = plan_batch(pairs, algorithm=algorithm, semiring=semiring,
                          masks=masks, complement_mask=complement_mask,
                          sorted_output=sorted_output, cache=cache)
    return plan.execute(pairs)
