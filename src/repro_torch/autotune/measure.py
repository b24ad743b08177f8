"""Measured recipe: microbenchmark candidates, persist winners (port of
``repro.autotune.measure``).

The heuristic Table-4 recipe guesses from structure statistics; this
module *measures*.  :func:`measured_recommend` keys the request by the
operands' structure digests plus the execution context (backend, value
width) -- the digests the plan cache uses, so a DB entry can never be
served to a different structure -- and either

  * **hits** the persistent :class:`repro_torch.autotune.db.PerfDB` and
    returns the recorded winner with zero microbenchmarks (the
    ``candidates_timed`` counter pins this in tests), or
  * **misses**, builds a throwaway (uncached) plan per candidate
    algorithm -- esc / heap (sorted inputs only) / pb / hash / hash_vector
    / hash_jnp / bcsr, plus x2 hash-table-size variants of the kernel hash
    paths -- times each after a warm-up, in rounds beside the others
    (:func:`race_lanes`), persists the winner with its timing and
    roofline context, and returns it.

Candidate timing runs the *numeric* phase only (``SpGEMMPlan.execute``):
the lanes share one inspection, which is not timed.  On CUDA operands a
repetition is one window of back-to-back executes between CUDA events
on the current stream, read after a synchronize; on the CPU one execute
on ``time.perf_counter``.  A DB that cannot be trusted degrades per
:mod:`repro_torch.autotune.db`, and a miss whose lanes all drop out
returns ``None``: the caller falls back to the heuristic.  A lane drops
out with a warning only where :func:`_lane_may_drop` says so: on the
CPU for any failure, as in the reference; on the card only for running
out of memory.  A kernel that does not build or launch there raises, so
a plain lane is never measured or served in its place.

Wall-clock timing lives here, outside ``core/``: ``core.recipe`` and
``core.plan`` import this module lazily, only when a caller asks for
measured mode.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import statistics
import time
import warnings
from typing import Optional

import torch

from repro_torch.analysis.roofline import (spgemm_roofline,
                                           spgemm_traffic_bytes)
from .db import DRIFT_TOLERANCE, SCHEMA_VERSION, AutotuneDBWarning, \
    resolve_db

#: timed repetitions per candidate (one warm-up before)
REPS = 3

#: on the card, the span of back-to-back executes one repetition times,
#: in µs, and the most executes it takes
WINDOW_US, MAX_BACK_TO_BACK = 20_000.0, 64

#: on the card, the repetitions of a lane whose execute is shorter than a
#: window (a window's worth of them costs WINDOW_US, so more are cheap)
FAST_REPS = 9

#: hash-table-size multipliers tried for the kernel hash paths.  Scales
#: stay powers of two so the scaled schedule keeps every p2 bound.
TABLE_SCALES = (1, 2)

#: bytes of a value as the kernels compute it (float32), for the roofline
KERNEL_ITEMSIZE = 4

#: measurement-effort counters, cumulative per process.  Tests reset
#: them around a recommend and assert ``candidates_timed == 0`` on a DB
#: hit -- the "repeat plans measure nothing" contract.
MEASURE_CALLS = {"recommends": 0, "db_hits": 0, "db_misses": 0,
                 "candidates_timed": 0}


def reset_measure_calls() -> None:
    for k in MEASURE_CALLS:
        MEASURE_CALLS[k] = 0


def measure_call_counts() -> dict:
    return dict(MEASURE_CALLS)


@dataclasses.dataclass(frozen=True)
class TunedChoice:
    """What the measured recipe resolved to.

    ``source`` says how: ``"db"`` (persisted winner, zero measurement
    this call) or ``"measured"`` (fresh microbenchmark, now persisted).
    ``us`` is the winner's recorded median execute time.
    """
    algorithm: str
    table_scale: int
    us: float
    source: str


def backend_of(device) -> str:
    """The key's backend field: ``torch-cpu``, or ``torch-cuda:`` and the
    card's name, so a winner measured on one card is not served on
    another."""
    device = torch.device(device)
    if device.type == "cuda":
        return f"torch-cuda:{torch.cuda.get_device_name(device)}"
    return f"torch-{device.type}"


def _x64(a, b) -> bool:
    return torch.float64 in (a.dtype, b.dtype)


def db_key(a, b, mask=None, *, semiring: str = "plus_times",
           sorted_output: bool = False,
           complement_mask: bool = False) -> str:
    """Autotune DB key: plan-cache structure digests + execution context.

    Two requests share an entry iff their operand (and mask) structures
    are digest-identical AND they run on the same backend with the same
    value width (``x64`` for float64 values, ``x32`` otherwise) -- a
    winner measured on one device says nothing about another, and float64
    doubles the value traffic.
    """
    from repro_torch.core.plan import structure_key
    parts = [
        "spgemm",
        structure_key(a).hex(),
        structure_key(b).hex(),
        structure_key(mask).hex() if mask is not None else "nomask",
        "cmpl" if complement_mask else "mask",
        semiring,
        "sorted" if sorted_output else "unsorted",
        backend_of(a.device),
        "x64" if _x64(a, b) else "x32",
    ]
    return "|".join(parts)


def _stat_fingerprint(stats) -> dict:
    """The drift-check fields recorded with (and compared against) an
    entry: structure-level totals that move whenever the digest's
    meaning would."""
    return {"flop": float(stats.flop), "nnz_c": float(stats.nnz_c_est),
            "nnz_a": float(stats.nnz_a)}


def _scaled_plan(plan, scale: int, n_cols: int):
    """x``scale`` hash-table variant of a frozen plan (the planner's own
    ``table_scale`` application, ``schedule.scale_table_sizes``)."""
    from repro_torch.core.schedule import scale_table_sizes
    from repro_torch.kernels.spgemm_hash.kernel import CHUNK
    table_size, bin_tsize = scale_table_sizes(
        plan.table_size, plan.bin_tsize, scale, n_cols, CHUNK)
    return dataclasses.replace(plan, table_size=table_size,
                               bin_tsize=bin_tsize)


def _window_us(run, launches: int) -> float:
    """One CUDA-event pair around ``launches`` back-to-back executes on
    the current stream, read after the end event is synchronized;
    microseconds an execute."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    collecting = gc.isenabled()
    gc.disable()     # as timeit does: a collection is not the lane's time
    try:
        t0.record()
        for _ in range(launches):
            run()
        t1.record()
        t1.synchronize()
    finally:
        if collecting:
            gc.enable()
    return t0.elapsed_time(t1) * 1e3 / launches


def _sampler(plan, a, b):
    """``(sample, reps)``: a function giving one timed repetition of
    ``plan.execute(a, b)``, in microseconds, after one untimed run (the
    kernels' build and first launch), and how many repetitions to take.

    On the card a repetition is one CUDA-event window around as many
    back-to-back executes as fill :data:`WINDOW_US` (at least one, at most
    :data:`MAX_BACK_TO_BACK`, sized by one timed execute, which is the
    first repetition where the window holds one execute), divided by
    their number: the host work an execute holds (its syncs, its
    read-backs) is inside the window, and one slow execute weighs little.
    A lane whose window holds more than one execute takes
    :data:`FAST_REPS` repetitions, any other :data:`REPS`.  On the CPU a
    repetition is one execute on the wall clock, :data:`REPS` of them, as
    in the reference."""
    def run():
        plan.execute(a, b)

    run()
    if a.device.type != "cuda":
        def sample():
            t0 = time.perf_counter()
            run()
            return (time.perf_counter() - t0) * 1e6
        return sample, REPS
    torch.cuda.synchronize(a.device)
    first = _window_us(run, 1)
    launches = int(min(MAX_BACK_TO_BACK,
                       max(1.0, WINDOW_US // max(first, 1.0))))
    banked = [first] if launches == 1 else []

    def sample():
        return banked.pop() if banked else _window_us(run, launches)
    return sample, REPS if launches == 1 else FAST_REPS


def _on(device):
    """The operands' card as the current device (its current stream takes
    the events), or nothing on the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else \
        contextlib.nullcontext()


def _rounds(samplers: dict, drop=None, reps: Optional[int] = None) -> dict:
    """``{label: [µs, ...]}``: the repetitions of every ``(sample, reps)``
    of ``samplers`` (:func:`_sampler`), in rounds -- one repetition of
    every lane that still takes one a round, each round in the other
    order -- so a lane's r-th repetition sits beside every other lane's.
    ``reps`` overrides every lane's count.  A repetition that raises goes
    to ``drop(label, exc)``, which raises or drops the lane, where given."""
    count = {label: reps or n for label, (_, n) in samplers.items()}
    samples = {label: [] for label in samplers}
    for r in range(max(count.values(), default=0)):
        for label in list(samplers)[::1 if r % 2 == 0 else -1]:
            if label not in samples or r >= count[label]:
                continue
            try:
                samples[label].append(samplers[label][0]())
            except Exception as exc:
                if drop is None:
                    raise
                drop(label, exc)
                del samples[label]
    return samples


def _paired(samples: dict) -> dict:
    """``{label: µs}`` from :func:`_rounds`' repetitions.  The lane with
    the least median is the reference and keeps its median; every other
    lane is the reference's median times the median, over the rounds both
    took, of its ratio to the reference in the same round.  Repetitions
    of one round are taken milliseconds apart, so a ratio within a round
    cancels the drift of a shared host's speed, which moves a lane's own
    median by more than the 5 % a race must resolve."""
    if not samples:
        return {}
    ref = min(samples, key=lambda label: statistics.median_low(
        samples[label]))
    base, ref_samples = statistics.median_low(samples[ref]), samples[ref]
    return {label: base * statistics.median_low(
        [x / y for x, y in zip(v, ref_samples)])
        for label, v in samples.items()}


def time_plans(plans: dict, a, b, reps: Optional[int] = None) -> dict:
    """``{label: µs}`` of ``plans[label].execute(a, b)``, timed as a race
    times its lanes (:func:`_sampler`, :func:`_rounds`, :func:`_paired`),
    ``reps`` repetitions each where given; a failure raises."""
    with _on(a.device):
        samplers = {label: _sampler(p, a, b) for label, p in plans.items()}
        return _paired(_rounds(samplers, reps=reps))


def _lane_may_drop(exc: BaseException, device) -> bool:
    """Whether a lane that raised ``exc`` drops out of the race.

    On the card only an allocation the card cannot hold drops a lane: the
    gates of :func:`_candidates` admit only lanes that apply, so anything
    else -- a kernel that does not build or launch, a wrapper refusing
    what the planner gave it, a plain lane's fault -- is a fault of the
    port and propagates, and no plain lane is served in a kernel's place.
    On the CPU every lane's failure drops it, the reference's contract."""
    if torch.device(device).type == "cuda":
        return isinstance(exc, torch.cuda.OutOfMemoryError)
    return isinstance(exc, Exception)


def _candidates(a, b, semiring: str, mask) -> list:
    """(label, algorithm, table_scale) lanes worth timing here.

    Under a general semiring or a mask, ``plan.execute`` routes every
    hash flavor to the plain fallback, so only esc / heap / hash_jnp are
    distinct programs; the kernel hash paths (and their table-size
    variants) race only on the plus_times unmasked fast path.
    """
    from repro_torch.core.recipe import (AUTO_PROBE_CELLS,
                                         MXU_MIN_TILE_DENSITY,
                                         PB_MAX_COMPRESSION,
                                         block_density_of, measure_stats)
    general = semiring != "plus_times" or mask is not None
    lanes = [("esc", "esc", 1)]
    if a.sorted_cols and b.sorted_cols:
        lanes.append(("heap", "heap", 1))
    if general:
        lanes.append(("hash_jnp", "hash_jnp", 1))
        return lanes
    # Propagation blocking: raced only where the recipe's compression gate
    # says the expansion barely collapses -- the regime its two streaming
    # passes can beat the hash table's probes
    if measure_stats(a, b).compression_ratio <= PB_MAX_COMPRESSION:
        lanes.append(("pb", "pb", 1))
    for algo in ("hash", "hash_vector"):
        for scale in TABLE_SCALES:
            label = algo if scale == 1 else f"{algo}@t{scale}"
            lanes.append((label, algo, scale))
    lanes.append(("hash_jnp", "hash_jnp", 1))
    # block lane: raced only where the recipe's eligibility gate says tiles
    # are dense enough to possibly win, and where the occupancy probe is
    # affordable
    if a.n_rows * a.n_cols <= AUTO_PROBE_CELLS and \
            block_density_of(a) >= MXU_MIN_TILE_DENSITY:
        lanes.append(("bcsr", "bcsr", 1))
    return lanes


def race_lanes(a, b, lanes, *, inspection=None, semiring: str = "plus_times",
               mask=None, complement_mask: bool = False,
               sorted_output: bool = False) -> dict:
    """Time each ``(label, algorithm, table_scale)`` lane's plan of
    ``a @ b``: ``{label: µs}`` for the lanes that ran, each from its
    repetitions (:func:`_sampler`) taken in rounds beside every other
    lane's (:func:`_rounds`) and read against the fastest lane's in the
    same round (:func:`_paired`).
    The lanes share one inspection, ``inspection`` (the structural fields
    of :func:`repro_torch.core.plan.inspect_spgemm` for this request) or
    one made here; a lane that fails drops out with a warning where
    :func:`_lane_may_drop` allows, and raises otherwise."""
    from repro_torch.core.plan import inspect_spgemm, plan_spgemm
    request = dict(semiring=semiring, mask=mask,
                   complement_mask=complement_mask,
                   sorted_output=sorted_output)

    def drop(what, exc):
        if not _lane_may_drop(exc, a.device):
            raise exc
        warnings.warn(f"autotune {what} failed ({type(exc).__name__}: "
                      f"{exc}); skipping", AutotuneDBWarning, stacklevel=2)

    with _on(a.device):
        if inspection is None:
            try:
                inspection = inspect_spgemm(a, b, algorithm="esc",
                                            **request)
            except Exception as exc:
                drop("inspection", exc)
                return {}
        samplers = {}
        for label, algo, scale in lanes:
            try:
                plan = plan_spgemm(a, b, algorithm=algo, cache=False,
                                   inspection={**inspection,
                                               "algorithm": algo,
                                               "provenance": "explicit"},
                                   **request)
                if scale != 1:
                    plan = _scaled_plan(plan, scale, b.n_cols)
                samplers[label] = _sampler(plan, a, b)
            except Exception as exc:
                drop(f"candidate {label}", exc)
        samples = _rounds(samplers, lambda label, exc: drop(
            f"candidate {label}", exc))
    MEASURE_CALLS["candidates_timed"] += len(samples)
    return _paired(samples)


def race_report(heuristic, lanes: dict) -> dict:
    """One row of a race's report, from the heuristic plan of the raced
    request and the race's ``{label: µs}``: the product's size, the heap
    lane's steps (the largest row flop), Table 4's choice and its lane's
    µs, the winner and its, their ratio, every lane's µs, and the spread
    between lanes that run one program (a ``@t2`` lane whose tables clip
    to its scale-1 lane's), which says how far apart two timings of one
    program fall in this race."""
    from repro_torch.core.schedule import scale_table_sizes
    from repro_torch.kernels.spgemm_hash.kernel import CHUNK
    winner = min(lanes, key=lanes.__getitem__) if lanes else None
    heur_us = lanes.get(heuristic.algorithm)
    size, bins = scale_table_sizes(heuristic.table_size, heuristic.bin_tsize,
                                   2, heuristic.shape_b[1], CHUNK)
    same = size == heuristic.table_size and \
        torch.equal(bins, heuristic.bin_tsize)
    spread = {}
    for algo in ("hash", "hash_vector"):
        pair = lanes.get(algo), lanes.get(f"{algo}@t2")
        if same and None not in pair:
            spread[algo] = max(pair) / min(pair) - 1.0
    flop = heuristic.total_flop
    return {"n": heuristic.shape_a[0], "nnz": heuristic.nnz_a, "flop": flop,
            "nnz_c": heuristic.nnz_c,
            "compression": flop / max(heuristic.nnz_c, 1),
            "heap_steps": int(heuristic.flop.max())
            if heuristic.flop.numel() else 0,
            "heuristic": heuristic.algorithm, "heuristic_us": heur_us,
            "winner": winner, "winner_us": lanes.get(winner),
            "heuristic_over_winner": heur_us / lanes[winner]
            if heur_us else None,
            "lanes_us": lanes, "same_program_spread": spread}


def measured_recommend(a, b, *, sorted_output: bool = False,
                       semiring: str = "plus_times", mask=None,
                       complement_mask: bool = False, stats=None,
                       row_nnz_c=None, db=None, measure: bool = True,
                       tolerance: float = DRIFT_TOLERANCE,
                       inspection: Optional[dict] = None
                       ) -> Optional[TunedChoice]:
    """DB-first measured algorithm choice; ``None`` means "use the
    heuristic".

    ``stats`` (a ``SpGEMMStats``) arms the drift check against the
    recorded entry and is computed here if absent; ``row_nnz_c`` passes
    the symbolic phase's exact counts through to that computation.
    ``measure=False`` restricts to DB lookups -- a miss then returns
    ``None`` instead of spending microbenchmark time.  ``db`` is a path
    string, a :class:`repro_torch.autotune.PerfDB`, or ``None`` for the
    default path.  ``inspection`` is the caller's structural inspection
    of this request (``inspect_spgemm``'s fields), which the lanes share
    in place of one made here.  The lanes run on the operands' device;
    a lane's failure that :func:`_lane_may_drop` does not allow (on the
    card, anything but running out of memory) raises.
    """
    MEASURE_CALLS["recommends"] += 1
    pdb = resolve_db(db)
    if stats is None:
        from repro_torch.core.recipe import measure_stats
        stats = measure_stats(a, b, row_nnz_c=row_nnz_c, mask=mask,
                              complement_mask=complement_mask)
    key = db_key(a, b, mask, semiring=semiring, sorted_output=sorted_output,
                 complement_mask=complement_mask)
    fingerprint = _stat_fingerprint(stats)

    entry = pdb.get(key, stats=fingerprint, tolerance=tolerance)
    if entry is not None:
        MEASURE_CALLS["db_hits"] += 1
        return TunedChoice(algorithm=entry["algorithm"],
                           table_scale=int(entry.get("table_scale", 1)),
                           us=float(entry.get("us", 0.0)), source="db")
    MEASURE_CALLS["db_misses"] += 1
    if not measure:
        return None

    lanes = _candidates(a, b, semiring, mask)
    timings = race_lanes(a, b, lanes, inspection=inspection,
                         semiring=semiring, mask=mask,
                         complement_mask=complement_mask,
                         sorted_output=sorted_output)
    if not timings:
        warnings.warn("autotune: every candidate failed; falling back to "
                      "the heuristic recipe", AutotuneDBWarning,
                      stacklevel=2)
        return None
    label = min(timings, key=timings.__getitem__)
    us = timings[label]
    _, algo, scale = next(lane for lane in lanes if lane[0] == label)
    flops = 2.0 * float(stats.flop)
    bytes_moved = spgemm_traffic_bytes(
        n_rows=stats.n_rows, nnz_a=float(stats.nnz_a),
        flop=float(stats.flop), nnz_c=float(stats.nnz_c_est),
        itemsize=KERNEL_ITEMSIZE)
    roof = spgemm_roofline(flops, bytes_moved, us * 1e-6)
    pdb.put(key, {
        "schema": SCHEMA_VERSION,
        "algorithm": algo,
        "table_scale": scale,
        "label": label,
        "us": us,
        "candidates": timings,
        "stats": fingerprint,
        "roofline": roof,
        "backend": backend_of(a.device),
        "x64": _x64(a, b),
    })
    return TunedChoice(algorithm=algo, table_scale=scale, us=us,
                       source="measured")
