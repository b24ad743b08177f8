"""The port's measured recipe and perf DB (``repro_torch.autotune``) and
SpGEMM roofline (``repro_torch.analysis.roofline``), on the CPU.

The first half ports ``tests/test_autotune.py`` case for case, with the
port's DB, counters and plans.  Robustness contract: a missing /
truncated / corrupt / unknown-schema DB file and a stale (drifted) entry
degrade to the heuristic recipe with an :class:`AutotuneDBWarning` --
never a crash, never an entry served for the wrong structure.  Effort
contract: a DB hit does **zero** microbenchmarks (``candidates_timed``).

The second half holds the port against ``repro`` on the same numpy
operands (``tests/_fuzz.py`` shapes: sorted, unsorted, masked, a general
semiring, block-dense): the key's fields other than the backend, the
candidate lanes, the plans an injected DB entry gives (bitwise), and the
roofline numbers at equal rates.  Last, the deliberate difference: a
``pb`` winner is served from the port's DB, where the reference refuses it.
"""
import json
import os
import sys
import warnings

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import jax.numpy as jnp  # noqa: E402

import repro.autotune as JA  # noqa: E402
import repro.core as J  # noqa: E402
from repro.analysis import roofline as jroof  # noqa: E402
from repro.autotune import measure as jmeasure  # noqa: E402
from repro.core import recipe as jrecipe  # noqa: E402
from repro.verify.bounds import check_plan_vcs  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.analysis import roofline as troof  # noqa: E402
from repro_torch.autotune import (AutotuneDBWarning, PerfDB,  # noqa: E402
                                  SCHEMA_VERSION, TunedChoice, db_key,
                                  measure_call_counts, measured_recommend,
                                  reset_measure_calls)
from repro_torch.autotune import db as tdb  # noqa: E402
from repro_torch.autotune import measure as tmeasure  # noqa: E402
from repro_torch.core.recipe import measure_stats, recommend  # noqa: E402
from repro_torch.data import rmat  # noqa: E402
from _fuzz import (block_clustered_dense, csr_of, rand_dense,  # noqa: E402
                   scramble_rows)

ALGOS = tdb.KNOWN_ALGORITHMS


@pytest.fixture(autouse=True)
def _fresh_caches():
    J.clear_plan_cache()
    T.clear_plan_cache()
    yield
    J.clear_plan_cache()
    T.clear_plan_cache()


def _pair(seed=0, scale=5, ef=3):
    return (rmat.rmat_csr(scale, ef, "G500", seed=seed, device="cpu"),
            rmat.rmat_csr(scale, ef, "ER", seed=seed + 50, device="cpu"))


def _entry(measured, **overrides):
    """A winner entry whose stats block is ``measured``'s (a
    ``SpGEMMStats`` of either package), with ``overrides`` on top."""
    entry = {"schema": SCHEMA_VERSION, "algorithm": "esc", "table_scale": 1,
             "us": 100.0, "candidates": {"esc": 100.0},
             "stats": {"flop": float(measured.flop),
                       "nnz_a": float(measured.nnz_a),
                       "nnz_c": float(measured.nnz_c_est)},
             "backend": "torch-cpu", "x64": False}
    entry.update(overrides)
    return entry


def _seed_entry(db: PerfDB, a, b, **overrides):
    """Plant a plausible winner entry for (a, b) directly."""
    key = db_key(a, b)
    db.put(key, _entry(measure_stats(a, b), **overrides))
    return key


def _dense_product(a, b):
    return a.to_dense().double() @ b.to_dense().double()


# ---------------------------------------------------------------------------
# DB file robustness: degrade, warn, never crash, never mis-key
# ---------------------------------------------------------------------------

def test_db_missing_file_is_empty_without_warning(tmp_path):
    db = PerfDB(str(tmp_path / "nope.json"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # a missing DB is normal
        assert db.load() == {}
        assert db.get("anything") is None


def test_db_truncated_json_degrades_with_warning(tmp_path):
    path = tmp_path / "db.json"
    db = PerfDB(str(path))
    a, b = _pair(seed=1)
    _seed_entry(db, a, b)
    full = path.read_text()
    path.write_text(full[: len(full) // 2])     # torn write / truncation
    with pytest.warns(AutotuneDBWarning, match="unreadable"):
        assert db.load() == {}
    with pytest.warns(AutotuneDBWarning):
        assert measured_recommend(a, b, db=db, measure=False) is None


def test_db_corrupt_json_degrades_and_heals_on_next_put(tmp_path):
    path = tmp_path / "db.json"
    path.write_text("{not json at all")
    db = PerfDB(str(path))
    a, b = _pair(seed=2)
    with pytest.warns(AutotuneDBWarning):
        assert db.get(db_key(a, b)) is None
    # the next put rewrites a clean schema-1 document
    with pytest.warns(AutotuneDBWarning):       # put re-loads the bad file
        key = _seed_entry(db, a, b)
    doc = json.loads(path.read_text())
    assert doc["schema"] == SCHEMA_VERSION and key in doc["entries"]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert db.get(key) is not None


@pytest.mark.parametrize("document,match", [
    ({"schema": 99, "entries": {"k": {}}}, "schema"),   # unknown version
    ([1, 2, 3], "schema"),                              # not a dict
    ({"schema": 1, "entries": "oops"}, "malformed"),    # bad entries block
], ids=("unknown_schema", "non_dict", "entries_not_dict"))
def test_db_untrusted_document_degrades(tmp_path, document, match):
    path = tmp_path / "db.json"
    path.write_text(json.dumps(document))
    db = PerfDB(str(path))
    with pytest.warns(AutotuneDBWarning, match=match):
        assert db.load() == {}


@pytest.mark.parametrize("overrides,match", [
    ({"stats": {"flop": 1e9, "nnz_a": 1e9, "nnz_c": 1e9}}, "drifted"),
    ({"algorithm": "quantum_annealer"}, "unknown algorithm"),
    ({"stats": None}, "stats block"),
    ({"stats": {"nnz_a": 1.0}}, "missing stat"),
], ids=("drifted", "unknown_algorithm", "no_stats", "missing_stat"))
def test_db_untrusted_entry_is_remeasured_not_served(tmp_path, overrides,
                                                     match):
    """An entry whose recorded stats disagree with the request's measured
    stats past the tolerance (the stale-digest guard), that names an
    algorithm the port does not know, or that lacks its stats, is dropped
    with a warning."""
    db = PerfDB(str(tmp_path / "db.json"))
    a, b = _pair(seed=3)
    _seed_entry(db, a, b, **overrides)
    with pytest.warns(AutotuneDBWarning, match=match):
        assert measured_recommend(a, b, db=db, measure=False) is None


def test_db_never_mis_keys_across_structures(tmp_path):
    """A winner recorded for one structure is invisible to a different
    structure of the same shape -- the digest key, not the shape, is the
    identity."""
    db = PerfDB(str(tmp_path / "db.json"))
    a, b = _pair(seed=5)
    _seed_entry(db, a, b)
    a2, b2 = _pair(seed=6)                      # same shapes, new structure
    assert db_key(a2, b2) != db_key(a, b)
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # a clean miss, no warning
        assert measured_recommend(a2, b2, db=db, measure=False) is None


def test_recommend_measured_mode_survives_corrupt_db(tmp_path):
    """End-to-end: mode="measured" against garbage on disk still returns
    a valid algorithm (and heals the DB), with warnings, not a crash."""
    path = tmp_path / "db.json"
    path.write_text('{"schema": 1, "entries": "oops"}')
    a, b = _pair(seed=7, scale=4)               # tiny: it will measure
    with pytest.warns(AutotuneDBWarning):
        algo, stats = recommend(a, b, mode="measured", db=str(path))
    assert algo in ALGOS and stats.flop > 0
    assert json.loads(path.read_text())["schema"] == SCHEMA_VERSION


def test_unwritable_db_still_returns_the_measured_winner(tmp_path):
    """A DB path that cannot be written warns and persists nothing; the
    measured choice still reaches the caller."""
    blocker = tmp_path / "file"
    blocker.write_text("")
    db = PerfDB(str(blocker / "db.json"))       # parent is a regular file
    a, b = _pair(seed=17, scale=4)
    with pytest.warns(AutotuneDBWarning, match="not writable"):
        choice = measured_recommend(a, b, db=db)
    assert choice is not None and choice.source == "measured"


# ---------------------------------------------------------------------------
# Determinism / convergence: two measuring processes, one entry
# ---------------------------------------------------------------------------

def test_two_writers_converge_on_one_entry(tmp_path):
    """Two PerfDB handles on one path (two processes in miniature): both
    measure the same digest; the file ends with exactly one entry for it
    and the second handle's read agrees with what it wrote."""
    path = str(tmp_path / "db.json")
    a, b = _pair(seed=8, scale=4)
    c1 = measured_recommend(a, b, db=PerfDB(path))
    c2 = measured_recommend(a, b, db=PerfDB(path))
    assert c1 is not None and c1.source == "measured"
    assert c2 is not None and c2.source == "db"
    assert c2.algorithm == c1.algorithm
    entries = PerfDB(path).load()
    assert len(entries) == 1
    (key,) = entries
    assert key == db_key(a, b)


def test_concurrent_puts_merge_not_clobber(tmp_path):
    """Interleaved writers with distinct keys both land: put re-reads the
    file before writing, so the last writer merges rather than erases."""
    path = str(tmp_path / "db.json")
    db1, db2 = PerfDB(path), PerfDB(path)
    a, b = _pair(seed=9)
    a2, b2 = _pair(seed=10)
    k1 = _seed_entry(db1, a, b)
    k2 = _seed_entry(db2, a2, b2)               # db2 never saw k1 in memory
    entries = PerfDB(path).load()
    assert set(entries) == {k1, k2}


# ---------------------------------------------------------------------------
# Effort counters: a DB hit measures nothing
# ---------------------------------------------------------------------------

def test_db_hit_does_zero_microbenchmarks(tmp_path):
    db = PerfDB(str(tmp_path / "db.json"))
    a, b = _pair(seed=11, scale=4)
    reset_measure_calls()
    first = measured_recommend(a, b, db=db)
    calls = measure_call_counts()
    assert first.source == "measured" and calls["candidates_timed"] > 0
    reset_measure_calls()
    again = measured_recommend(a, b, db=db)
    calls = measure_call_counts()
    assert again.source == "db"
    assert calls["candidates_timed"] == 0, calls
    assert calls["db_hits"] == 1 and calls["db_misses"] == 0


def test_plan_autotune_repeat_hits_db_and_records_provenance(tmp_path):
    db = PerfDB(str(tmp_path / "db.json"))
    a, b = _pair(seed=12, scale=4)
    p_meas = T.plan_spgemm(a, b, autotune=True, autotune_db=db, cache=False)
    assert p_meas.provenance == "measured"
    reset_measure_calls()
    p2 = T.plan_spgemm(a, b, autotune=True, autotune_db=db, cache=False)
    assert p2.provenance == "measured"
    assert p2.algorithm == p_meas.algorithm
    assert measure_call_counts()["candidates_timed"] == 0
    # provenance of the other two resolution paths
    assert T.plan_spgemm(a, b, cache=False).provenance == "heuristic"
    assert T.plan_spgemm(a, b, algorithm="esc",
                         cache=False).provenance == "explicit"
    # autotuned vs heuristic requests are distinct plan-cache entries
    T.clear_plan_cache()
    p_h = T.plan_spgemm(a, b)
    p_m = T.plan_spgemm(a, b, autotune=True, autotune_db=db)
    assert p_h is not p_m and p_h.key != p_m.key
    assert T.plan_spgemm(a, b, autotune=True, autotune_db=db) is p_m


def test_measured_plan_output_matches_oracle(tmp_path):
    db = PerfDB(str(tmp_path / "db.json"))
    a, b = _pair(seed=13, scale=4)
    plan = T.plan_spgemm(a, b, autotune=True, autotune_db=db, cache=False)
    assert torch.allclose(plan.execute(a, b).to_dense().double(),
                          _dense_product(a, b), atol=1e-3)


def test_plan_cache_keys_autotuned_plans_by_db_path(tmp_path):
    """A cached measured plan is served again for its own DB, and a
    request naming another DB consults that DB instead."""
    a, b = _pair(seed=17, scale=4)
    dbs = [PerfDB(str(tmp_path / f"db{i}.json")) for i in range(2)]
    for db, algorithm in zip(dbs, ("esc", "hash_jnp")):
        _seed_entry(db, a, b, algorithm=algorithm)
    reset_measure_calls()
    p0 = T.plan_spgemm(a, b, autotune=True, autotune_db=dbs[0])
    p1 = T.plan_spgemm(a, b, autotune=True, autotune_db=dbs[1])
    assert (p0.algorithm, p1.algorithm) == ("esc", "hash_jnp")
    assert p0.key != p1.key
    assert T.plan_spgemm(a, b, autotune=True, autotune_db=dbs[0]) is p0
    # a path string names the same DB as the PerfDB opened on it
    assert T.plan_spgemm(a, b, autotune=True,
                         autotune_db=dbs[1].path) is p1
    assert measure_call_counts() == {"recommends": 2, "db_hits": 2,
                                     "db_misses": 0, "candidates_timed": 0}


def test_autotuned_plan_inspects_once(tmp_path, monkeypatch):
    """The race's lanes share the planner's own inspection: a miss of
    ``plan_spgemm(autotune=True)`` runs the structural half once."""
    from repro_torch.core import plan as tplan
    calls = []
    inspect = tplan.inspect_spgemm

    def counted(*args, **kwargs):
        calls.append(kwargs.get("algorithm"))
        return inspect(*args, **kwargs)

    monkeypatch.setattr(tplan, "inspect_spgemm", counted)
    a, b = _pair(seed=18, scale=4)
    reset_measure_calls()
    plan = T.plan_spgemm(a, b, autotune=True,
                         autotune_db=str(tmp_path / "db.json"), cache=False)
    assert plan.provenance == "measured" and calls == ["auto"]
    assert measure_call_counts()["candidates_timed"] == \
        len(tmeasure._candidates(a, b, "plus_times", None))


# ---------------------------------------------------------------------------
# A lane that fails: dropped on the CPU, raised on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device,exc,drops", (
    ("cpu", RuntimeError("launch failed"), True),
    ("cpu", ValueError("does not apply"), True),
    ("cuda", RuntimeError("launch failed"), False),
    ("cuda", ValueError("wrapper refused its operands"), False),
    ("cuda", AssertionError("heap path requires sorted inputs"), False),
    ("cuda", torch.cuda.OutOfMemoryError("out of memory"), True)))
def test_lane_failure_policy(device, exc, drops):
    assert tmeasure._lane_may_drop(exc, torch.device(device)) is drops


def test_failed_lane_drops_out_on_the_cpu(tmp_path, monkeypatch):
    """On the CPU a lane that raises drops out with a warning, as in the
    reference, and the race goes on with the others."""
    from repro_torch.kernels.spgemm_hash import ops as hash_ops
    spgemm_hash = hash_ops.spgemm_hash

    def broken(*args, vector=False, **kwargs):
        if vector:
            raise RuntimeError("injected")
        return spgemm_hash(*args, vector=vector, **kwargs)

    monkeypatch.setattr(hash_ops, "spgemm_hash", broken)
    a, b = _pair(seed=19, scale=4)
    db = PerfDB(str(tmp_path / "db.json"))
    with pytest.warns(AutotuneDBWarning, match="hash_vector"):
        choice = measured_recommend(a, b, db=db)
    (entry,) = db.load().values()
    lanes = {label for label, _, _ in
             tmeasure._candidates(a, b, "plus_times", None)}
    assert set(entry["candidates"]) == \
        lanes - {"hash_vector", "hash_vector@t2"}
    assert choice.algorithm != "hash_vector"


def test_rounds_interleave_and_pair_against_the_fastest_lane():
    """Repetitions go in rounds, each round in the other order; a lane
    that takes fewer repetitions stops early; each lane's time is the
    fastest lane's median times its median ratio to it within a round, so
    a drift that moves every lane alike cancels."""
    calls = []

    def lane(label, values):
        values = list(values)

        def sample():
            calls.append(label)
            return values.pop(0)
        return sample

    samplers = {"a": (lane("a", (10.0, 40.0, 20.0)), 3),
                "b": (lane("b", (11.0, 44.0, 22.0)), 3),
                "c": (lane("c", (30.0,)), 1)}
    samples = tmeasure._rounds(samplers)
    assert calls == ["a", "b", "c", "b", "a", "a", "b"]
    assert samples == {"a": [10.0, 40.0, 20.0], "b": [11.0, 44.0, 22.0],
                       "c": [30.0]}
    assert tmeasure._paired(samples) == pytest.approx(
        {"a": 20.0, "b": 22.0, "c": 60.0})


def test_race_report_row():
    """The report row of a race: the winner is the fastest lane, Table
    4's lane beside it, and the spread between a ``@t2`` lane and its
    scale-1 lane only where the doubled tables clip to the same program."""
    a, b = _pair(seed=20, scale=4)
    heur = T.plan_spgemm(a, b, cache=False)
    lanes = {"esc": 400.0, heur.algorithm: 200.0, "hash": 100.0,
             "hash@t2": 125.0}
    row = tmeasure.race_report(heur, lanes)
    assert (row["winner"], row["winner_us"]) == ("hash", 100.0)
    assert row["heuristic_us"] == lanes[heur.algorithm]
    assert row["heuristic_over_winner"] == lanes[heur.algorithm] / 100.0
    assert row["heap_steps"] == int(heur.flop.max())
    assert row["compression"] == heur.total_flop / heur.nnz_c
    scaled = tmeasure._scaled_plan(heur, 2, b.n_cols)
    clipped = scaled.table_size == heur.table_size and \
        torch.equal(scaled.bin_tsize, heur.bin_tsize)
    assert row["same_program_spread"] == ({"hash": 0.25} if clipped else {})
    # a whole-width table (every column in one table) is always clipped
    wide = tmeasure._scaled_plan(heur, 64, b.n_cols)
    row = tmeasure.race_report(wide, lanes)
    assert row["same_program_spread"] == {"hash": 0.25}


# ---------------------------------------------------------------------------
# Scaled-table variants keep the schedule bounds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale", (2, 4))
def test_scaled_table_variant_passes_plan_vcs(scale):
    """The port's x``scale`` variant has the reference's sizes bitwise, the
    reference's variant passes its plan VCs, and the port's still computes
    the same product."""
    a, b = _pair(seed=14)
    base = T.plan_spgemm(a, b, algorithm="hash", cache=False)
    variant = tmeasure._scaled_plan(base, scale, b.n_cols)
    ja, jb = _to_ref(a), _to_ref(b)
    jvariant = jmeasure._scaled_plan(
        J.plan_spgemm(ja, jb, algorithm="hash", cache=False), scale,
        jb.n_cols)
    failures = [vc for vc in check_plan_vcs(jvariant) if not vc.ok]
    assert not failures, failures
    assert variant.table_size == jvariant.table_size >= base.table_size
    assert variant.bin_tsize.dtype == torch.int32
    assert np.array_equal(variant.bin_tsize.numpy(),
                          np.asarray(jvariant.bin_tsize))
    assert torch.allclose(variant.execute(a, b).to_dense().double(),
                          _dense_product(a, b), atol=1e-3)


@pytest.mark.parametrize("algorithm", ("hash", "hash_vector"))
def test_tuned_choice_threads_table_scale_into_plan(tmp_path, algorithm):
    """A DB entry naming a table-scale variant actually scales the frozen
    schedule, and the plan still computes the product."""
    db = PerfDB(str(tmp_path / "db.json"))
    a, b = _pair(seed=15)
    base = T.plan_spgemm(a, b, algorithm=algorithm, cache=False)
    _seed_entry(db, a, b, algorithm=algorithm, table_scale=2)
    plan = T.plan_spgemm(a, b, autotune=True, autotune_db=db, cache=False)
    assert plan.provenance == "measured" and plan.algorithm == algorithm
    want = tmeasure._scaled_plan(base, 2, b.n_cols)
    assert plan.table_size == want.table_size >= base.table_size
    assert torch.equal(plan.bin_tsize, want.bin_tsize)
    assert torch.allclose(plan.execute(a, b).to_dense().double(),
                          _dense_product(a, b), atol=1e-3)


# ---------------------------------------------------------------------------
# Roofline context helpers
# ---------------------------------------------------------------------------

def test_spgemm_roofline_classifies_bounds():
    # sparse products are memory-bound: ~1 flop/byte << machine balance
    nbytes = troof.spgemm_traffic_bytes(n_rows=1000, nnz_a=8000, flop=64000,
                                        nnz_c=32000)
    roof = troof.spgemm_roofline(2.0 * 64000, nbytes, seconds=1e-3)
    assert roof["bound"] == "memory"
    assert 0.0 < roof["roof_fraction"]
    # a hypothetical compute-heavy op flips the bound
    roof2 = troof.spgemm_roofline(1e15, 1e6, seconds=1.0)
    assert roof2["bound"] == "compute"
    # the card's rates, once: fp32 CUDA cores by default
    assert (troof.HBM_BW, troof.FP32_FLOPS, troof.BF16_FLOPS) == \
        (3.35e12, 67e12, 989e12)
    assert roof2["compute_s"] == 1e15 / troof.FP32_FLOPS


def test_measured_entry_records_roofline_and_candidates(tmp_path):
    db = PerfDB(str(tmp_path / "db.json"))
    a, b = _pair(seed=16, scale=4)
    choice = measured_recommend(a, b, db=db)
    assert isinstance(choice, TunedChoice)
    (entry,) = db.load().values()
    assert entry["roofline"]["bound"] in ("memory", "compute")
    assert entry["candidates"] and \
        min(entry["candidates"].values()) == entry["us"]
    assert entry["algorithm"] in ALGOS
    assert entry["backend"] == "torch-cpu" and entry["x64"] is False
    # the roofline of the winner's time at 4-byte values
    s = measure_stats(a, b)
    nbytes = troof.spgemm_traffic_bytes(
        n_rows=s.n_rows, nnz_a=s.nnz_a, flop=s.flop, nnz_c=s.nnz_c_est,
        itemsize=4)
    assert entry["roofline"] == troof.spgemm_roofline(
        2.0 * s.flop, nbytes, entry["us"] * 1e-6)


# ---------------------------------------------------------------------------
# Bench-trajectory ingestion: feed + sha aging (repro_torch.autotune.feed)
# ---------------------------------------------------------------------------

def _traj_doc(sha, rows, backend="cpu"):
    """A minimal benchmark trajectory document."""
    return {"schema": 1, "git_sha": sha, "backend": backend,
            "rows": rows}


def test_feed_bench_rows_ingests_under_bench_namespace(tmp_path):
    from repro_torch.autotune import bench_row_key, feed_bench_rows
    db = PerfDB(str(tmp_path / "db.json"))
    doc = _traj_doc("aaa111", [
        {"name": "bcsr,diag16x8,block", "us_per_call": 12.5,
         "derived": "nnzb=16"},
        {"name": "plan,s5", "us_per_call": 3.0},
        {"name": "broken-no-timing"},               # skipped: no us
        {"name": 42, "us_per_call": 1.0},           # skipped: bad name
        {"name": "bool-timing", "us_per_call": True},  # skipped: bool
    ])
    assert feed_bench_rows(doc, db=db) == 2
    entry = db.load()[bench_row_key("bcsr,diag16x8,block", "cpu")]
    assert entry["kind"] == "bench" and entry["us"] == 12.5
    assert entry["git_sha"] == "aaa111" and entry["schema"] == SCHEMA_VERSION


def test_feed_ages_stale_shas_but_never_winners(tmp_path):
    """Re-feeding at a new sha drops the old sha's bench rows while winner
    entries -- which carry no sha semantics -- survive untouched."""
    from repro_torch.autotune import BENCH_KEY_PREFIX, bench_row_key, \
        feed_bench_rows
    db = PerfDB(str(tmp_path / "db.json"))
    a, b = _pair(seed=21, scale=4)
    winner_key = _seed_entry(db, a, b)

    feed_bench_rows(_traj_doc("sha_A", [
        {"name": "bcsr,diag16x8,block", "us_per_call": 10.0},
        {"name": "plan,s5", "us_per_call": 5.0}]), db=db)
    feed_bench_rows(_traj_doc("sha_B", [
        {"name": "bcsr,diag16x8,block", "us_per_call": 11.0}]), db=db)

    entries = db.load()
    bench_keys = [k for k in entries if k.startswith(BENCH_KEY_PREFIX)]
    assert bench_keys == [bench_row_key("bcsr,diag16x8,block", "cpu")]
    assert entries[bench_keys[0]]["git_sha"] == "sha_B"
    assert winner_key in entries          # winners never aged


def test_age_is_prefix_scoped_and_counts(tmp_path):
    from repro_torch.autotune import bench_row_key
    db = PerfDB(str(tmp_path / "db.json"))
    db.update({
        bench_row_key("r1", "cpu"): {"kind": "bench", "git_sha": "old"},
        bench_row_key("r2", "cpu"): {"kind": "bench", "git_sha": "new"},
        bench_row_key("r3", "cpu"): {"kind": "bench"},  # sha-less: kept
    })
    assert db.age(current_sha="new") == 1
    kept = sorted(db.load())
    assert kept == sorted([bench_row_key("r2", "cpu"),
                           bench_row_key("r3", "cpu")])
    assert db.age(current_sha="new") == 0   # idempotent


def test_default_db_path_is_the_ports_own(tmp_path, monkeypatch):
    """The port never reads the reference's DB: its own variable and
    file."""
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_DB", raising=False)
    monkeypatch.setenv("REPRO_AUTOTUNE_DB", str(tmp_path / "jax.json"))
    assert tdb.default_db_path().endswith(
        os.path.join("repro-spgemm-torch", "autotune.json"))
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_DB", str(tmp_path / "t.json"))
    assert tdb.default_db_path() == str(tmp_path / "t.json")
    assert PerfDB().path == str(tmp_path / "t.json")


# ---------------------------------------------------------------------------
# Parity with repro on the same numpy operands
# ---------------------------------------------------------------------------

def _to_port(a):
    return T.CSR.from_numpy(np.asarray(a.indptr), np.asarray(a.indices),
                            np.asarray(a.data), int(a.nnz), a.shape,
                            a.sorted_cols, device="cpu")


def _to_ref(a):
    arrays = (a.indptr, a.indices, a.data)
    return J.CSR(*(jnp.asarray(x.numpy()) for x in arrays),
                 jnp.asarray(int(a.nnz), jnp.int32), a.shape, a.sorted_cols)


def _case(name):
    """(A, B, mask, semiring) as reference CSRs, from ``_fuzz`` shapes."""
    a = csr_of(rand_dense(24, 20, 0.25, seed=1))
    b = csr_of(rand_dense(20, 28, 0.25, seed=2))
    if name == "sorted":
        return a, b, None, "plus_times"
    if name == "unsorted":
        return scramble_rows(a), scramble_rows(b), None, "plus_times"
    if name == "masked":
        return a, b, csr_of(rand_dense(24, 28, 0.4, seed=3)), "plus_times"
    if name == "semiring":
        return a, b, None, "min_plus"
    if name == "block":
        d = block_clustered_dense(8, 8, 8, 8, 0.3, seed=4)
        return csr_of(d), csr_of(d), None, "plus_times"
    raise ValueError(name)


CASES = ("sorted", "unsorted", "masked", "semiring", "block")


def _both(name):
    ja, jb, jm, sr = _case(name)
    tm = None if jm is None else _to_port(jm)
    return (ja, jb, jm), (_to_port(ja), _to_port(jb), tm), sr


@pytest.mark.parametrize("sorted_output", (False, True))
@pytest.mark.parametrize("name", CASES)
def test_db_key_fields_match_reference(name, sorted_output):
    (ja, jb, jm), (ta, tb, tm), sr = _both(name)
    for cmpl in ((False, True) if jm is not None else (False,)):
        jk = JA.db_key(ja, jb, jm, semiring=sr, sorted_output=sorted_output,
                       complement_mask=cmpl).split("|")
        tk = db_key(ta, tb, tm, semiring=sr, sorted_output=sorted_output,
                    complement_mask=cmpl).split("|")
        assert len(jk) == len(tk) == 9
        assert tk[7] == "torch-cpu" and jk[7] == "cpu"
        assert jk[:7] + jk[8:] == tk[:7] + tk[8:]


def test_db_key_width_follows_the_values():
    a, b = _pair(seed=30)
    a64 = T.CSR(a.indptr, a.indices, a.data.double(), a.nnz, a.shape,
                a.sorted_cols)
    assert db_key(a, b).endswith("|torch-cpu|x32")
    assert db_key(a64, b).endswith("|torch-cpu|x64")
    assert db_key(a64, b).rsplit("|", 2)[0] == db_key(a, b).rsplit("|", 2)[0]


@pytest.mark.parametrize("name", CASES)
def test_candidate_lanes_match_reference(name):
    (ja, jb, jm), (ta, tb, tm), sr = _both(name)
    jl = jmeasure._candidates(ja, jb, sr, jm)
    tl = tmeasure._candidates(ta, tb, sr, tm)
    assert tl == jl
    if name == "block":
        assert ("bcsr", "bcsr", 1) in tl
    if name in ("masked", "semiring"):
        assert [x[0] for x in tl] == ["esc", "heap", "hash_jnp"]


@pytest.mark.parametrize("algorithm,scale", (("hash_vector", 2),
                                             ("esc", 1)))
@pytest.mark.parametrize("name", CASES)
def test_injected_entry_plans_match_reference(tmp_path, name, algorithm,
                                              scale):
    """The same winner written under each package's key gives plans whose
    choice, provenance, tables and output structure are bitwise the
    reference's."""
    (ja, jb, jm), (ta, tb, tm), sr = _both(name)
    req = dict(semiring=sr, complement_mask=False, sorted_output=False)
    jdb = JA.PerfDB(str(tmp_path / "jax.json"))
    tdb_ = PerfDB(str(tmp_path / "torch.json"))
    js = jrecipe.measure_stats(ja, jb, mask=jm)
    ts = measure_stats(ta, tb, mask=tm)
    assert (js.flop, js.nnz_a) == (ts.flop, ts.nnz_a)
    overrides = dict(algorithm=algorithm, table_scale=scale)
    jdb.put(JA.db_key(ja, jb, jm, **req), _entry(js, **overrides))
    tdb_.put(db_key(ta, tb, tm, **req), _entry(ts, **overrides))
    jp = J.plan_spgemm(ja, jb, mask=jm, autotune=True, autotune_db=jdb,
                       cache=False, **req)
    reset_measure_calls()
    tp = T.plan_spgemm(ta, tb, mask=tm, autotune=True, autotune_db=tdb_,
                       cache=False, **req)
    assert measure_call_counts()["candidates_timed"] == 0
    assert tp.algorithm == jp.algorithm == algorithm
    assert tp.provenance == jp.provenance == "measured"
    assert tp.table_size == jp.table_size and tp.cap_c == jp.cap_c
    for f in ("bin_tsize", "indptr_c"):
        x, y = np.asarray(getattr(jp, f)), getattr(tp, f).numpy()
        assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("itemsize", (4, 8))
@pytest.mark.parametrize("work", [
    dict(n_rows=1000, nnz_a=8000, flop=64000, nnz_c=32000),
    dict(n_rows=262144, nnz_a=4194176, flop=67106183, nnz_c=66326816),
    dict(n_rows=1, nnz_a=0, flop=0, nnz_c=0),
], ids=("small", "er_s18", "empty"))
def test_roofline_matches_reference_at_equal_rates(work, itemsize):
    tb = troof.spgemm_traffic_bytes(itemsize=itemsize, **work)
    assert tb == jroof.spgemm_traffic_bytes(itemsize=itemsize, **work)
    for seconds in (1e-3, 0.0, 2.5):
        for rates in ((troof.FP32_FLOPS, troof.HBM_BW),
                      (jroof.PEAK_FLOPS, jroof.HBM_BW)):
            flops = 2.0 * work["flop"]
            assert troof.spgemm_roofline(flops, tb, seconds, *rates) == \
                jroof.spgemm_roofline(flops, tb, seconds, *rates)


# ---------------------------------------------------------------------------
# The deliberate difference: pb is a known algorithm here
# ---------------------------------------------------------------------------

def test_pb_winner_is_served_from_the_db(tmp_path):
    """The race times a ``pb`` lane, so a ``pb`` winner must be servable:
    the port's DB serves it with nothing timed; the reference's refuses it
    (its ``KNOWN_ALGORITHMS`` lacks ``pb``) and would measure again."""
    a, b = _pair(seed=31)
    db = PerfDB(str(tmp_path / "db.json"))
    _seed_entry(db, a, b, algorithm="pb")
    reset_measure_calls()
    choice = measured_recommend(a, b, db=db)
    assert choice == TunedChoice("pb", 1, 100.0, "db")
    plan = T.plan_spgemm(a, b, autotune=True, autotune_db=db, cache=False)
    assert plan.algorithm == "pb" and plan.provenance == "measured"
    assert plan.pb_plan is not None
    assert measure_call_counts()["candidates_timed"] == 0
    assert torch.allclose(plan.execute(a, b).to_dense().double(),
                          _dense_product(a, b), atol=1e-3)
    ja, jb = _to_ref(a), _to_ref(b)
    jdb = JA.PerfDB(str(tmp_path / "jax.json"))
    jdb.put(JA.db_key(ja, jb), _entry(measure_stats(a, b), algorithm="pb"))
    with pytest.warns(UserWarning, match="unknown algorithm"):
        assert JA.measured_recommend(ja, jb, db=jdb, measure=False) is None
