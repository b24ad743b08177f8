"""Measured SpGEMM recipe backed by a persistent performance database
(port of ``repro.autotune``).

Public surface:

  * :func:`measured_recommend` -- DB-first measured algorithm choice;
    what ``recipe.recommend(mode="measured")`` and
    ``plan_spgemm(autotune=True)`` delegate to.
  * :class:`PerfDB` / :func:`default_db_path` -- the JSON results DB.
  * :class:`TunedChoice` -- a resolved choice (algorithm, table scale,
    timing, db-vs-measured source).
  * :class:`AutotuneDBWarning` -- every degraded path warns with this.
  * :func:`reset_measure_calls` / :func:`measure_call_counts` -- the
    effort counters tests use to prove a DB hit measures nothing.
  * :func:`time_plans` / :func:`race_lanes` / :func:`race_report` -- the
    race's timer, the race itself and one report row of it, for tools
    that time lanes or compare a measured plan with another.
  * :func:`feed_bench_rows` / :func:`bench_row_key` -- bench-trajectory
    ingestion under the ``bench|`` namespace, aged by recorded git sha.

This package lives *outside* ``repro_torch.core``: it times wall-clock
and CUDA events, and core imports it lazily, only when a caller asks for
measured mode.
"""
from .db import DRIFT_TOLERANCE, SCHEMA_VERSION, AutotuneDBWarning, \
    PerfDB, default_db_path, resolve_db
from .feed import BENCH_KEY_PREFIX, bench_row_key, feed_bench_rows
from .measure import MEASURE_CALLS, TABLE_SCALES, TunedChoice, db_key, \
    measure_call_counts, measured_recommend, race_lanes, race_report, \
    reset_measure_calls, time_plans

__all__ = [
    "AutotuneDBWarning", "BENCH_KEY_PREFIX", "DRIFT_TOLERANCE",
    "MEASURE_CALLS", "PerfDB", "SCHEMA_VERSION", "TABLE_SCALES",
    "TunedChoice", "bench_row_key", "db_key", "default_db_path",
    "feed_bench_rows", "measure_call_counts", "measured_recommend",
    "race_lanes", "race_report", "reset_measure_calls", "resolve_db",
    "time_plans",
]
