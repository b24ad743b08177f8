"""Bench-trajectory ingestion (port of ``repro.autotune.feed``): feed a
benchmark run's ``--json`` rows into the
:class:`~repro_torch.autotune.db.PerfDB` and age them by recorded git sha.

Every suite row of a trajectory document becomes a ``bench``-kind entry
under the ``bench|<row name>|<backend>`` key namespace -- disjoint from
the ``spgemm|...`` winner keys, so :func:`measured_recommend` never reads
them; they exist so the perf history that CI gates on is also queryable
next to the tuner's winners (one DB, one dashboard).

Aging contract: a bench row timed at one ``git_sha`` says nothing about a
tree at another, so feeding a document recorded at sha *S* first drops
every bench entry recorded at a sha other than *S* (:meth:`PerfDB.age`),
then ingests the new rows.  Winner entries carry no sha semantics and are
never aged.  Like everything in :mod:`repro_torch.autotune.db`, ingestion
degrades with a warning instead of crashing.
"""
from __future__ import annotations

from .db import SCHEMA_VERSION, PerfDB, resolve_db

#: key namespace for ingested bench rows (kept out of the winner keys)
BENCH_KEY_PREFIX = "bench|"


def bench_row_key(name: str, backend: str) -> str:
    """DB key of one ingested bench row."""
    return f"{BENCH_KEY_PREFIX}{name}|{backend}"


def feed_bench_rows(doc: dict, db: PerfDB | str | None = None,
                    prune_stale: bool = True) -> int:
    """Ingest a benchmark run's JSON trajectory document.

    ``doc`` is the parsed document (``{"git_sha", "backend", "rows":
    [{"name", "us_per_call", ...}, ...]}``).  Rows without a name or a
    numeric timing are skipped.  With ``prune_stale`` (default) bench
    entries recorded at a different git sha are aged out first.  Returns
    the number of rows ingested.
    """
    pdb = resolve_db(db)
    sha = str(doc.get("git_sha", "unknown"))
    backend = str(doc.get("backend", "unknown"))
    entries = {}
    for row in doc.get("rows", []):
        if not isinstance(row, dict):
            continue
        name, us = row.get("name"), row.get("us_per_call")
        if not isinstance(name, str) or \
                not isinstance(us, (int, float)) or isinstance(us, bool):
            continue
        entries[bench_row_key(name, backend)] = {
            "schema": SCHEMA_VERSION,
            "kind": "bench",
            "us": float(us),
            "derived": row.get("derived", ""),
            "git_sha": sha,
            "backend": backend,
        }
    if prune_stale:
        pdb.age(current_sha=sha, prefix=BENCH_KEY_PREFIX)
    pdb.update(entries)
    return len(entries)
