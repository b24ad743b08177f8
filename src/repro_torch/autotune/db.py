"""Persistent SpGEMM performance database (port of
``repro.autotune.db``).

A single JSON document on disk mapping autotune keys -- ``(structure
digest A, structure digest B, mask digest, semiring, sortedness,
backend, value width)`` rendered as a string, i.e. keyed exactly like
the plan cache plus the execution context -- to measured winner
entries::

    {
      "schema": 1,
      "entries": {
        "<key>": {
          "algorithm": "hash", "table_scale": 1,
          "us": 812.4,                       # winner median
          "candidates": {"esc": 1201.0, "hash": 812.4, ...},
          "stats": {"flop": 51200.0, "nnz_c": 9100.0, "nnz_a": 2048.0},
          "roofline": {"bound": "memory", ...},  # see analysis.roofline
          "backend": "torch-cuda:NVIDIA H100 80GB HBM3", "x64": false,
          "schema": 1
        }, ...
      }
    }

Robustness contract (pinned by ``tests/test_torch_autotune.py``): a
missing, truncated, corrupt, or unknown-schema file **never crashes and
never mis-keys** -- it reads as empty with an
:class:`AutotuneDBWarning`, and the next :meth:`PerfDB.put` rewrites a
clean schema-1 document.  Writes
are read-merge-replace under an atomic ``os.replace`` of a same-
directory temp file, so two processes measuring the same digest race
benignly: last writer wins for the shared key and the file is always a
complete, parseable document (the determinism test pins this).

Trust contract: an entry is only served while its recorded stats match
the request's freshly measured stats within :data:`DRIFT_TOLERANCE` --
a drifted entry (stale digest reuse, schema evolution of the stats
block) is dropped with a warning and re-measured, not trusted.

The port keeps its own file (:func:`default_db_path`), so a winner the
JAX package measured is never served to it, and its
:data:`KNOWN_ALGORITHMS` names ``pb``, the lane the measurement races
(the reference's list lacks it, so a ``pb`` winner there is re-measured
on every request).
"""
from __future__ import annotations

import json
import os
import pathlib
import warnings
from typing import Optional

#: current on-disk schema; files with any other version read as empty
SCHEMA_VERSION = 1

#: relative deviation between an entry's recorded stats and the
#: request's measured stats above which the entry is re-measured
DRIFT_TOLERANCE = 0.05

#: the stats fields the drift check compares.  Only fields that are
#: *exact* on every call path belong here: ``nnz_c`` is recorded too but
#: not compared, because callers without the symbolic phase's counts
#: hold an upper-bound estimate and would spuriously "drift" against an
#: entry recorded with the exact value.
_STAT_FIELDS = ("flop", "nnz_a")

#: algorithms an entry may legally name (anything else is schema drift)
KNOWN_ALGORITHMS = ("esc", "heap", "hash", "hash_vector", "hash_jnp",
                    "bcsr", "pb")


class AutotuneDBWarning(UserWarning):
    """A perf-DB file or entry could not be trusted; degraded safely."""


def default_db_path() -> str:
    """``$REPRO_TORCH_AUTOTUNE_DB`` or
    ``~/.cache/repro-spgemm-torch/autotune.json``."""
    env = os.environ.get("REPRO_TORCH_AUTOTUNE_DB")
    if env:
        return env
    return str(pathlib.Path.home() / ".cache" / "repro-spgemm-torch"
               / "autotune.json")


def _warn(msg: str) -> None:
    warnings.warn(msg, AutotuneDBWarning, stacklevel=3)


class PerfDB:
    """One JSON results database (lazy-loading, atomically rewritten)."""

    def __init__(self, path: Optional[str] = None):
        self.path = str(path) if path is not None else default_db_path()

    # -- reading --------------------------------------------------------
    def load(self) -> dict:
        """Entries dict; empty (with a warning) on any untrusted file."""
        try:
            with open(self.path) as f:
                doc = json.load(f)
        except FileNotFoundError:
            return {}
        except (OSError, json.JSONDecodeError, UnicodeDecodeError) as exc:
            _warn(f"autotune DB {self.path} unreadable "
                  f"({type(exc).__name__}: {exc}); treating as empty")
            return {}
        if not isinstance(doc, dict) or doc.get("schema") != SCHEMA_VERSION:
            got = doc.get("schema") if isinstance(doc, dict) else type(doc)
            _warn(f"autotune DB {self.path} has schema {got!r}, expected "
                  f"{SCHEMA_VERSION}; treating as empty")
            return {}
        entries = doc.get("entries")
        if not isinstance(entries, dict):
            _warn(f"autotune DB {self.path} entries block malformed; "
                  "treating as empty")
            return {}
        return entries

    def get(self, key: str, stats: Optional[dict] = None,
            tolerance: float = DRIFT_TOLERANCE) -> Optional[dict]:
        """Trusted entry for ``key`` or ``None``.

        ``stats`` (``{"flop", "nnz_c", "nnz_a"}`` of the *current*
        request) arms the drift check: a recorded entry whose stats
        deviate by more than ``tolerance`` relative is stale -- dropped
        with a warning so the caller re-measures instead of trusting it.
        Entries naming an unknown algorithm or missing their stats block
        are equally untrusted.
        """
        entry = self.load().get(key)
        if entry is None:
            return None
        if not isinstance(entry, dict) or \
                entry.get("algorithm") not in KNOWN_ALGORITHMS:
            named = entry.get("algorithm") if isinstance(entry, dict) \
                else entry
            _warn(f"autotune DB entry for {key!r} names unknown algorithm "
                  f"{named!r}; ignoring")
            return None
        recorded = entry.get("stats")
        if not isinstance(recorded, dict):
            _warn(f"autotune DB entry for {key!r} lacks its stats block; "
                  "re-measuring")
            return None
        if stats is not None:
            for field in _STAT_FIELDS:
                have, want = recorded.get(field), stats.get(field)
                if have is None or want is None:
                    _warn(f"autotune DB entry for {key!r} missing stat "
                          f"{field!r}; re-measuring")
                    return None
                denom = max(abs(float(want)), 1.0)
                if abs(float(have) - float(want)) / denom > tolerance:
                    _warn(f"autotune DB entry for {key!r} drifted: "
                          f"{field}={have} vs measured {want} "
                          f"(tolerance {tolerance}); re-measuring")
                    return None
        return entry

    # -- writing --------------------------------------------------------
    def _write(self, entries: dict) -> None:
        """Atomically replace the document with ``entries`` (same-directory
        temp file + ``os.replace``; failures warn and leave the DB as it
        was)."""
        doc = {"schema": SCHEMA_VERSION, "entries": entries}
        path = pathlib.Path(self.path)
        tmp = path.with_name(f"{path.name}.tmp.{os.getpid()}")
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except OSError as exc:
            _warn(f"autotune DB {self.path} not writable "
                  f"({type(exc).__name__}: {exc}); result not persisted")
            try:
                tmp.unlink(missing_ok=True)
            except OSError:
                pass

    def put(self, key: str, entry: dict) -> None:
        """Read-merge-replace: persist ``entry`` under ``key`` atomically.

        The current file is re-read first so concurrent writers merge
        rather than clobber each other's keys; the temp file lives in
        the same directory so ``os.replace`` is atomic on POSIX.  Write
        failures warn and leave the DB unchanged -- measurement results
        still flow back to the caller.
        """
        entries = self.load()
        entries[key] = entry
        self._write(entries)

    def update(self, mapping: dict) -> None:
        """:meth:`put` for many keys with a single read-merge-replace."""
        if not mapping:
            return
        entries = self.load()
        entries.update(mapping)
        self._write(entries)

    def age(self, current_sha: str, prefix: str = "bench|") -> int:
        """Drop ``prefix``-namespaced entries recorded at a different
        ``git_sha`` (the bench-trajectory aging contract: a row timed on
        old code says nothing about the current tree).  Returns the number
        of entries removed.  Winner entries (``spgemm|...``) carry no sha
        semantics and are never touched.
        """
        entries = self.load()
        stale = [k for k, e in entries.items()
                 if k.startswith(prefix) and isinstance(e, dict)
                 and e.get("git_sha") not in (None, current_sha)]
        if stale:
            for k in stale:
                del entries[k]
            self._write(entries)
        return len(stale)

    def __len__(self) -> int:
        return len(self.load())


def resolve_db(db) -> PerfDB:
    """Coerce ``None`` / path string / :class:`PerfDB` into a PerfDB."""
    if isinstance(db, PerfDB):
        return db
    return PerfDB(db)
