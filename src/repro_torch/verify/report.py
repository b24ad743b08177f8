"""Machine-readable report types for both analyzer layers (port of
``repro.verify.report``: the same JSON document, ``SCHEMA`` 1, the same
keys, so a reader of the reference's report reads this one).

The document written by ``python -m repro_torch.verify --json PATH`` has
one top-level dict per layer; ``ok`` is the gate.  ``sites``,
``violations`` and ``warnings`` are the reference's interval-proof
fields: the port proves no jaxpr sites (an eager execute has no jaxpr;
the VCs and the census take their place), so they stay empty.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

SCHEMA = 1
_MAX_WARNINGS = 25


@dataclasses.dataclass
class VC:
    """One concrete verification condition on a plan's frozen schedule."""
    name: str
    ok: bool
    detail: str = ""


@dataclasses.dataclass
class CaseReport:
    """Layer-1 verdict for one executor case."""
    kind: str                    # spgemm / batch / bcsr / pb / chain
    name: str                    # e.g. "spgemm/hash sorted=False"
    algorithm: str
    vcs: List[VC]
    site_counts: Dict[str, int]
    census: Dict[str, int]
    budget: Dict[str, Any]       # {"expected": {...}, "got": {...}, "ok": bool}
    violations: List[Dict[str, Any]]
    warnings: List[Dict[str, Any]]

    @property
    def ok(self) -> bool:
        return (not self.violations and self.budget.get("ok", False)
                and all(vc.ok for vc in self.vcs))

    def to_dict(self) -> Dict[str, Any]:
        return {
            "kind": self.kind, "name": self.name,
            "algorithm": self.algorithm, "ok": self.ok,
            "vcs": [dataclasses.asdict(vc) for vc in self.vcs],
            "sites": self.site_counts, "census": self.census,
            "budget": self.budget, "violations": self.violations,
            "warnings": self.warnings[:_MAX_WARNINGS],
        }


@dataclasses.dataclass
class Report:
    """Whole-run container: either layer may be absent (``None``)."""
    layer1: Optional[List[CaseReport]] = None
    layer2: Optional[list] = None        # List[LintViolation]
    layer2_files: int = 0
    layer2_waivers: Optional[list] = None

    @property
    def ok(self) -> bool:
        l1 = self.layer1 is None or all(c.ok for c in self.layer1)
        l2 = not self.layer2
        return l1 and l2

    def to_dict(self) -> Dict[str, Any]:
        doc: Dict[str, Any] = {"schema": SCHEMA, "ok": self.ok}
        if self.layer1 is not None:
            doc["layer1"] = layer1_to_dict(self.layer1)
        if self.layer2 is not None:
            doc["layer2"] = layer2_to_dict(
                self.layer2, self.layer2_files, self.layer2_waivers or [])
        return doc

    def to_json(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_dict(), fh, indent=2, sort_keys=True)
            fh.write("\n")


def layer1_to_dict(cases: List[CaseReport]) -> Dict[str, Any]:
    by_kind: Dict[str, List[Dict[str, Any]]] = {}
    for c in cases:
        by_kind.setdefault(c.kind, []).append(c.to_dict())
    return {
        "ok": all(c.ok for c in cases),
        "n_cases": len(cases),
        "kinds": by_kind,
    }


def layer2_to_dict(violations: list, n_files: int,
                   waivers: list) -> Dict[str, Any]:
    return {
        "ok": not violations,
        "n_files": n_files,
        "violations": [v.to_dict() for v in violations],
        "waivers": [w.to_dict() for w in waivers],
    }
