"""Semirings for SpGEMM (port of ``repro.core.semiring``).

GraphBLAS semantics: ``mul`` combines *stored* entries only, ``add``
reduces the products per output coordinate, ``zero`` is the additive
identity given to padded lanes.  The output keeps the structural union
pattern: value-level cancellation removes no entry.

``reduce`` names the ``Tensor.scatter_reduce`` mode matching ``add``; the
sort-based accumulators (ESC and the hash fallback) reduce duplicate
coordinates with one segmented reduction.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch


@dataclass(frozen=True)
class Semiring:
    """An SpGEMM semiring ``(add, mul, zero)`` plus its segment reduction."""
    name: str
    add: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    mul: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    zero: float
    reduce: str

    def __repr__(self):
        return f"Semiring({self.name})"


def _ones_like_pair(x, y):
    # any_pair: the existence of a stored (a, b) pair contributes 1.
    return torch.ones_like(x * y)


def _first(x, y):
    # plus_first: keep the A-side value (B is a pattern).
    return x * torch.ones_like(y)


PLUS_TIMES = Semiring("plus_times", torch.add, torch.mul, 0.0, "sum")
BOOLEAN = Semiring("boolean", torch.maximum, _ones_like_pair, 0.0, "amax")
MIN_PLUS = Semiring("min_plus", torch.minimum, torch.add, float("inf"),
                    "amin")
PLUS_FIRST = Semiring("plus_first", torch.add, _first, 0.0, "sum")

SEMIRINGS = {
    "plus_times": PLUS_TIMES,
    "boolean": BOOLEAN,
    "any_pair": BOOLEAN,       # GraphBLAS alias
    "min_plus": MIN_PLUS,
    "plus_first": PLUS_FIRST,
}


def resolve_semiring(s: "str | Semiring") -> Semiring:
    """Accept a registry name or a :class:`Semiring` instance."""
    if isinstance(s, Semiring):
        return s
    try:
        return SEMIRINGS[s]
    except KeyError:
        raise ValueError(
            f"unknown semiring {s!r}; known: {sorted(SEMIRINGS)}") from None


def segment_reduce(sr: Semiring, vals: torch.Tensor, seg: torch.Tensor,
                   num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_{sum,max,min}`` for ``sr``: one value per segment,
    in input order; empty segments hold 0 (callers mask them).  Out of
    place, so it runs under ``torch.func.vmap`` over ``vals``."""
    out = torch.zeros(num_segments, dtype=vals.dtype, device=vals.device)
    if sr.reduce == "sum":
        return out.index_add(0, seg.long(), vals)
    return out.scatter_reduce(0, seg.long(), vals, sr.reduce,
                              include_self=False)
