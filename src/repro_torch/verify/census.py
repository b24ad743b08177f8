"""Layer 1's census: the ops one execute dispatches, counted at the
dispatcher.

The reference traces a planned execute to a jaxpr and counts its
primitives (``repro.verify.bounds._analyze_traced``).  An eager PyTorch
execute has no jaxpr, so :class:`Census` counts what reaches the
dispatcher instead: a ``TorchDispatchMode`` sees every aten op and every
custom op (``repro_torch::*``) the execute issues, by overload packet,
and the window also takes the delta of every kernel family's launch
counters (``KERNEL_CALLS``).

**The kernel boundary.**  A kernel's insides never count as the execute's
own ops.  A custom op hides them already: the mode sees the op once and
its body (the CUDA launch, or the plain version on CPU tensors) runs
below the mode.  A wrapper that an executor calls directly, not through a
custom op (``kernels.spgemm_hash.ops.spgemm_hash_batched``, which
``core.batch`` calls), enters :func:`kernel_scope` instead: the census
counts it as one ``repro_torch::<name>`` entry and skips every op inside.
So a fixture's census is the same on CPU tensors and on the card.

The reference's census keys map onto torch ops (:data:`FAMILIES`);
``pallas_call`` counts the kernel ops and entries.  Host reads
(``aten._local_scalar_dense``, an ``int()`` of a device tensor) are
reported as ``host_read`` and gate nothing.
"""
from __future__ import annotations

import collections
import contextlib
from typing import Dict

from torch.utils._python_dispatch import TorchDispatchMode

#: prefix of the kernel ops and kernel-wrapper entries
KERNEL_PREFIX = "repro_torch::"

#: reference census key -> the aten overload packets it counts
FAMILIES: Dict[str, tuple] = {
    "sort": ("aten::sort", "aten::argsort", "aten::msort"),
    "dot_general": ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm",
                    "aten::_sparse_mm", "aten::matmul", "aten::dot",
                    "aten::mv"),
    "unique": ("aten::_unique", "aten::_unique2", "aten::unique_dim",
               "aten::unique_consecutive"),
    "nonzero": ("aten::nonzero", "aten::nonzero_static"),
    "argwhere": ("aten::argwhere",),
    "scatter": ("aten::index_put_", "aten::index_put", "aten::scatter",
                "aten::scatter_", "aten::scatter_add", "aten::scatter_add_",
                "aten::scatter_reduce", "aten::scatter_reduce_",
                "aten::index_add", "aten::index_add_"),
    "gather": ("aten::index", "aten::gather", "aten::index_select"),
    "cumsum": ("aten::cumsum", "aten::cumsum_"),
    "host_read": ("aten::_local_scalar_dense",),
}
_FAMILY_OF = {op: fam for fam, ops in FAMILIES.items() for op in ops}

#: kernel family -> module of its launch counters
COUNTER_MODULES = {
    "spgemm_hash": "repro_torch.kernels.spgemm_hash.kernel",
    "spgemm_pb": "repro_torch.kernels.spgemm_pb.kernel",
    "spgemm_bcsr": "repro_torch.kernels.spgemm_bcsr.kernel",
    "spmm": "repro_torch.kernels.spmm.kernel",
    "flash_attention": "repro_torch.kernels.flash_attention.kernel",
    "ssd_chunk": "repro_torch.kernels.ssd_chunk.kernel",
}
#: launch counters that count runs of a plain version, not of a kernel
PLAIN_COUNTERS = ("plain", "batched_plain")

#: censuses in progress, innermost last (read by :func:`kernel_scope`)
_ACTIVE: list = []


def _counters() -> Dict[str, dict]:
    import importlib
    return {fam: importlib.import_module(mod).KERNEL_CALLS
            for fam, mod in COUNTER_MODULES.items()}


def _op_name(func) -> str:
    """``namespace::name`` of an op overload's packet."""
    packet = str(func.overloadpacket)
    ns, _, name = packet.partition(".")
    return f"{ns}::{name}"


class Census(TorchDispatchMode):
    """Count the ops dispatched inside the ``with`` block.

    After the block: :attr:`ops` (every op by ``namespace::name``),
    :attr:`launches` (``family.counter`` -> delta of the kernel launch
    counters, nonzero only) and :meth:`summary` (the report's census).
    """

    def __init__(self):
        super().__init__()
        self.ops: collections.Counter = collections.Counter()
        self.launches: Dict[str, int] = {}
        self._depth = 0
        self._before: Dict[str, dict] = {}

    def __enter__(self):
        self._before = {fam: dict(c) for fam, c in _counters().items()}
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        _ACTIVE.remove(self)
        self.launches = {
            f"{fam}.{k}": v - self._before[fam].get(k, 0)
            for fam, c in _counters().items() for k, v in c.items()
            if v != self._before[fam].get(k, 0)}
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self._depth:
            self.ops[_op_name(func)] += 1
        return func(*args, **(kwargs or {}))

    def enter_kernel(self, name: str) -> None:
        if not self._depth:
            self.ops[KERNEL_PREFIX + name] += 1
        self._depth += 1

    def exit_kernel(self) -> None:
        self._depth -= 1

    def summary(self) -> Dict[str, int]:
        """The report's census: every :data:`FAMILIES` key, ``pallas_call``
        (kernel ops and entries together) and each kernel op or entry by
        name; sorted keys."""
        out = {fam: 0 for fam in FAMILIES}
        out["pallas_call"] = 0
        for op, n in self.ops.items():
            if op.startswith(KERNEL_PREFIX):
                out["pallas_call"] += n
                out[op] = n
            elif op in _FAMILY_OF:
                out[_FAMILY_OF[op]] += n
        return dict(sorted(out.items()))

    def plain_runs(self) -> int:
        """Runs of any kernel's plain version in the window."""
        return sum(v for k, v in self.launches.items()
                   if k.rsplit(".", 1)[1] in PLAIN_COUNTERS)


@contextlib.contextmanager
def kernel_scope(name: str):
    """Mark a kernel wrapper's call as one kernel entry
    (``repro_torch::<name>``) of the census in progress, and hide the ops
    inside it; passes straight through when no census is running."""
    if not _ACTIVE:
        yield
        return
    census = _ACTIVE[-1]
    census.enter_kernel(name)
    try:
        yield
    finally:
        census.exit_kernel()
