"""Static contract checker for the port's SpGEMM subsystems (port of
``repro.verify``; two layers).

Layer 1 (:mod:`repro_torch.verify.bounds`) checks every frozen plan's
verification conditions -- the reference's, by name and detail -- and runs
a repeat execute under a dispatch-level census
(:mod:`repro_torch.verify.census`): the aten and custom ops it issues must
equal the algorithm's budget (no symbolic kernel, no inspection, no
unbudgeted ``sort``, no densifying product) and, on the card, no kernel's
plain version may run.  The reference's interval proof over the execute's
jaxpr (``repro.verify.intervals``) has no counterpart: an eager execute
has no jaxpr, and the VCs and the census hold what it proved.

Layer 2 (:mod:`repro_torch.verify.lint` + :mod:`repro_torch.verify.rules`)
is an AST repo-rule linter over the port's surface (``src/repro_torch``,
``chip_smoke.py``, ``tests/test_torch_*.py`` and the port's tools):
no densify in core execute paths, deterministic plan keys, counter
hygiene, frozen-plan immutability, no dead imports, no import of JAX or
the reference, no TF32, no quiet fallback to a kernel's plain version.

Both layers run as ``python -m repro_torch.verify --all`` (on the card
unless ``--device cpu``) and are importable as test helpers -- see
``tests/test_torch_verify.py``.
"""
from .bounds import (check_plan_vcs, perturb_plan, PLAN_PERTURBATIONS,
                     verify_batch, verify_bcsr, verify_chain, verify_gram,
                     verify_pb, verify_spgemm, run_layer1)
from .census import Census, kernel_scope
from .lint import LintViolation, lint_paths, run_layer2
from .report import Report, layer1_to_dict, layer2_to_dict

__all__ = [
    "check_plan_vcs", "perturb_plan", "PLAN_PERTURBATIONS",
    "verify_spgemm", "verify_batch", "verify_bcsr", "verify_pb",
    "verify_chain", "verify_gram", "run_layer1",
    "Census", "kernel_scope",
    "LintViolation", "lint_paths", "run_layer2",
    "Report", "layer1_to_dict", "layer2_to_dict",
]
