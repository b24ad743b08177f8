"""The port's static contract checker (``repro_torch.verify``), turned on
itself and held against the reference's (``repro.verify``).

* **VC differential** -- for every layer-1 fixture (the reference's seeds
  and shapes, built from the same numpy arrays in one process) and a Gram
  plan, the port's ``check_plan_vcs`` on the port's plan equals the
  reference's on the reference's plan: the same names, verdicts and
  detail strings.
* **Perturbations** -- ``perturb_plan`` twins (capacity below nnz_c,
  halved hash tables, a PB product merging outside its bucket) are
  rejected while the untouched plan passes, and the reference rejects its
  own twins with the same VCs.
* **Census budgets** -- every layer-1 case meets its budget on CPU
  tensors; a seeded re-inspecting execute (the ESC symbolic phase, the
  hash symbolic kernel or a ``torch.sort`` inside ``execute``) fails it;
  the batched route counts its kernel once and none of the plain
  version's ops (the kernel boundary).
* **Layer 2** -- every port rule fires exactly on its ``# BAD:`` lines of
  ``tests/_bad_torch_kernels.py`` (linted under a pretend path in the
  port), waivers work on the line and on the ``def``, and the live port
  surface is clean.
* **CLI** -- ``python -m repro_torch.verify --all --device cpu --json``
  exits 0 with a schema-1 document; without a card and without
  ``--device cpu`` layer 1 raises.
"""
import dataclasses
import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import (plan_batch as j_plan_batch,
                        plan_bcsr as j_plan_bcsr,
                        plan_chain as j_plan_chain,
                        plan_gram as j_plan_gram, plan_pb as j_plan_pb,
                        plan_spgemm as j_plan_spgemm)
from repro.core.formats import BCSR as JBCSR
from repro.verify import bounds as jbounds
from repro.verify import check_plan_vcs as j_check_plan_vcs
import jax.numpy as jnp

import repro_torch.core as T
from repro_torch.core.plan import SpGEMMPlan
from repro_torch.core.spgemm import symbolic
from repro_torch.kernels.spgemm_hash import ops as hash_ops
from repro_torch.verify import (PLAN_PERTURBATIONS, check_plan_vcs,
                                perturb_plan, run_layer1, run_layer2,
                                verify_batch, verify_spgemm)
from repro_torch.verify import bounds as tbounds
from repro_torch.verify import census
from repro_torch.verify.lint import default_paths, lint_paths, lint_source

ROOT = pathlib.Path(__file__).resolve().parents[1]
BAD_PATH = ROOT / "tests" / "_bad_torch_kernels.py"
#: pretend location in the port: inside src/repro_torch, core/ and
#: kernels/, so every path-scoped rule is in scope for the fixture
FAKE_PATH = "src/repro_torch/core/kernels/_bad.py"
CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# the fixtures, built once per package from the same numpy arrays
# ---------------------------------------------------------------------------

def _dense(m, n, density, seed):
    return tbounds._dyadic_dense(m, n, density, seed)


def _pair_csr(d):
    return jbounds._csr_of(d), tbounds._csr_of(d, CPU)


def _pair_bcsr(gm, gn, bm, bn, density, seed, block):
    d = tbounds._block_dyadic(gm, gn, bm, bn, density, seed)
    return (JBCSR.from_dense(jnp.asarray(d), block),
            tbounds._bcsr_of(d, block, CPU))


def _operands():
    (ja, ta), (jb, tb) = (_pair_csr(_dense(16, 12, 0.3, 0)),
                          _pair_csr(_dense(12, 10, 0.35, 1)))
    return ja, jb, ta, tb


def _plans(case):
    """``(reference plan, port plan)`` of one layer-1 fixture."""
    ja, jb, ta, tb = _operands()
    kind, _, arg = case.partition(":")
    if kind == "spgemm":
        so = arg == "hash sorted"
        algo = "hash" if so else arg
        return (j_plan_spgemm(ja, jb, algorithm=algo, sorted_output=so),
                T.plan_spgemm(ta, tb, algorithm=algo, sorted_output=so))
    if kind == "batch":
        (j2, t2), (j3, t3), (j4, t4) = (
            _pair_csr(_dense(8, 12, 0.4, 2)), _pair_csr(_dense(5, 6, 0.5, 3)),
            _pair_csr(_dense(6, 7, 0.5, 4)))
        return (j_plan_batch([(ja, jb), (j2, jb), (j3, j4)]),
                T.plan_batch([(ta, tb), (t2, tb), (t3, t4)]))
    if kind == "bcsr":
        if arg == "square":
            (jx, tx), (jy, ty) = (_pair_bcsr(4, 3, 4, 4, 0.6, 8, (4, 4)),
                                  _pair_bcsr(3, 4, 4, 8, 0.6, 9, (4, 8)))
            return j_plan_bcsr(jx, jy), T.plan_bcsr(tx, ty)
        (jx, tx), (jy, ty) = (_pair_bcsr(5, 4, 2, 4, 0.5, 10, (2, 4)),
                              _pair_bcsr(4, 5, 4, 2, 0.5, 11, (4, 2)))
        return (j_plan_bcsr(jx, jy, n_bins=3),
                T.plan_bcsr(tx, ty, n_bins=3))
    if kind == "pb":
        if arg == "plain":
            return j_plan_pb(ja, jb), T.plan_pb(ta, tb)
        md = (_dense(16, 10, 0.5, 12) > 0).astype(np.float32)
        jm, tm = _pair_csr(md)
        return (j_plan_pb(ja, jb, mask=jm, n_buckets=4),
                T.plan_pb(ta, tb, mask=tm, n_buckets=4))
    if kind == "chain":
        jc, tc = _pair_csr(_dense(10, 7, 0.4, 7))
        return (j_plan_chain([ja, jb, jc], algorithm=arg),
                T.plan_chain([ta, tb, tc], algorithm=arg))
    assert kind == "gram", case
    return (j_plan_gram(ja, algorithm=arg), T.plan_gram(ta, algorithm=arg))


CASES = ["spgemm:hash", "spgemm:hash_vector", "spgemm:esc", "spgemm:heap",
         "spgemm:hash_jnp", "spgemm:hash sorted", "batch:", "bcsr:square",
         "bcsr:rect", "pb:plain", "pb:masked", "chain:hash", "chain:esc",
         "gram:hash", "gram:esc"]


def _triples(vcs):
    return [(vc.name, vc.ok, vc.detail) for vc in vcs]


def _flop_numbers(detail):
    """``(total flop, total x (n_bins - 1))`` of an ``i32-flop`` detail."""
    return (re.search(r"total_flop=(\d+)", detail).group(1),
            re.search(r"x\(n_bins-1\)=(\d+)", detail).group(1))


def _assert_same_vcs(got, want):
    """Names, verdicts and details bitwise; an ``i32-flop`` VC over bin
    targets states the port's rule (the total fits int32, the targets are
    int64) over the same two numbers as the reference's."""
    got, want = _triples(got), _triples(want)
    assert [t[:2] for t in got] == [t[:2] for t in want]
    for (name, _, detail), (_, _, ref_detail) in zip(got, want):
        if name.endswith("i32-flop") and "x(n_bins-1)" in ref_detail:
            assert detail.endswith("in int64")
            assert _flop_numbers(detail) == _flop_numbers(ref_detail)
        else:
            assert detail == ref_detail, name


@pytest.mark.parametrize("case", CASES)
def test_vcs_equal_the_references(case):
    jplan, tplan = _plans(case)
    want = j_check_plan_vcs(jplan)
    _assert_same_vcs(check_plan_vcs(tplan), want)
    assert want and all(vc.ok for vc in want)


def test_i32_flop_admits_the_ports_int64_bin_targets():
    """G500 s16 ef16's 400,330,394 flop at 8 bins: the reference's int32
    bin targets (x 7) would overflow, the port's int64 ones do not; a
    total past 2^31 - 1 fails both."""
    jplan, tplan = _plans("spgemm:hash")
    for total, port_ok, ref_ok in ((400_330_394, True, False),
                                   (2**31, False, False)):
        flop = tplan.flop.clone().long()
        flop[0] += total - int(flop.sum())
        t_bad = dataclasses.replace(tplan, flop=flop, total_flop=total)
        j_bad = dataclasses.replace(jplan, flop=jnp.asarray(flop.numpy()),
                                    total_flop=total)
        port = {vc.name: vc.ok for vc in check_plan_vcs(t_bad)}
        ref = {vc.name: vc.ok for vc in j_check_plan_vcs(j_bad)}
        assert port["i32-flop"] is port_ok and ref["i32-flop"] is ref_ok


# ---------------------------------------------------------------------------
# perturbations: broken twins rejected, the untouched plan still passes
# ---------------------------------------------------------------------------

def _perturbed(which):
    """The port plan a perturbation applies to: a hash plan for the
    capacity and table twins, the 4-bucket masked PB plan for ``seg``."""
    return _plans("pb:masked" if which == "seg" else "spgemm:hash")


@pytest.mark.parametrize("which", PLAN_PERTURBATIONS)
def test_perturbed_plan_rejected_untouched_passes(which):
    _, plan = _perturbed(which)
    assert all(vc.ok for vc in check_plan_vcs(plan))
    bad = perturb_plan(plan, which)
    failed = {vc.name for vc in check_plan_vcs(bad) if not vc.ok}
    assert failed, f"perturbation {which!r} was not rejected"
    want = {"cap_c": {"nnz-consistent", "store-capacity"},
            "bin_tsize": {"table-p2-range", "probe-termination",
                          "flush-bound"},
            "seg": {"bucket-disjoint"}}[which]
    assert failed & want, failed
    assert all(vc.ok for vc in check_plan_vcs(plan))


@pytest.mark.parametrize("which", ("cap_c", "bin_tsize"))
def test_perturbed_twins_fail_as_the_references_do(which):
    from _fuzz import perturb_plan as j_perturb_plan
    jplan, tplan = _plans("spgemm:hash")
    _assert_same_vcs(check_plan_vcs(perturb_plan(tplan, which)),
                     j_check_plan_vcs(j_perturb_plan(jplan, which)))


def test_seg_twin_of_one_bucket_leaves_the_segment_range():
    _, plan = _plans("pb:plain")
    assert plan.n_buckets == 1
    failed = {vc.name for vc in check_plan_vcs(perturb_plan(plan, "seg"))
              if not vc.ok}
    assert "segment-bounds" in failed


def test_perturbing_a_nested_pb_plan_rejects_the_csr_plan():
    _, _, ta, tb = _operands()
    plan = T.plan_spgemm(ta, tb, algorithm="pb")
    assert all(vc.ok for vc in check_plan_vcs(plan))
    failed = {vc.name for vc in check_plan_vcs(perturb_plan(plan, "seg"))
              if not vc.ok}
    assert failed and all(name.startswith("pb.") for name in failed)


def test_bcsr_capacity_twin_rejected():
    _, plan = _plans("bcsr:square")
    failed = {vc.name for vc in check_plan_vcs(perturb_plan(plan, "cap_c"))
              if not vc.ok}
    assert {"nnz-consistent", "store-capacity"} <= failed


def test_distributed_kinds_wait_for_their_planners():
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        run_layer1(["dist_1d"], device="cpu")
    with pytest.raises(TypeError, match="Queue 1 item 7"):
        check_plan_vcs(object())


# ---------------------------------------------------------------------------
# census budgets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", tbounds.KINDS)
def test_layer1_cases_meet_their_budgets_on_cpu(kind):
    cases = run_layer1([kind], device="cpu")
    assert cases
    for case in cases:
        assert case.ok, (case.name, [vc for vc in case.vcs if not vc.ok],
                         case.budget)
        assert not case.site_counts and not case.violations
        # on CPU tensors every kernel wrapper ran its plain version
        runs = sum(v for k, v in case.budget["launches"].items()
                   if k.endswith("plain"))
        assert runs == case.census["pallas_call"], case.name


def test_layer1_census_names_the_kernel_ops():
    by_name = {c.name: c for c in run_layer1(["spgemm", "pb", "chain"],
                                             device="cpu")}
    hash_case = by_name["spgemm/hash"]
    assert hash_case.census[tbounds.HASH_NUMERIC] == 1
    assert hash_case.census["sort"] == 0
    assert by_name["spgemm/hash sorted"].census["sort"] == tbounds.ROW_SORT
    assert by_name["spgemm/esc"].census["sort"] == tbounds.ESC_SORT
    pb_case = by_name["pb/planned"]
    assert pb_case.census[tbounds.PB_SCATTER] == 1
    assert pb_case.census[tbounds.PB_MERGE] == 1
    # the port-only chain: the sorted hop into pb pays one row sort
    hop = by_name["chain/hash,pb"]
    assert hop.budget["expected"]["sort"] == tbounds.ROW_SORT
    assert hop.census["pallas_call"] == 3


@dataclasses.dataclass(frozen=True)
class _Reinspecting(SpGEMMPlan):
    """A hash plan whose execute does more than its numeric kernel."""
    extra: str = "sort"

    def execute(self, a, b, sorted_output=None):
        if self.extra == "symbolic":
            symbolic(a, b)
        elif self.extra == "hash_symbolic":
            hash_ops.spgemm_hash_symbolic(
                a, b, table_size=self.table_size,
                schedule=(self.offsets, self.bin_tsize))
        else:
            torch.sort(a.indices)
        return super().execute(a, b, sorted_output)


@pytest.mark.parametrize("extra", ("symbolic", "hash_symbolic", "sort"))
def test_reinspecting_execute_fails_its_budget(extra):
    _, _, ta, tb = _operands()
    plan = T.plan_spgemm(ta, tb, algorithm="hash", cache=False)
    assert verify_spgemm(plan, ta, tb).ok
    fields = {f.name: getattr(plan, f.name)
              for f in dataclasses.fields(SpGEMMPlan)}
    bad = _Reinspecting(**fields, extra=extra)
    case = verify_spgemm(bad, ta, tb, name="spgemm/seeded-bad")
    assert all(vc.ok for vc in case.vcs)
    assert not case.ok
    got, want = case.budget["got"], case.budget["expected"]
    diff = {k for k in want if got[k] != want[k]}
    assert diff & {"sort", tbounds.HASH_SYMBOLIC, "pallas_call"}, diff


def test_batch_census_counts_the_kernel_not_the_plain_version():
    (_, tplan) = _plans("batch:")
    _, _, ta, tb = _operands()
    pairs = [(ta, tb),
             (tbounds._csr_of(_dense(8, 12, 0.4, 2), CPU), tb),
             (tbounds._csr_of(_dense(5, 6, 0.5, 3), CPU),
              tbounds._csr_of(_dense(6, 7, 0.5, 4), CPU))]
    case = verify_batch(tplan, pairs)
    assert case.ok, case.budget
    n_classes = tplan.n_classes
    assert case.census[tbounds.HASH_BATCHED] == n_classes
    assert case.census["pallas_call"] == n_classes
    assert case.census["sort"] == 0
    assert case.budget["launches"] == {
        "spgemm_hash.batched_plain": n_classes}


def test_without_the_kernel_boundary_the_plain_version_shows(monkeypatch):
    """What ``kernel_scope`` hides: the batched plain version stages
    sorts and bincounts, which the census would count as the
    executor's own on CPU tensors (and not on the card)."""
    import contextlib
    tplan = _plans("batch:")[1]
    _, _, ta, tb = _operands()
    pairs = [(ta, tb),
             (tbounds._csr_of(_dense(8, 12, 0.4, 2), CPU), tb),
             (tbounds._csr_of(_dense(5, 6, 0.5, 3), CPU),
              tbounds._csr_of(_dense(6, 7, 0.5, 4), CPU))]
    monkeypatch.setattr(hash_ops, "kernel_scope",
                        lambda name: contextlib.nullcontext())
    case = verify_batch(tplan, pairs)
    assert not case.ok
    assert case.census["sort"] > 0


def test_kernel_scope_counts_one_entry_and_hides_its_ops():
    x = torch.arange(5)
    with census.kernel_scope("outside"):      # no census: a no-op
        torch.sort(x)
    with census.Census() as c:
        torch.sort(x)
        with census.kernel_scope("inner"):
            torch.sort(x)
            with census.kernel_scope("nested"):
                torch.sort(x)
    summary = c.summary()
    assert summary["sort"] == 1
    assert summary["repro_torch::inner"] == 1
    assert "repro_torch::nested" not in summary
    assert summary["pallas_call"] == 1


# ---------------------------------------------------------------------------
# layer 2
# ---------------------------------------------------------------------------

def _seeded_lines():
    """rule name -> sorted ``# BAD:`` line numbers of the fixture."""
    marks = {}
    for lineno, text in enumerate(BAD_PATH.read_text().splitlines(), 1):
        m = re.search(r"#\s*BAD:\s*([a-z0-9-]+)", text)
        if m:
            marks.setdefault(m.group(1), []).append(lineno)
    return marks


def test_every_port_rule_has_a_seeded_violation():
    import repro_torch.verify.rules  # noqa: F401  (registers the rules)
    from repro_torch.verify.lint import rule_names
    assert set(_seeded_lines()) == set(rule_names())
    assert set(rule_names()) == {
        "no-densify", "plan-key-determinism", "counter-reset",
        "frozen-plan-immutability", "dead-import", "no-reference-import",
        "no-tf32", "no-plain-fallback"}


def test_seeded_violations_all_fire_on_their_lines():
    import repro_torch.verify.rules  # noqa: F401
    violations, waivers = lint_source(BAD_PATH.read_text(), FAKE_PATH)
    assert not waivers
    got = {}
    for v in violations:
        got.setdefault(v.rule, set()).add(v.line)
    for rule, lines in _seeded_lines().items():
        assert got.get(rule) == set(lines), \
            f"{rule}: fired on {sorted(got.get(rule, ()))}, seeded {lines}"
    marked = {ln for lines in _seeded_lines().values() for ln in lines}
    stray = {(v.rule, v.line) for v in violations if v.line not in marked}
    assert not stray, f"unseeded findings: {stray}"


def test_rules_keep_to_their_paths():
    import repro_torch.verify.rules  # noqa: F401
    src = BAD_PATH.read_text()
    # the reference's tree and the port's tests are out of the
    # path-scoped rules' reach
    for path, absent in (("src/repro/core/kernels/_bad.py",
                          {"no-densify", "no-reference-import", "no-tf32",
                           "no-plain-fallback",
                           "frozen-plan-immutability"}),
                         ("tests/test_torch_bad.py",
                          {"no-reference-import", "no-tf32",
                           "no-plain-fallback"})):
        fired = {v.rule for v in lint_source(src, path)[0]}
        assert not fired & absent, (path, fired & absent)
        assert {"dead-import", "counter-reset"} <= fired
    fired = {v.rule for v in lint_source(src, "chip_smoke.py")[0]}
    assert "no-reference-import" in fired and "no-tf32" not in fired


def test_waiver_comment_downgrades_to_reported_waiver():
    import repro_torch.verify.rules  # noqa: F401
    src = ("def f(c):\n"
           "    return c.to_dense()  # verify: allow(no-densify)\n")
    violations, waivers = lint_source(src, FAKE_PATH, ["no-densify"])
    assert not violations
    assert [w.rule for w in waivers] == ["no-densify"]

    # a waiver on the enclosing def line covers the whole body
    src = ("def f(c):  # verify: allow(no-plain-fallback)\n"
           "    try:\n"
           "        return c()\n"
           "    except RuntimeError:\n"
           "        return ref.numeric_plain(c)\n")
    violations, waivers = lint_source(src, FAKE_PATH, ["no-plain-fallback"])
    assert not violations and len(waivers) == 1

    # but a waiver for a *different* rule suppresses nothing
    src = ("def f(c):\n"
           "    return c.to_dense()  # verify: allow(counter-reset)\n")
    violations, _ = lint_source(src, FAKE_PATH, ["no-densify"])
    assert len(violations) == 1


def test_port_surface_is_lint_clean():
    violations, waivers, n_files = run_layer2(str(ROOT))
    assert n_files > 100
    assert violations == [], "\n".join(str(v) for v in violations)
    # every waiver is listed, and these are all of them: the dense
    # oracle, the version-keyed memo slot, the serving phases' deltas
    sites = {(pathlib.Path(w.path).relative_to(ROOT).as_posix(), w.rule)
             for w in waivers}
    assert sites == {("src/repro_torch/core/spgemm.py", "no-densify"),
                     ("src/repro_torch/core/formats.py",
                      "frozen-plan-immutability"),
                     ("chip_smoke.py", "counter-reset")}


def test_default_paths_are_the_ports_surface():
    paths = [pathlib.Path(p).relative_to(ROOT).as_posix()
             for p in default_paths(str(ROOT))]
    assert "chip_smoke.py" in paths
    assert "src/repro_torch/verify/rules.py" in paths
    assert "tests/test_torch_verify.py" in paths
    assert "tools/autotune_race.py" in paths
    assert not any(p.startswith("src/repro/") for p in paths)
    assert not any(pathlib.Path(p).name.startswith("_bad_") for p in paths)
    assert "tests/test_verify.py" not in paths


def test_verify_package_imports_no_reference():
    files = sorted((ROOT / "src" / "repro_torch" / "verify").glob("*.py"))
    assert len(files) == 7
    violations, waivers, n = lint_paths([str(p) for p in files],
                                        ["no-reference-import"])
    assert n == 7 and not violations and not waivers


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_all_on_cpu_writes_a_schema_1_report(tmp_path):
    out = tmp_path / "v.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.verify", "--all", "--device",
         "cpu", "--json", str(out)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    doc = json.loads(out.read_text())
    assert doc["schema"] == 1 and doc["ok"] is True
    assert doc["layer1"]["ok"] and doc["layer2"]["ok"]
    assert doc["layer2"]["n_files"] > 100
    assert doc["layer2"]["waivers"]
    case = doc["layer1"]["kinds"]["spgemm"][0]
    assert set(case) == {"kind", "name", "algorithm", "ok", "vcs", "sites",
                         "census", "budget", "violations", "warnings"}


def test_layer1_without_a_card_raises():
    from repro_torch.verify.__main__ import main
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--layer1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_layer1(["spgemm"])
