"""CLI: ``python -m repro_torch.verify [--all|--layer1|--layer2]
[--kinds K,...] [--rules R,...] [--root DIR] [--json PATH] [--list-rules]
[--device cpu|cuda]``.

Exit status is the contract: 0 when every case's VCs and census budget
hold and the lint surface is clean, 1 on any violation.  Layer 1 runs on
the card unless ``--device cpu`` is given; without a card it raises.
"""
from __future__ import annotations

import argparse
import sys

from . import lint
from .bounds import KINDS, run_layer1
from .lint import run_layer2
from .report import Report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.verify",
        description="static contract checker: plan VCs and execute "
                    "census budgets (layer 1) + repo-rule linter (layer 2)")
    ap.add_argument("--all", action="store_true",
                    help="run both layers (default if neither is chosen)")
    ap.add_argument("--layer1", action="store_true",
                    help="plan VCs and census budgets over every plan kind")
    ap.add_argument("--layer2", action="store_true",
                    help="AST repo-rule lint over the port's surface")
    ap.add_argument("--kinds", default=None,
                    help=f"comma list of layer-1 plan kinds "
                         f"({','.join(KINDS)})")
    ap.add_argument("--rules", default=None,
                    help="comma list of layer-2 rules (see --list-rules)")
    ap.add_argument("--root", default=".",
                    help="repo root for layer 2 (default: cwd)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the machine-readable report here")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the registered layer-2 rules and exit")
    ap.add_argument("--device", default=None, choices=("cpu", "cuda"),
                    help="layer 1's device (default: cuda, raising "
                         "without one)")
    args = ap.parse_args(argv)

    if args.list_rules:
        from . import rules as _rules  # noqa: F401
        for name in lint.rule_names():
            print(f"{name}: {lint.rule_doc(name)}")
        return 0

    do_l1 = args.all or args.layer1 or not (args.layer1 or args.layer2)
    do_l2 = args.all or args.layer2 or not (args.layer1 or args.layer2)
    report = Report()

    if do_l1:
        kinds = args.kinds.split(",") if args.kinds else None
        report.layer1 = run_layer1(kinds, device=args.device)
        for case in report.layer1:
            mark = "ok " if case.ok else "FAIL"
            bad_vcs = [vc.name for vc in case.vcs if not vc.ok]
            extra = f" vcs-failed={bad_vcs}" if bad_vcs else ""
            if not case.budget.get("ok"):
                extra += (f" budget expected={case.budget['expected']} "
                          f"got={case.budget['got']}")
            print(f"[{mark}] layer1 {case.name}: {len(case.vcs)} vcs, "
                  f"kernel ops {case.census['pallas_call']}, "
                  f"sort {case.census['sort']}{extra}")

    if do_l2:
        rules = args.rules.split(",") if args.rules else None
        violations, waivers, n_files = run_layer2(args.root, rules)
        report.layer2 = violations
        report.layer2_files = n_files
        report.layer2_waivers = waivers
        print(f"[{'ok ' if not violations else 'FAIL'}] layer2: "
              f"{n_files} files, {len(violations)} violations, "
              f"{len(waivers)} waived")
        for v in violations:
            print(f"       {v}")
        for w in waivers:
            print(f"       waived: {w.path}:{w.line}: [{w.rule}]")

    if args.json:
        report.to_json(args.json)
        print(f"report written to {args.json}")

    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
