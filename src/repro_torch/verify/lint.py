"""Layer 2: the AST repo-rule linter framework (port of
``repro.verify.lint``, the framework copied; :func:`default_paths` names
the port's surface).

Rules (:mod:`repro_torch.verify.rules`) are small ``ast`` visitors over
the port's own sources, each enforcing one codebase contract that runtime
tests can't see (a densify call that *would* be reachable, an import of
the reference package, a quiet fallback to a kernel's plain version).  A
rule is a callable ``rule(tree, src, path) -> list[(lineno, message)]``
registered with :func:`rule`; the runner handles file discovery, waiver
comments, and report assembly.

Waivers are per-line source comments::

    ad, bd = a.to_dense(), b.to_dense()  # verify: allow(no-densify)

A waiver on the flagged line (or on the ``def``/``class`` line of the
enclosing scope) suppresses the violation and is listed in the report,
so every exception stays visible and justified at the site.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

RuleFn = Callable[[ast.AST, str, str], List[Tuple[int, str]]]

_RULES: Dict[str, Tuple[str, RuleFn]] = {}

_WAIVER_RE = re.compile(r"#\s*verify:\s*allow\(([a-z0-9_,\- ]+)\)")


def rule(name: str, doc: str) -> Callable[[RuleFn], RuleFn]:
    """Register a named lint rule."""
    def deco(fn: RuleFn) -> RuleFn:
        _RULES[name] = (doc, fn)
        return fn
    return deco


def rule_names() -> List[str]:
    return sorted(_RULES)


def rule_doc(name: str) -> str:
    return _RULES[name][0]


@dataclasses.dataclass
class LintViolation:
    rule: str
    path: str
    line: int
    message: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclasses.dataclass
class Waiver:
    rule: str
    path: str
    line: int
    message: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _waived_lines(src: str) -> Dict[int, set]:
    """Line number -> set of rule names waived on that line."""
    out: Dict[int, set] = {}
    for i, text in enumerate(src.splitlines(), start=1):
        m = _WAIVER_RE.search(text)
        if m:
            out[i] = {r.strip() for r in m.group(1).split(",")}
    return out


def _scope_lines(tree: ast.AST) -> List[Tuple[int, int, int]]:
    """(def-line, body-start, body-end) per function/class scope, so a
    waiver on the ``def`` line covers the whole body."""
    spans = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            end = max((getattr(n, "end_lineno", node.lineno)
                       for n in ast.walk(node)), default=node.lineno)
            spans.append((node.lineno, node.lineno, end))
    return spans


def lint_source(src: str, path: str,
                rules: Optional[Sequence[str]] = None
                ) -> Tuple[List[LintViolation], List[Waiver]]:
    """Run the selected rules over one source string."""
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as exc:
        return [LintViolation("parse", path, exc.lineno or 0,
                              f"syntax error: {exc.msg}")], []
    waived = _waived_lines(src)
    scopes = _scope_lines(tree)
    violations: List[LintViolation] = []
    waivers: List[Waiver] = []
    for name in (rules or rule_names()):
        _, fn = _RULES[name]
        for lineno, message in fn(tree, src, path):
            rule_waived = name in waived.get(lineno, ())
            if not rule_waived:
                for def_line, lo, hi in scopes:
                    if lo <= lineno <= hi and name in waived.get(
                            def_line, ()):
                        rule_waived = True
                        break
            if rule_waived:
                waivers.append(Waiver(name, path, lineno, message))
            else:
                violations.append(LintViolation(name, path, lineno, message))
    return violations, waivers


def lint_paths(paths: Iterable[str],
               rules: Optional[Sequence[str]] = None
               ) -> Tuple[List[LintViolation], List[Waiver], int]:
    """Run rules over files; returns (violations, waivers, n_files)."""
    violations: List[LintViolation] = []
    waivers: List[Waiver] = []
    n = 0
    for p in paths:
        src = Path(p).read_text()
        n += 1
        v, w = lint_source(src, str(p), rules)
        violations += v
        waivers += w
    return violations, waivers, n


def _imports_port(path: Path) -> bool:
    """Does the module import ``repro_torch`` (anywhere in its body)?"""
    try:
        tree = ast.parse(path.read_text(), filename=str(path))
    except SyntaxError:
        return True          # let the runner report the parse error
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names = [node.module or ""]
        else:
            continue
        if any(n.split(".")[0] == "repro_torch" for n in names):
            return True
    return False


def default_paths(root: str = ".") -> List[str]:
    """The port's surface, which every rule is handed: ``src/repro_torch``
    in full, ``chip_smoke.py``, the port's tests (``tests/test_torch_*.py``)
    and the ``tools/*.py`` that import ``repro_torch``.  Seeded-violation
    fixtures (``_bad_*.py``) are excluded everywhere: they exist to be
    linted *explicitly* by ``tests/test_torch_verify.py``.
    """
    rootp = Path(root)
    found: List[Path] = []
    base = rootp / "src" / "repro_torch"
    if base.exists():
        found += sorted(base.rglob("*.py"))
    if (rootp / "chip_smoke.py").exists():
        found.append(rootp / "chip_smoke.py")
    found += sorted((rootp / "tests").glob("test_torch_*.py"))
    found += [p for p in sorted((rootp / "tools").glob("*.py"))
              if _imports_port(p)]
    return [str(p) for p in found if not p.name.startswith("_bad_")]


def run_layer2(root: str = ".",
               rules: Optional[Sequence[str]] = None
               ) -> Tuple[List[LintViolation], List[Waiver], int]:
    """Lint the port's surface; importing rules registers them."""
    from . import rules as _rules  # noqa: F401  (registration side effect)
    return lint_paths(default_paths(root), rules)
