"""The port's repo-rule set: one AST visitor per codebase contract (port
of ``repro.verify.rules``).

Every rule here is demonstrated by a seeded violation in
``tests/_bad_torch_kernels.py`` (pinned by ``tests/test_torch_verify.py``),
and the clean run over the port's surface gates ``python -m
repro_torch.verify``.  Scoping lives *in* the rule -- each knows which part
of the port owns its contract -- so the runner can hand every rule every
file.

Carried over from the reference: ``no-densify``, ``plan-key-determinism``,
``counter-reset``, ``frozen-plan-immutability`` and ``dead-import``, each
scoped to the port's paths (``src/repro_torch/``, its ``core/`` and
``kernels/``).  The reference's ``pallas-static-shapes`` and
``no-traced-branch`` lint Pallas kernel bodies, which the port has none
of; in their place come three contracts of a PyTorch/CUDA port:
``no-reference-import``, ``no-tf32`` and ``no-plain-fallback``.
"""
from __future__ import annotations

import ast
from typing import List, Tuple

from .lint import rule

Findings = List[Tuple[int, str]]

#: the packages the port must run without: JAX and the reference
_REFERENCE_ROOTS = {"jax", "jaxlib", "repro"}


def _func_root(node: ast.AST):
    """Leftmost name of a (possibly dotted) call target, plus leaf attr."""
    leaf = None
    while isinstance(node, ast.Attribute):
        leaf = leaf or node.attr
        node = node.value
    if isinstance(node, ast.Name):
        return node.id, leaf or node.id
    return None, leaf


def _posix(path: str) -> str:
    return path.replace("\\", "/")


def _in_port(path: str) -> bool:
    return "src/repro_torch/" in _posix(path)


def _in_core(path: str) -> bool:
    return _in_port(path) and "/core/" in _posix(path)


def _in_kernels(path: str) -> bool:
    return _in_port(path) and "/kernels/" in _posix(path)


# ---------------------------------------------------------------------------
@rule("no-densify",
      "core/ execute paths must stay sparse: no to_dense()/todense() "
      "calls outside explicitly waived sites (the dense oracle)")
def no_densify(tree: ast.AST, src: str, path: str) -> Findings:
    if not _in_core(path):
        return []
    out: Findings = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in ("to_dense", "todense"):
            out.append((node.lineno,
                        f"densify call .{node.func.attr}() in core/"))
    return out


# ---------------------------------------------------------------------------
_NONDET_ROOTS = {"time", "random", "uuid", "datetime", "secrets"}
_NONDET_BUILTINS = {"hash", "id"}


@rule("plan-key-determinism",
      "plan keys and cache lookups must be deterministic functions of "
      "structure: no wall-clock, RNG, uuid, or PYTHONHASHSEED-dependent "
      "builtins anywhere in core/")
def plan_key_determinism(tree: ast.AST, src: str, path: str) -> Findings:
    if not _in_core(path):
        return []
    out: Findings = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        root, leaf = _func_root(node.func)
        if root in _NONDET_ROOTS:
            out.append((node.lineno,
                        f"nondeterministic source {root}.{leaf}() in core/"))
        elif isinstance(node.func, ast.Name) and \
                node.func.id in _NONDET_BUILTINS:
            out.append((node.lineno,
                        f"builtin {node.func.id}() is run-dependent "
                        "(PYTHONHASHSEED / address); use a content digest"))
        elif root in ("np", "numpy", "torch") and leaf is not None and \
                isinstance(node.func, ast.Attribute) and \
                isinstance(node.func.value, ast.Attribute) and \
                node.func.value.attr == "random":
            out.append((node.lineno, f"{root}.random.* in core/"))
    return out


# ---------------------------------------------------------------------------
@rule("counter-reset",
      "KERNEL_CALLS assertions must observe a well-defined window: any "
      "function reading kernel_call_counts() calls reset_kernel_calls() "
      "first (or snapshots a before-value ahead of the dispatch)")
def counter_reset(tree: ast.AST, src: str, path: str) -> Findings:
    out: Findings = []
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        reads: List[int] = []
        resets: List[int] = []
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                _, leaf = _func_root(node.func)
                if leaf == "kernel_call_counts":
                    reads.append(node.lineno)
                elif leaf == "reset_kernel_calls":
                    resets.append(node.lineno)
        if reads and not resets:
            out.append((min(reads),
                        f"{fn.name}() reads kernel_call_counts() without "
                        "reset_kernel_calls(): the counter window is "
                        "whatever ran before"))
        elif reads and resets and min(resets) > min(reads):
            # a pre-reset read is fine only as a before-snapshot that is
            # actually assigned; a bare expression read is a lost window
            first = min(reads)
            assigned = any(isinstance(node, ast.Assign)
                           and node.lineno == first
                           for node in ast.walk(fn))
            if not assigned:
                out.append((first,
                            f"{fn.name}() reads kernel_call_counts() "
                            "before reset_kernel_calls() without "
                            "snapshotting it"))
    return out


# ---------------------------------------------------------------------------
@rule("frozen-plan-immutability",
      "frozen plan dataclasses are never mutated after construction: "
      "object.__setattr__/setattr escape hatches may only touch "
      "underscore-prefixed memoization slots")
def frozen_plan_immutability(tree: ast.AST, src: str, path: str) -> Findings:
    if not _in_port(path):
        return []
    out: Findings = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        is_obj_setattr = (isinstance(node.func, ast.Attribute)
                          and node.func.attr == "__setattr__")
        is_setattr = (isinstance(node.func, ast.Name)
                      and node.func.id == "setattr")
        if not (is_obj_setattr or is_setattr):
            continue
        attr_arg = node.args[1] if len(node.args) > 1 else None
        if isinstance(attr_arg, ast.Constant) and \
                isinstance(attr_arg.value, str):
            if not attr_arg.value.startswith("_"):
                out.append((node.lineno,
                            f"setattr of public field "
                            f"{attr_arg.value!r} on a (frozen) object"))
        else:
            out.append((node.lineno,
                        "setattr with a computed attribute name defeats "
                        "the frozen-plan contract"))
    return out


# ---------------------------------------------------------------------------
@rule("dead-import",
      "module-level imports must be used (or re-exported); stale seed "
      "imports hide dead entry points")
def dead_import(tree: ast.AST, src: str, path: str) -> Findings:
    if _posix(path).endswith("__init__.py"):
        return []          # re-export surface: unused-at-module is the point
    imported: List[Tuple[int, str]] = []
    for node in tree.body if isinstance(tree, ast.Module) else []:
        stmts = [node]
        if isinstance(node, ast.Try):
            stmts = node.body + [s for h in node.handlers for s in h.body]
        if isinstance(node, ast.If):    # TYPE_CHECKING / platform guards
            stmts = node.body + node.orelse
        for stmt in stmts:
            if isinstance(stmt, ast.Import):
                for alias in stmt.names:
                    name = alias.asname or alias.name.split(".")[0]
                    imported.append((stmt.lineno, name))
            elif isinstance(stmt, ast.ImportFrom):
                if stmt.module == "__future__":
                    continue
                for alias in stmt.names:
                    if alias.name == "*":
                        continue
                    imported.append((stmt.lineno, alias.asname or alias.name))
    if not imported:
        return []
    used = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Attribute):
            root, _ = _func_root(node)
            if root:
                used.add(root)
    # names re-exported via __all__ strings count as used
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id == "__all__" and \
                        isinstance(node.value, (ast.List, ast.Tuple)):
                    for elt in node.value.elts:
                        if isinstance(elt, ast.Constant):
                            used.add(str(elt.value))
    return [(lineno, f"unused module-level import {name!r}")
            for lineno, name in imported if name not in used]


# ---------------------------------------------------------------------------
@rule("no-reference-import",
      "the port runs where neither JAX nor the reference package is "
      "installed: no import of jax, jaxlib or repro anywhere in "
      "src/repro_torch/ or chip_smoke.py (the tests compare the two "
      "packages and are exempt)")
def no_reference_import(tree: ast.AST, src: str, path: str) -> Findings:
    if not (_in_port(path) or _posix(path).endswith("chip_smoke.py")):
        return []
    out: Findings = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            if name.split(".")[0] in _REFERENCE_ROOTS:
                out.append((node.lineno, f"import of {name!r}: the port "
                            "imports neither JAX nor the reference"))
    return out


# ---------------------------------------------------------------------------
def _is_true(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and node.value is True


@rule("no-tf32",
      "float32 products stay float32: no allow_tf32 = True, no "
      "set_float32_matmul_precision() other than 'highest', no "
      "input_precision='tf32' under src/repro_torch/")
def no_tf32(tree: ast.AST, src: str, path: str) -> Findings:
    if not _in_port(path):
        return []
    out: Findings = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for tgt in targets:
                if isinstance(tgt, ast.Attribute) and \
                        tgt.attr == "allow_tf32" and _is_true(node.value):
                    out.append((node.lineno, "allow_tf32 = True rounds "
                                "float32 products to TF32"))
        elif isinstance(node, ast.Call):
            _, leaf = _func_root(node.func)
            if leaf == "set_float32_matmul_precision":
                arg = node.args[0] if node.args else None
                if not (isinstance(arg, ast.Constant)
                        and arg.value == "highest"):
                    out.append((node.lineno, "set_float32_matmul_precision"
                                " other than 'highest'"))
            for kw in node.keywords:
                if kw.arg == "input_precision" and \
                        isinstance(kw.value, ast.Constant) and \
                        str(kw.value.value).startswith("tf32"):
                    out.append((node.lineno,
                                f"input_precision={kw.value.value!r}"))
    return out


# ---------------------------------------------------------------------------
def _is_plain_module(root) -> bool:
    """``ref`` or an alias of it (``pb_ref``, ``bcsr_ref``, ...): the
    module of a kernel's plain versions."""
    return root is not None and (root == "ref" or root.endswith("_ref"))


@rule("no-plain-fallback",
      "a kernel that fails to build or launch raises: no except handler "
      "under src/repro_torch/kernels/ calls into the plain version "
      "(ref.*), which would hide the kernel behind its oracle")
def no_plain_fallback(tree: ast.AST, src: str, path: str) -> Findings:
    if not _in_kernels(path):
        return []
    out: Findings = []
    for handler in ast.walk(tree):
        if not isinstance(handler, ast.ExceptHandler):
            continue
        for stmt in handler.body:
            for node in ast.walk(stmt):
                if isinstance(node, ast.Call):
                    root, leaf = _func_root(node.func)
                    if isinstance(node.func, ast.Attribute) and \
                            _is_plain_module(root):
                        out.append((node.lineno,
                                    f"except handler falls back to the "
                                    f"plain version {root}.{leaf}()"))
    return out
