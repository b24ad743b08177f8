"""Deliberately broken code: one seeded violation per rule of the port's
layer-2 linter (``repro_torch.verify.rules``).

``tests/test_torch_verify.py`` lints this source under a *pretend* path in
the port (``src/repro_torch/core/kernels/_bad.py``) so every path-scoped
rule is in scope, and asserts each rule fires exactly on its ``# BAD:``
lines.  The file is excluded from both packages' lint surfaces (their
``default_paths`` skip ``_bad_*.py``) and is never imported -- it only
needs to parse.
"""
import os                                          # BAD: dead-import

import jax                                         # BAD: no-reference-import
import torch
from repro.core import CSR                         # BAD: no-reference-import
from . import ref


def densify_in_core(c):
    return c.to_dense() @ c.to_dense().T           # BAD: no-densify


def nondeterministic_plan_key(a):
    import time
    return (hash(a.indices.tobytes()),             # BAD: plan-key-determinism
            time.time())                           # BAD: plan-key-determinism


def unreset_counter_assert(run, kernel_call_counts):
    run()
    counts = kernel_call_counts()                  # BAD: counter-reset
    assert counts["numeric"] == 1


def mutate_frozen_plan(plan, cap):
    object.__setattr__(plan, "cap_c", cap)         # BAD: frozen-plan-immutability
    field = "nnz" + "_c"
    object.__setattr__(plan, field, cap)           # BAD: frozen-plan-immutability
    return plan


def reference_twin(a):
    return CSR.from_numpy(*a), jax.numpy.zeros(1)


def tf32_products(x):
    torch.backends.cuda.matmul.allow_tf32 = True   # BAD: no-tf32
    torch.set_float32_matmul_precision("high")     # BAD: no-tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return x @ x


def triton_dot(tl, a, b):
    return tl.dot(a, b, input_precision="tf32")    # BAD: no-tf32


def quiet_fallback(kernel, args):
    try:
        return kernel(*args)
    except RuntimeError:
        return ref.numeric_plain(*args)            # BAD: no-plain-fallback


def loud_failure(kernel, args):
    try:
        return kernel(*args)
    except RuntimeError as exc:
        raise RuntimeError("the kernel failed") from exc
