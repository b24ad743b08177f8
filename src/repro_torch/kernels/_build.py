"""Build and load the hand-written CUDA kernels (plain C interface).

Each ``csrc/*.cu`` source is compiled with ``nvcc`` for ``sm_90a`` into a
shared library under ``build/torch_ext/`` at the root of the checkout,
named by a digest of the source, and loaded with ``ctypes``.  Nothing is
compiled at import, so the package imports on a machine without CUDA.
:func:`compile_sources` starts one ``nvcc`` per missing library, all at
once, so a caller that needs several libraries waits for the slowest only.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"

#: source path -> {"lib", "seconds", "path", "ptxas"}, once loaded
_LOADED: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _library_path(source: Path) -> Path:
    """Where the library of this source's current contents goes."""
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}_{digest}.so"


def compile_sources(sources) -> dict:
    """Compile every source whose library is not on disk yet, in parallel.

    Returns ``{source: seconds}`` (0 for a library already built); raises
    with the compiler's output if any ``nvcc`` fails.
    """
    t0 = time.perf_counter()
    jobs = []
    for src in sources:
        path = _library_path(src)
        if path.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), "-gencode=arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(tmp), str(src)]
        jobs.append((src, path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    seconds = {src: 0.0 for src in sources}
    failed = []
    for src, path, tmp, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src.name} "
                          f"({proc.returncode}):\n{out}")
            continue
        path.with_suffix(".log").write_text(out)
        os.replace(tmp, path)
        seconds[src] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def load(source: Path, functions: dict) -> dict:
    """Compile ``source`` if needed, load it and declare ``functions``
    (name -> ctypes argument types; every one returns a CUDA error code).

    Returns ``{"lib", "seconds", "path", "ptxas"}``: the build time (0 when
    the library was already on disk) and what ``ptxas -v`` said about
    registers, shared memory and spills.  Later calls return the first
    call's result.
    """
    hit = _LOADED.get(source)
    if hit is not None:
        return hit
    seconds = compile_sources([source])[source]
    path = _library_path(source)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in functions.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    log = path.with_suffix(".log")
    info = {"lib": lib, "seconds": seconds, "path": str(path),
            "ptxas": log.read_text() if log.exists() else ""}
    _LOADED[source] = info
    return info


def check_tensor(name, t, dtype, device) -> None:
    """Raise ``ValueError`` unless ``t`` is a contiguous ``dtype`` tensor
    on the CUDA device ``device`` (a ``torch.device`` with an index, or the
    index) -- what a kernel's plain C interface takes.  Compares device
    indices, not device objects: the check is part of every launch's host
    time."""
    index = device if isinstance(device, int) else device.index
    if t.get_device() != index or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: want a contiguous {dtype} tensor on "
                         f"cuda:{index}, got {t.dtype} on {t.device}")


def member_stride(name, t, dim: int, n: int) -> int:
    """Member stride of a batched kernel's argument: 0 when every member
    shares it (``dim`` dimensions, read in place), else its leading stride
    (``dim + 1`` dimensions, ``n`` members); raises ``ValueError``
    otherwise."""
    if t.dim() == dim:
        return 0
    if t.dim() == dim + 1 and t.shape[0] == n:
        return t.stride(0)
    raise ValueError(f"{name}: want {dim}-D (shared) or ({n}, ...) with "
                     f"{dim + 1} dimensions, got {tuple(t.shape)}")


def members_first(tensors, in_dims) -> list:
    """A vmap rule's array arguments for a batched wrapper: each batched
    tensor with its member axis moved to the front, each unbatched one as
    it is (member stride 0, never expanded into a copy per member, where
    the reference's ``custom_vmap`` rules broadcast)."""
    return [t if d is None else t.movedim(d, 0).contiguous()
            for t, d in zip(tensors, in_dims)]


def member_view(t, dim: int, e: int):
    """Member ``e``'s view of a batched kernel's argument that has ``dim``
    dimensions when shared (:func:`member_stride`)."""
    return t[e] if t.dim() > dim else t


def member_layout(names, tensors, dims, n: int):
    """A batched wrapper's arguments checked for ``n >= 1`` members:
    each one's member stride (:func:`member_stride`) and member 0's view
    of each (:func:`member_view`), the single-product shapes to check."""
    if n < 1:
        raise ValueError(f"n_members must be at least 1, got {n}")
    strides = [member_stride(name, t, dim, n)
               for name, t, dim in zip(names, tensors, dims)]
    return strides, [member_view(t, dim, 0) for t, dim in zip(tensors, dims)]


def member_expand(t, dim: int, n: int):
    """A batched plain version's argument with a leading member axis of
    ``n``: stacked as it is, shared (``dim`` dimensions) as a broadcast
    view, never a copy."""
    return t if t.dim() > dim else t.expand((n,) + tuple(t.shape))


def raise_on_errors(errors, what: str) -> None:
    """Read a hash kernel's ``errors`` count back and raise if it is not
    zero; ``what`` names the kernel."""
    n = int(errors)
    if n:
        raise RuntimeError(
            f"{what} kernel: {n} full-table probes or rows whose flushed "
            f"count disagrees with indptr_c (table sizes or indptr_c do not "
            f"fit these operands)")
