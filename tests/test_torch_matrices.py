"""The port's Table 2 proxy suite (``repro_torch.data.matrices``) against
``repro.data.matrices``.

The profiles are the reference's.  Every proxy is bitwise the
reference's once the reference's seed offset -- ``hash(profile.name)``,
which ``PYTHONHASHSEED`` salts per process -- is shadowed by the port's
content digest (``matrices.name_digest``, the CRC-32 of the name); that
is the one difference.  Nothing in ``repro`` changes: the shadow is a
module attribute that pytest's ``monkeypatch`` removes again.  Two
processes with different hash seeds build the same port proxies.
"""
import hashlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.data import matrices as jmatrices
from repro_torch.data import matrices as tmatrices

ROOT = Path(__file__).resolve().parents[1]
#: the divisor the bitwise comparison runs at (every proxy, seconds)
SMALL = 4096


def test_profiles_match_reference():
    assert tmatrices.TABLE2 == jmatrices.TABLE2
    assert tmatrices.SCALE_DIVISOR == jmatrices.SCALE_DIVISOR
    tp, jp = tmatrices.profiles(), jmatrices.profiles()
    assert len(tp) == len(jp) == 26
    for t, j in zip(tp, jp):
        assert (t.name, t.n, t.nnz, t.flop, t.nnz_c) == \
            (j.name, j.n, j.nnz, j.flop, j.nnz_c)
        assert t.edge_factor == j.edge_factor
        assert t.compression_ratio == j.compression_ratio


def test_name_digest_is_crc32():
    import zlib
    for p in tmatrices.profiles():
        d = tmatrices.name_digest(p.name)
        assert d == zlib.crc32(p.name.encode()) % (1 << 16)
        assert 0 <= d < (1 << 16)


@pytest.mark.parametrize("seed", (0, 7))
@pytest.mark.parametrize("name", [row[0] for row in tmatrices.TABLE2])
def test_synth_proxy_bitwise_reference_under_the_digest(monkeypatch, name,
                                                        seed):
    monkeypatch.setattr(jmatrices, "hash",
                        lambda s: tmatrices.name_digest(s), raising=False)
    (profile,) = [p for p in tmatrices.profiles() if p.name == name]
    (jprofile,) = [p for p in jmatrices.profiles() if p.name == name]
    t = tmatrices.synth_proxy(profile, seed=seed, divisor=SMALL,
                              device="cpu")
    j = jmatrices.synth_proxy(jprofile, seed=seed, divisor=SMALL)
    assert t.shape == j.shape and t.cap == j.cap
    assert t.sorted_cols == j.sorted_cols
    for f in ("indptr", "indices", "data", "nnz"):
        x, y = np.asarray(getattr(j, f)), getattr(t, f).numpy()
        assert x.dtype == y.dtype and np.array_equal(x, y), f


def _suite_digest_in_process(hash_seed: str) -> str:
    code = (
        "import hashlib\n"
        "from repro_torch.data import matrices as M\n"
        "h = hashlib.sha256()\n"
        f"for p, a in M.suite(divisor={SMALL}, device='cpu'):\n"
        "    for t in (a.indptr, a.indices, a.data):\n"
        "        h.update(t.numpy().tobytes())\n"
        "print(h.hexdigest())\n")
    env = dict(os.environ, PYTHONHASHSEED=hash_seed,
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return out.stdout.strip()


def test_proxies_do_not_depend_on_the_hash_seed():
    first, second = (_suite_digest_in_process(s) for s in ("1", "2"))
    assert len(first) == 64 and first == second
    # and they are this process's proxies
    h = hashlib.sha256()
    for _, a in tmatrices.suite(divisor=SMALL, device="cpu"):
        for t in (a.indptr, a.indices, a.data):
            h.update(t.numpy().tobytes())
    assert h.hexdigest() == first


@pytest.mark.parametrize("divisor", (SMALL, tmatrices.SCALE_DIVISOR))
def test_suite_prefix_on_the_requested_device(divisor):
    got = list(tmatrices.suite(divisor=divisor, max_matrices=3,
                               device="cpu"))
    assert [p.name for p, _ in got] == \
        [row[0] for row in tmatrices.TABLE2[:3]]
    for p, a in got:
        assert a.shape == (max(64, p.n // divisor),) * 2
        for t in (a.indptr, a.indices, a.data, a.nnz):
            assert t.device == torch.device("cpu")
        assert a.data.dtype == torch.float32 and a.sorted_cols


def test_suite_defaults_to_the_card():
    """Like ``data/rmat.py``: with no device the proxies go to ``cuda``,
    which raises where there is none."""
    gen = tmatrices.suite(divisor=SMALL, max_matrices=1)
    if torch.cuda.is_available():
        _, a = next(gen)
        assert a.indptr.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            next(gen)
