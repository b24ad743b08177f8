"""The port's attention entry points against ``repro.kernels.flash_attention``.

Same inputs in one process, made with numpy from a seed:
``flash_attention`` (on CPU tensors: the plain version behind the CUDA
kernel) against the reference's Pallas kernel run in interpret mode,
causal and not, ``Sq == Skv`` and ``Sq != Skv`` (both use the kernel's
mask: query i sees key j iff i >= j); ``attention_ref`` against its twin
(mask offset by ``Skv - Sq``); ``chunked_attention`` with and without a
sliding window against the reference's.  Tolerances: float32 within 2e-5
(the sums run in another order); bfloat16 inputs against the float32
reference within 2e-2, as ``tests/test_kernels.py`` holds the Pallas
kernel.  On CPU tensors the CUDA kernels are never launched.

The tensor-core kernel's P·V runs on bf16 operands; a plain-PyTorch
emulation of its rounding shows why it splits P into P_hi + P_lo: P rounded
once breaks the card's bf16 gate (one bf16 ulp of the plain output plus
2e-5), the split keeps it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jops
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ops, ref

F32_TOL, BF16_TOL = 2e-5, 2e-2


def qkv(seed, b, h, hkv, sq, skv, d):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((b, h, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))]


def err(got, want) -> float:
    return float(np.abs(got.float().numpy() - np.asarray(want)).max())


@pytest.mark.parametrize("sq,skv", [(128, 128), (64, 128)])
@pytest.mark.parametrize("h,hkv,d", [(4, 4, 32), (4, 2, 64), (8, 1, 32)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_pallas_interpret(causal, h, hkv, d, sq, skv):
    q, k, v = qkv(h * d + sq, 2, h, hkv, sq, skv, d)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, bq=64,
                                bkv=64, interpret=True)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal, bq=64,
                              bkv=64)
    assert got.dtype == torch.float32 and got.shape == (2, h, sq, d)
    assert err(got, want) < F32_TOL


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_against_f32_reference(causal):
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in qkv(3, 1, 2, 2, 64, 64, 32))
    want = jax_ref(*(jnp.asarray(t.float().numpy()) for t in (q, k, v)),
                   causal=causal)
    got = ops.flash_attention(q, k, v, causal=causal, bq=32, bkv=32)
    assert got.dtype == torch.bfloat16
    assert err(got, want) < BF16_TOL


@pytest.mark.parametrize("sq,skv", [(64, 64), (16, 64), (1, 48)])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_ref_matches_reference(causal, sq, skv):
    q, k, v = qkv(sq + skv, 2, 4, 2, sq, skv, 16)
    want = jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal)
    got = ref.attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal=causal)
    assert err(got, want) < F32_TOL


@pytest.mark.parametrize("sq,skv,window,bkv", [
    (64, 64, None, 32), (64, 64, 16, 16), (1, 128, None, 32),
    (32, 128, 24, 32), (96, 96, 40, 512)])
def test_chunked_attention_matches_reference(sq, skv, window, bkv):
    q, k, v = qkv(7 + sq, 2, 4, 2, sq, skv, 16)
    want = jops.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True,
                                  window=window, bkv=bkv)
    got = ops.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=True,
                                window=window, bkv=bkv)
    assert err(got, want) < F32_TOL


def test_chunked_attention_bf16_against_f32_reference():
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in qkv(5, 1, 4, 2, 64, 64, 32))
    want = jax_ref(*(jnp.asarray(t.float().numpy()) for t in (q, k, v)))
    got = ops.chunked_attention(q, k, v, bkv=16)
    assert got.dtype == torch.bfloat16 and err(got, want) < BF16_TOL


@pytest.mark.parametrize("sq,skv,kw", [
    (200, 200, {}), (128, 200, {}), (64, 64, {"bq": 48}),
    (64, 96, {"bkv": 64})])
def test_flash_indivisible_lengths_raise(sq, skv, kw):
    q, k, v = (torch.from_numpy(x) for x in qkv(0, 1, 2, 1, sq, skv, 16))
    with pytest.raises(ValueError, match="Sq % bq"):
        ops.flash_attention(q, k, v, **kw)


def test_chunked_indivisible_length_raises():
    q, k, v = (torch.from_numpy(x) for x in qkv(0, 1, 2, 1, 600, 600, 16))
    with pytest.raises(ValueError, match="Skv % bkv"):
        ops.chunked_attention(q, k, v)


def test_flash_short_ragged_prompt_runs():
    """Sq = 17 < 128: bq = bkv = 17, the kernel masks its own tile edge."""
    q, k, v = qkv(17, 1, 4, 2, 17, 17, 16)
    want = jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    assert err(got, want) < F32_TOL


def test_wrapper_rejects_mismatched_operands():
    q, k, v = (torch.from_numpy(x) for x in qkv(0, 1, 3, 2, 8, 8, 16))
    with pytest.raises(ValueError, match="multiple of n_kv_heads"):
        K.flash_fwd(q, k, v, scale=0.25, causal=True)
    q, k, v = (torch.from_numpy(x) for x in qkv(0, 1, 4, 2, 8, 8, 16))
    with pytest.raises(ValueError, match="alike"):
        K.flash_fwd(q, k, v[..., :8], scale=0.25, causal=True)


def test_cpu_tensors_count_plain_launches():
    q, k, v = (torch.from_numpy(x) for x in qkv(1, 1, 4, 2, 32, 32, 16))
    ops.reset_kernel_calls()
    ops.flash_attention(q, k, v)
    ops.flash_attention(q, k, v, causal=False)
    assert ops.kernel_call_counts() == {"flash_fwd": 0, "plain": 2}
    assert ops.variant_call_counts() == {"wgmma": 0, "fma": 0}
    ops.reset_kernel_calls()
    ops.chunked_attention(q, k, v)
    ref.attention_ref(q, k, v)
    assert ops.kernel_call_counts() == {"flash_fwd": 0, "plain": 0}


@pytest.mark.parametrize("dtype,d,kind", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 256, "wgmma"), (torch.bfloat16, 16, "fma"),
    (torch.bfloat16, 32, "fma"), (torch.float32, 128, "fma")])
def test_kernel_variant_by_dtype_and_head_dim(dtype, d, kind):
    """The rule ``flash_fwd`` launches by: bf16 at 64, 128 and 256 on the
    tensor cores, float32 and bf16 at 16 and 32 on the CUDA cores."""
    assert K.variant(dtype, d) == kind


def bf16_ulp(x):
    """One bfloat16 ulp at each value of ``x``."""
    _, e = x.float().abs().frexp()
    return (e.float() - 8).exp2()


def tensor_core_emulation(q, k, v, *, scale, split):
    """The tensor-core kernel's arithmetic in plain PyTorch, causal: exact
    float32 scores of bf16 q, k; P = exp(s - max) and l in float32; P·V
    with P rounded to bf16 (``split``: plus the rounding's remainder,
    itself rounded to bf16) against bf16 V, summed in float32."""
    sq, skv = q.shape[2], k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    keep = torch.arange(sq)[:, None] >= torch.arange(skv)[None, :]
    s = s.masked_fill(~keep, ref.NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    hi = p.bfloat16().float()
    acc = torch.einsum("bhqk,bhkd->bhqd", hi, v.float())
    if split:
        lo = (p - hi).bfloat16().float()
        acc = acc + torch.einsum("bhqk,bhkd->bhqd", lo, v.float())
    return (acc / l.clamp_min(1e-30)).bfloat16()


def test_split_p_keeps_the_bf16_gate():
    """Outputs are sums that cancel, so P's rounding error, relative to the
    terms, is large against one ulp of the result: rounding P once puts
    about a tenth of the outputs past the gate, the split none."""
    q, k, v = (torch.from_numpy(x).bfloat16()
               for x in qkv(0, 1, 2, 2, 256, 256, 64))
    want = ref.flash_attention_plain(q, k, v, causal=True, scale=0.125)
    past = {}
    for split in (False, True):
        got = tensor_core_emulation(q, k, v, scale=0.125, split=split)
        d = (got.float() - want.float()).abs()
        past[split] = int((d > bf16_ulp(want) + F32_TOL).sum())
    assert past[False] > want.numel() // 20
    assert past[True] == 0

