"""Model/shape configuration system.

Every assigned architecture is a :class:`ModelConfig`; every assigned input
shape is an :class:`InputShape`.  The dry-run grid is the cross product
(`launch/dryrun.py`).

Layer plans: a model is a cycled ``plan`` of (mixer, mlp) sub-layer pairs,
e.g. dense transformer = ``(("attn", "swiglu"),)``; recurrentgemma =
``(("rglru", "gated_mlp"), ("rglru", "gated_mlp"), ("attn_local",
"gated_mlp"))``; mamba2 = ``(("ssd", "none"),)``.  The layer stack is
``lax.scan``-ed over full plan periods (compile time stays O(period), not
O(n_layers)), with any remainder layers unrolled.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

Plan = Tuple[Tuple[str, str], ...]

MIXERS = ("attn", "attn_local", "ssd", "rglru")
MLPS = ("swiglu", "gated_mlp", "moe", "none")


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden size
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001   # load-balance loss (Switch-style)
    # C8 analogue: tokens within an expert need no stable order; an unstable
    # (faster) sort is used when False.
    stable_dispatch_sort: bool = False


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    plan: Plan = (("attn", "swiglu"),)
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_window: Optional[int] = None    # for attn_local mixers
    rnn_width: Optional[int] = None      # for rglru mixers
    n_codebooks: int = 0                 # musicgen-style codebook stack
    logit_softcap: Optional[float] = None
    dtype: str = "bfloat16"
    source: str = ""                     # provenance note [citation; tier]

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def period(self) -> int:
        return len(self.plan)

    @property
    def n_full_periods(self) -> int:
        return self.n_layers // self.period

    @property
    def tail_layers(self) -> Tuple[Tuple[str, str], ...]:
        r = self.n_layers % self.period
        return self.plan[:r]

    @property
    def sub_quadratic(self) -> bool:
        """True if no mixer needs O(S^2) prefill attention over full context."""
        return all(m in ("ssd", "rglru", "attn_local") for m, _ in self.plan)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + layers), for MODEL_FLOPS."""
        d, v = self.d_model, self.vocab_size
        n_embed = v * d * (self.n_codebooks or 1)
        if not self.tie_embeddings:
            n_embed += v * d * max(self.n_codebooks, 1)
        total = n_embed
        for li in range(self.n_layers):
            mixer, mlp = self.plan[li % self.period]
            total += d  # norm1
            if mixer in ("attn", "attn_local"):
                qkv = d * self.n_heads * self.hd + 2 * d * self.n_kv_heads * self.hd
                total += qkv + self.n_heads * self.hd * d
                if self.qkv_bias:
                    total += (self.n_heads + 2 * self.n_kv_heads) * self.hd
                if self.qk_norm:
                    total += 2 * self.hd
            elif mixer == "ssd":
                s = self.ssm
                d_in = s.expand * d
                nh = d_in // s.head_dim
                total += d * (2 * d_in + 2 * s.n_groups * s.d_state + nh)
                total += s.d_conv * (d_in + 2 * s.n_groups * s.d_state)
                total += 2 * nh + d_in  # A, D, norm
                total += d_in * d
            elif mixer == "rglru":
                w = self.rnn_width or d
                total += 2 * d * w + w * d          # in x2 (gate+rnn), out
                total += 4 * w + 2 * w * (w // 8)   # conv4 + lru gates (block-diag/8)
            if mlp != "none":
                total += d  # norm2
            if mlp in ("swiglu", "gated_mlp"):
                total += 3 * d * self.d_ff
            elif mlp == "moe":
                m = self.moe
                total += d * m.n_experts            # router
                total += m.n_experts * 3 * d * m.d_expert
        total += d  # final norm
        return total

    def active_param_count(self) -> int:
        """Activated parameters per token (MoE: top_k of n_experts)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        full = self.param_count()
        expert_all = 0
        expert_active = 0
        for li in range(self.n_layers):
            _, mlp = self.plan[li % self.period]
            if mlp == "moe":
                expert_all += m.n_experts * 3 * self.d_model * m.d_expert
                expert_active += m.top_k * 3 * self.d_model * m.d_expert
        return full - expert_all + expert_active


@dataclass(frozen=True)
class InputShape:
    name: str
    kind: str                    # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k":    InputShape("train_4k", "train", 4_096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k":  InputShape("decode_32k", "decode", 32_768, 128),
    "long_500k":   InputShape("long_500k", "decode", 524_288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    """Assignment rules: long_500k is required only for sub-quadratic archs
    (decode against a cache is O(S) even for full attention, so those cells
    still lower -- they are reported as `extra`); all other cells apply."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return True, "extra: full-attention arch; decode is O(S) so it " \
                     "lowers, but the cell is not required (see DESIGN.md)"
    return True, "required"
