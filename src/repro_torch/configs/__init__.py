"""Architecture registry: the 10 assigned archs + reduced smoke variants.

A copy of ``repro.configs`` (pure dataclasses, no framework), kept
identical so that ``ModelConfig.param_count()`` and :func:`reduced` agree
with the reference.
"""
from __future__ import annotations

import dataclasses

from .base import (ModelConfig, MoEConfig, SSMConfig, InputShape, SHAPES,
                   shape_applicable, Plan)

from . import (musicgen_medium, qwen3_0_6b, granite_8b, qwen15_32b,
               phi4_mini_3_8b, qwen3_moe_235b_a22b, qwen3_moe_30b_a3b,
               mamba2_780m, recurrentgemma_9b, chameleon_34b)

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (musicgen_medium, qwen3_0_6b, granite_8b, qwen15_32b,
              phi4_mini_3_8b, qwen3_moe_235b_a22b, qwen3_moe_30b_a3b,
              mamba2_780m, recurrentgemma_9b, chameleon_34b)
}

#: aliases used by --arch
ALIASES = {
    "musicgen-medium": "musicgen-medium",
    "qwen3-0.6b": "qwen3-0.6b",
    "granite-8b": "granite-8b",
    "qwen1.5-32b": "qwen1.5-32b",
    "phi4-mini-3.8b": "phi4-mini-3.8b",
    "qwen3-moe-235b-a22b": "qwen3-moe-235b-a22b",
    "qwen3-moe-30b-a3b": "qwen3-moe-30b-a3b",
    "mamba2-780m": "mamba2-780m",
    "recurrentgemma-9b": "recurrentgemma-9b",
    "chameleon-34b": "chameleon-34b",
}


def get(name: str) -> ModelConfig:
    return ARCHS[ALIASES.get(name, name)]


def reduced(cfg: ModelConfig, *, n_layers: int | None = None,
            d_model: int = 64, vocab: int = 128) -> ModelConfig:
    """Smoke-test shrink of an arch: same family/plan/options, tiny dims.

    Keeps every structural feature (GQA ratio, qk_norm, bias, MoE top-k,
    SSD state, plan period) so the smoke test exercises the same code paths
    as the full config.
    """
    ratio = max(1, cfg.n_heads // max(cfg.n_kv_heads, 1))
    n_heads = max(2 * ratio, 2)
    n_kv = max(n_heads // ratio, 1)
    hd = max(16, d_model // n_heads)
    if n_layers is None:
        n_layers = cfg.period + min(2, cfg.n_layers % cfg.period or 0) \
            + cfg.period  # two periods + same-shape tail if any
        if cfg.n_layers % cfg.period:
            n_layers = 2 * cfg.period + (cfg.n_layers % cfg.period)
    moe = None
    if cfg.moe is not None:
        # capacity_factor=4 so smoke tests drop no tokens (capacity MoE is
        # only prefill/decode-consistent when nothing is dropped).
        moe = dataclasses.replace(cfg.moe, n_experts=8,
                                  top_k=min(cfg.moe.top_k, 2),
                                  d_expert=max(32, d_model // 2),
                                  capacity_factor=4.0)
    ssm = None
    if cfg.ssm is not None:
        ssm = dataclasses.replace(cfg.ssm, d_state=16, head_dim=16, chunk=16)
    return dataclasses.replace(
        cfg, name=cfg.name + "-smoke",
        n_layers=n_layers, d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv,
        head_dim=hd, d_ff=(0 if cfg.d_ff == 0 else max(64, 2 * d_model)),
        vocab_size=vocab, moe=moe, ssm=ssm,
        attn_window=(64 if cfg.attn_window else None),
        rnn_width=(d_model if cfg.rnn_width else None),
        dtype="float32")


__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "InputShape", "SHAPES",
           "shape_applicable", "Plan", "ARCHS", "ALIASES", "get", "reduced"]
