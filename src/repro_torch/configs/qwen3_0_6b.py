"""qwen3-0.6b [dense]: 28L d_model=1024 16H (GQA kv=8) d_ff=3072
vocab=151936, qk_norm, head_dim=128 (per HF config). [hf:Qwen/Qwen3-8B; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=3072, vocab_size=151_936, head_dim=128,
    plan=(("attn", "swiglu"),),
    qk_norm=True, rope_theta=1_000_000.0, tie_embeddings=True,
    source="[hf:Qwen/Qwen3-8B; hf]",
)
