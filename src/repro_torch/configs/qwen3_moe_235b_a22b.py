"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4) expert
d_ff=1536 vocab=151936, MoE 128 experts top-8, qk_norm, head_dim=128.
The paper-representative arch: token dispatch = SpGEMM (DESIGN.md section 5).
[hf:Qwen/Qwen3-30B-A3B; hf]"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
    d_ff=1536, vocab_size=151_936, head_dim=128,
    plan=(("attn", "moe"),),
    qk_norm=True, rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=128, top_k=8, d_expert=1536),
    source="[hf:Qwen/Qwen3-30B-A3B; hf]",
)
