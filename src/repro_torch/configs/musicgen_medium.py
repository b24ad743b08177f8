"""musicgen-medium [audio]: decoder-only over EnCodec tokens.

48L d_model=1536 24H (GQA kv=24 -> MHA) d_ff=6144 vocab=2048, 4 codebooks
with summed codebook embeddings + 4 output heads (delay-pattern frontend is
a stub per the assignment). [arXiv:2306.05284; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab_size=2048, head_dim=64,
    plan=(("attn", "swiglu"),),
    n_codebooks=4,
    source="[arXiv:2306.05284; hf]",
)
