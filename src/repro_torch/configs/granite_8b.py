"""granite-8b [dense]: llama-arch code model. 36L d_model=4096 32H (GQA kv=8)
d_ff=14336 vocab=49152. [arXiv:2405.04324; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14_336, vocab_size=49_152,
    plan=(("attn", "swiglu"),),
    rope_theta=10_000_000.0,
    source="[arXiv:2405.04324; hf]",
)
