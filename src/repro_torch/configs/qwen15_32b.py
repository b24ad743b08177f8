"""qwen1.5-32b [dense]: QKV bias. 64L d_model=5120 40H (GQA kv=40 -> MHA)
d_ff=27392 vocab=152064. [hf:Qwen/Qwen1.5-0.5B; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40,
    d_ff=27_392, vocab_size=152_064,
    plan=(("attn", "swiglu"),),
    qkv_bias=True,
    source="[hf:Qwen/Qwen1.5-0.5B; hf]",
)
