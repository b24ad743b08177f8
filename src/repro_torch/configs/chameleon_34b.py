"""chameleon-34b [vlm]: early-fusion, VQ image tokens share the 65536 vocab
(frontend is a stub: input_specs provides token ids).  48L d_model=8192 64H
(GQA kv=8) d_ff=22016. [arXiv:2405.09818; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22_016, vocab_size=65_536,
    plan=(("attn", "swiglu"),),
    qk_norm=True,   # chameleon uses qk-norm for stability
    source="[arXiv:2405.09818; unverified]",
)
