"""mamba2-780m [ssm]: SSD (state-space duality), attention-free.
48L d_model=1536 d_ff=0 vocab=50280, ssm_state=128.
[arXiv:2405.21060; unverified]"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=48, n_kv_heads=48,  # SSD heads (d_inner/head_dim)
    d_ff=0, vocab_size=50_280,
    plan=(("ssd", "none"),),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk=256),
    tie_embeddings=True,
    source="[arXiv:2405.21060; unverified]",
)
