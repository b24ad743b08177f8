"""recurrentgemma-9b [hybrid]: RG-LRU + local attention, 1:2 pattern.
38L d_model=4096 16H (GQA kv=1 -> MQA) d_ff=12288 vocab=256000, head_dim=256,
window=2048, rnn_width=4096.  38 = 12 full (rec, rec, attn) periods + 2
tail rec layers.  [arXiv:2402.19427; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12_288, vocab_size=256_000, head_dim=256,
    plan=(("rglru", "gated_mlp"), ("rglru", "gated_mlp"),
          ("attn_local", "gated_mlp")),
    attn_window=2048, rnn_width=4096, tie_embeddings=True,
    source="[arXiv:2402.19427; unverified]",
)
