"""Serving runtime: batched prefill/decode with continuous batching."""
from .engine import Engine, Request
from .sampling import sample_logits
