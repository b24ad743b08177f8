"""Batched-cache surgery for continuous batching (port of
``repro.serve.cache``, KV caches only: the SSM and RG-LRU caches come with
their mixers)."""
from __future__ import annotations

from repro_torch.models.attention import KVCache


def insert_slot(batched: list, single: list, slot: int) -> list:
    """Write the batch-1 caches of a prefill into slot ``slot`` of the
    batched caches, in place (the reference returns new arrays).  A
    shorter sequence writes its KV prefix and leaves the rest as it is."""
    for big, small in zip(batched, single):
        if not (isinstance(big, KVCache) and isinstance(small, KVCache)):
            raise NotImplementedError(
                f"insert_slot takes KVCache layers, got {type(big).__name__}")
        s = small.k.shape[2]
        big.k[slot, :, :s] = small.k[0]
        big.v[slot, :, :s] = small.v[0]
    return batched

