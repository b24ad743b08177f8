"""Batched-cache surgery for continuous batching (port of
``repro.serve.cache``: KV, SSM and RG-LRU caches)."""
from __future__ import annotations

from repro_torch.models.attention import KVCache
from repro_torch.models.rglru import RGLRUCache
from repro_torch.models.ssm import SSMCache


def insert_slot(batched: list, single: list, slot: int) -> list:
    """Write the batch-1 caches of a prefill into slot ``slot`` of the
    batched caches, in place (the reference returns new arrays).  A
    shorter sequence writes its KV prefix and leaves the rest as it is; an
    SSD or RG-LRU layer's whole conv window and state are written."""
    for big, small in zip(batched, single):
        if isinstance(big, KVCache) and isinstance(small, KVCache):
            s = small.k.shape[2]
            big.k[slot, :, :s] = small.k[0]
            big.v[slot, :, :s] = small.v[0]
        elif (isinstance(big, SSMCache) and isinstance(small, SSMCache)) or \
                (isinstance(big, RGLRUCache) and
                 isinstance(small, RGLRUCache)):
            big.conv[slot] = small.conv[0]
            big.h[slot] = small.h[0]
        else:
            raise NotImplementedError(
                f"insert_slot takes KVCache, SSMCache and RGLRUCache layers "
                f"of one type, got {type(big).__name__} and "
                f"{type(small).__name__}")
    return batched
