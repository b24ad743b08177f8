"""Token sampling: greedy / temperature / top-k (port of
``repro.serve.sampling``).  Draws come from an explicit
``torch.Generator``: JAX's key bits cannot be matched."""
from __future__ import annotations

import torch


def sample_logits(gen: torch.Generator, logits, *, temperature: float = 1.0,
                  top_k: int = 0) -> torch.Tensor:
    """logits: (..., V) -> token ids (...,) int32. temperature <= 0 means
    greedy (the first largest logit)."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    lf = logits.float() / temperature
    if top_k:
        thresh = torch.topk(lf, top_k, dim=-1).values[..., -1:]
        lf = torch.where(lf < thresh, -1e30, lf)
    # Gumbel-max, as jax.random.categorical
    u = torch.rand(lf.shape, generator=gen, device=gen.device)
    g = -torch.log(-torch.log(u.to(lf.device)))
    return torch.argmax(lf + g, dim=-1).to(torch.int32)
