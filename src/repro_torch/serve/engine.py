"""Continuous-batching serving engine (port of ``repro.serve.engine``).

One decode step serves every active slot; newly-arrived requests are
prefilled (batch 1) and inserted into free slots between decode steps --
the vLLM-style iteration-level schedule.  ``_prefill`` and ``_decode`` are
the engine's two model calls (the reference's two compiled artifacts); the
port runs them eagerly.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.formats import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.parallel.sharding import ParallelCtx
from . import cache as cache_lib
from .sampling import sample_logits


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (S,) or (S, ncb)
    max_new_tokens: int = 32
    temperature: float = 0.0
    out_tokens: list = field(default_factory=list)
    done: bool = False


class Engine:
    """Serves ``params`` (a :class:`~repro_torch.models.transformer.
    Transformer` on ``device``, ``cuda`` unless named) with ``max_batch``
    cache slots of ``max_len`` positions each (an SSD or RG-LRU layer's
    slot is its conv window and state, whatever the length)."""

    def __init__(self, cfg, params, pctx: ParallelCtx, *, max_batch: int = 4,
                 max_len: int = 512, seed: int = 0, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        where = {p.device for p in params.parameters()}
        if where != {self.device}:
            raise ValueError(f"params on {where}, engine on {self.device}")
        self.cfg, self.params, self.pctx = cfg, params, pctx
        self.max_batch, self.max_len = max_batch, max_len
        self.caches = T.init_caches(cfg, max_batch, max_len, L.cdtype(cfg),
                                    self.device)
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.pos = np.zeros(max_batch, np.int32)      # next write position
        self.queue: List[Request] = []
        self.gen = torch.Generator(self.device).manual_seed(seed)
        self._decode = lambda p, tok, caches, pos: T.decode_step(
            p, tok, caches, pos, cfg, pctx)
        self._prefill = lambda p, tok: T.prefill(p, tok, cfg, pctx)

    # -- public -------------------------------------------------------------
    def add_request(self, req: Request):
        self.queue.append(req)

    def active(self) -> int:
        return sum(s is not None for s in self.slots)

    def step(self):
        """Admit (at most one prefill per free slot) + one decode for all
        active slots."""
        self._admit()
        if self.active() == 0:
            return []
        finished = []
        tokens = np.zeros((self.max_batch, 1) +
                          ((self.cfg.n_codebooks,) if self.cfg.n_codebooks
                           else ()), np.int64)
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            tokens[i, 0] = req.out_tokens[-1] if req.out_tokens else \
                np.asarray(req.prompt[-1])
        # per-slot positions: attention masks/rope use pos[b] (vector pos).
        # Idle slots decode too, as the reference's; nothing that writes is
        # read: KV entries past a slot's position are masked, and the next
        # insert_slot overwrites an SSD or RG-LRU layer's whole conv window
        # and state.  An idle slot's token also competes for MoE expert
        # capacity, as in the reference.
        logits, self.caches = self._decode(
            self.params, torch.from_numpy(tokens).to(self.device),
            self.caches, torch.from_numpy(self.pos).to(self.device))
        temps = [r.temperature if r else 0.0 for r in self.slots]
        toks = sample_logits(self.gen, logits[:, 0],
                             temperature=max(temps) if any(
                                 t > 0 for t in temps) else 0.0).cpu().numpy()
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            req.out_tokens.append(toks[i])
            self.pos[i] += 1
            if len(req.out_tokens) >= req.max_new_tokens or \
                    self.pos[i] >= self.max_len - 1:
                req.done = True
                finished.append(req)
                self.slots[i] = None
        return finished

    def run_to_completion(self, max_steps: int = 10_000):
        out = []
        steps = 0
        while (self.queue or self.active()) and steps < max_steps:
            out.extend(self.step())
            steps += 1
        return out

    # -- internals ------------------------------------------------------------
    def _admit(self):
        for i in range(self.max_batch):
            if self.slots[i] is None and self.queue:
                req = self.queue.pop(0)
                prompt = torch.from_numpy(
                    np.asarray(req.prompt, np.int64))[None].to(self.device)
                logits, caches1 = self._prefill(self.params, prompt)
                self.caches = cache_lib.insert_slot(self.caches, caches1, i)
                tok = sample_logits(self.gen, logits[:, 0],
                                    temperature=req.temperature)
                req.out_tokens.append(tok.cpu().numpy()[0])
                self.slots[i] = req
                self.pos[i] = prompt.shape[1]
