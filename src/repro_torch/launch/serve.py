"""Serving driver: batched generation with continuous batching (port of
``repro.launch.serve``).

Runs on ``cuda`` unless ``--device cpu`` is given; prefill attention goes
through the flash kernel's wrapper (``attn_impl="flash"``) and an SSD
layer's prefill through the SSD chunk kernel's wrapper: the CUDA kernels
on the card, their plain versions on the CPU.  Examples (CPU smoke; drop
``--smoke --device cpu`` on the card for full width):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --smoke --device cpu --requests 8 --max-new 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \\
      --smoke --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get, reduced
from repro_torch.core.formats import resolve_device
from repro_torch.models import transformer as T
from repro_torch.parallel.sharding import single_device_ctx
from repro_torch.serve import Engine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    pctx = single_device_ctx(attn_impl="flash")
    params = T.init_params(torch.Generator(device).manual_seed(0), cfg)
    eng = Engine(cfg, params, pctx, max_batch=args.max_batch,
                 max_len=args.max_len, device=device)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for r in range(args.requests):
        plen = int(rng.integers(4, 24))
        shape = (plen, cfg.n_codebooks) if cfg.n_codebooks else (plen,)
        eng.add_request(Request(
            rid=r, prompt=rng.integers(0, cfg.vocab_size,
                                       size=shape).astype(np.int32),
            max_new_tokens=args.max_new, temperature=args.temperature))
    done = eng.run_to_completion()
    dt = time.perf_counter() - t0
    n_tok = sum(len(d.out_tokens) for d in done)
    print(f"served {len(done)} requests, {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
