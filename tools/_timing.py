"""Timing helpers shared by the card tools in this directory.

Each tool runs as ``python3 tools/<name>.py``, so this module is found by
its plain name.  ``torch`` is passed in: the tools import it only after
checking their arguments.
"""
from __future__ import annotations

import subprocess
import time


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def event_times(torch, fn, reps: int, warm: int = 2) -> list:
    """CUDA-event times in ms of ``reps`` single calls of ``fn``, each
    ending in a synchronise, after ``warm`` calls; sorted."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return sorted(times)


def median_ms(torch, fn, reps: int, warm: int = 2) -> float:
    """The median of :func:`event_times`."""
    return event_times(torch, fn, reps, warm)[reps // 2]


def stream_ms(torch, fn, launches: int = 20, reps: int = 3):
    """(ms a call on the card, ms a call on the host): one CUDA event pair
    around ``launches`` back-to-back calls of ``fn`` with no synchronise
    between them, divided by ``launches`` (the host issues the next call
    while the card runs the last, so this is the card's time a call
    wherever that exceeds the host's), and the host's time to issue one
    call; medians of ``reps``."""
    fn()
    torch.cuda.synchronize()
    dev, host = [], []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        h0 = time.perf_counter()
        for _ in range(launches):
            fn()
        host.append((time.perf_counter() - h0) * 1e3 / launches)
        t1.record()
        t1.synchronize()
        dev.append(t0.elapsed_time(t1) / launches)
    return sorted(dev)[reps // 2], sorted(host)[reps // 2]
