"""Shared measured-time harness: warmup + median-of-k wall-clock (a port
of ``benchmarks/timing.py``).

Every figure that reports a measured number routes it through
:func:`device_time_s`, so ``python -m repro_torch.bench.run --time`` can
emit a uniform ``measured_s`` entry (seconds, the median of k runs after
the warm-up ones) next to the modeled numbers of each
``BENCH_<figure>.json``.  On the card the device is synchronized before
and after each run and the host clock reads the time between, as JAX's
``block_until_ready`` does; on the CPU each run is timed with
``perf_counter`` alone.  A figure whose measured work is host code only
(the simulator, the planner) passes no device.
"""
from __future__ import annotations

import statistics
import time
from typing import Callable

import torch

#: --time defaults: enough warmup to exclude first-touch and builds, odd
#: k so the median is an actual sample.
WARMUP = 2
REPEATS = 5


def sync(device) -> None:
    """Wait for the work queued on ``device`` (a no-op off the card)."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def device_time_s(f: Callable, *args, warmup: int = WARMUP,
                  k: int = REPEATS, device=None) -> float:
    """Median wall-clock seconds of ``f(*args)`` over ``k`` runs after
    ``warmup`` runs; on a CUDA ``device`` every run is synchronized on
    both sides."""
    for _ in range(max(warmup, 1)):
        f(*args)
    sync(device)
    samples = []
    for _ in range(max(k, 1)):
        sync(device)
        t0 = time.perf_counter()
        f(*args)
        sync(device)
        samples.append(time.perf_counter() - t0)
    return float(statistics.median(samples))
