"""Timing on one CUDA device, by CUDA events.

- ``call_ms``: events around one call.  It counts the device's time plus
  any host time the call spends before its last launch (Python checks,
  allocation), because the device idles while the host enqueues.
- ``device_ms``: the call is captured once into a CUDA graph, and each run
  writes a 256 MiB buffer (five times the H100's 50 MB L2) and then times
  one replay of the graph between two events.  The write takes longer than
  the host needs to enqueue the events and the replay, so the replay starts
  as soon as the write ends: only the device's time counts, and the call
  finds its inputs in device memory, not in L2, as a merge finds them
  after the stages before it.  The call must not synchronize with the host
  (a ``.item()`` or ``nonzero`` cannot be captured).
"""
from __future__ import annotations

import statistics
from typing import Callable

import torch

FLUSH_BYTES = 256 << 20


def call_ms(fn: Callable[[], object], runs: int, warmup: int = 1) -> float:
    """Median over ``runs`` of one call's time between two events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn: Callable[[], object], runs: int) -> float:
    """Median over ``runs`` of one replay of ``fn`` captured as a CUDA
    graph, each after a write that evicts the L2 cache."""
    fn()  # builds and loads what the call needs, outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for i in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        flush.fill_(i)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)
