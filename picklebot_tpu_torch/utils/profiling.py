"""Profiling utilities: a device trace, steady-state timing, memory.

Counterpart of ``picklebot_tpu/utils/profiling.py`` (the reference's
cProfile of train.py, torch.profiler of profilemobilevit.py, and
pytorch_memlab):

  * ``trace(logdir)``: a ``torch.profiler`` trace of the block, CPU
    activities and, where a card is present, CUDA ones; written as a
    Chrome-trace JSON (``*.pt.trace.json``) into ``logdir``, which
    TensorBoard's profile plugin and Perfetto open.
  * ``timeit_fn``: warm up, then time calls, each closed by
    ``torch.cuda.synchronize`` on the card.
  * ``memory_stats``: the caching allocator's live, peak and limit bytes
    on a card; None on the CPU.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block into ``logdir``; yields the profiler."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


def _sync(device):
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timeit_fn(fn: Callable, *args, warmup: int = 3, iters: int = 10,
              device=None, **kwargs) -> dict:
    """Warm up, then time ``iters`` calls of ``fn(*args, **kwargs)`` by
    the host clock, each closed by a synchronize when ``device`` is a
    card (default: the card, where there is one). Returns seconds."""
    if device is None and torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    for _ in range(warmup):
        fn(*args, **kwargs)
    _sync(device)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        _sync(device)
        times.append(time.perf_counter() - t0)
    times.sort()
    return {
        "mean_s": sum(times) / len(times),
        "median_s": times[len(times) // 2],
        "min_s": times[0],
        "max_s": times[-1],
    }


def memory_stats(device=None) -> Optional[dict]:
    """{'bytes_in_use', 'peak_bytes_in_use', 'bytes_limit'} of a card
    (default: the current one, if any), from the caching allocator and
    the card's total memory; None on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_limit": total,
    }
