"""Profiling utilities: a device trace, the program's spans in it, memory.

Counterpart of ``picklebot_tpu/utils/profiling.py`` (the reference's
cProfile of train.py, torch.profiler of profilemobilevit.py, and
pytorch_memlab):

  * ``trace(logdir)``: a ``torch.profiler`` trace of the block, CPU
    activities and, where a card is present, CUDA ones; written as a
    Chrome-trace JSON (``*.pt.trace.json``) into ``logdir``, which
    TensorBoard's profile plugin and Perfetto open.
  * ``span(name)``: a named range of the program in whatever
    ``torch.profiler`` session is recording (``trace``, or any other);
    a shared no-op when none is.
  * ``memory_stats``: the caching allocator's live, peak and limit bytes
    on a card; None on the CPU.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

_NO_SPAN = contextlib.nullcontext()


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


def span(name: str):
    """A context manager that records ``name`` over its block while a
    torch profiler records, and the shared no-op otherwise: one attribute
    read, no allocation. Every name starts with ``picklebot.``.

    The range is an op-scope ``RecordFunction`` (the kind an aten op
    opens), not ``torch.profiler.record_function``'s user scope: a
    user-scope range that launches device work is mirrored on the device
    as a ``gpu_user_annotation`` event spanning its kernels, which a
    reader of the trace would take for device work. A CUDA kernel or copy
    launched inside the span is put down to it by the launching runtime
    call's place on the host timeline."""
    if _profiler._is_profiler_enabled:
        return _RecordFunctionFast(name)
    return _NO_SPAN


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
