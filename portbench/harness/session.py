"""What every run shares: its options, the profiled window and the
per-layer metrics read from it, and the result line."""

from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Optional

import torch

from portbench.harness import trace

NOTES = "_notes"        # a generator's notes: to standard error, not the line


@dataclasses.dataclass
class Spec:
    """One run of one cell."""
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    per_layer: list            # BENCHMARK.json entries, read when traced
    end_to_end: list
    seed: int
    seconds: float
    trace: bool
    t0: float                  # the process's start (wall clock)
    device: str = "cuda"


@dataclasses.dataclass
class Window:
    """What the per-layer readers see: the profiled window's device and
    host spans, the work it held, and the untraced window's rates."""
    mode: str                  # "serve" or "train"
    device_spans: list
    host_spans: list
    window: tuple              # (start_us, end_us)
    clips: int                 # clips in the profiled window
    forwards: int              # model forwards in it
    backwards: int             # model backwards in it
    steps: int                 # optimizer steps in it
    rate: float                # clips/s of the untraced window
    flops_per_clip: float
    calls: dict                # work.geometry() of one forward
    host_ms: list = dataclasses.field(default_factory=list)

    @property
    def kernels(self):
        return trace.kernels_of(self.device_spans)


def profiled(fn, n: int):
    """Run ``fn()`` ``n`` times under torch.profiler (CPU and CUDA), the
    calls inside one ``portbench.window`` span closed by a synchronize.
    Returns (device spans, host spans, window)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(trace.WINDOW_SPAN):
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
    return trace.events(prof)


def read_per_layer(win: Window, entries: list) -> dict:
    from portbench.harness.manifest import metric_reader
    out = {}
    for m in entries:
        value = metric_reader(m["name"])(win)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def traced(win: Window, entries: list):
    """(the per-layer metrics of ``entries``, the breakdown) of a
    profiled window."""
    return read_per_layer(win, entries), {
        "device_ops": trace.top_device_ops(win.device_spans),
        "idle_gaps": trace.idle_gaps(win.device_spans, win.host_spans,
                                     win.window)}


def end_to_end(spec: Spec, values: dict) -> dict:
    """The cell's end-to-end metrics from {name: value}."""
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in spec.end_to_end}


def device_of(spec: Spec, win: Optional[Window] = None) -> dict:
    """The result's ``device``, with ``busy_s`` and ``window_s`` of a
    profiled window."""
    if spec.device == "cpu":
        return {"platform": "cpu"}
    from portbench.harness.device import device_line
    line = device_line(spec.workload["chips"])
    if win is not None:
        line["busy_s"] = trace.busy_us(win.device_spans, win.window) / 1e6
        line["window_s"] = (win.window[1] - win.window[0]) / 1e6
    return line


def free_program():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def now() -> float:
    return time.perf_counter()


def log(msg: str):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def result(correct: bool, attempted: int, failed: int, metrics: dict,
           device: dict, checks: dict, breakdown: Optional[dict] = None):
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    return line
