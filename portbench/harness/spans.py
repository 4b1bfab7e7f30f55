"""The program's own spans in a profiled window: which ``picklebot.*``
span of the port launched each device event, and the window split by
the train step's phases.

The port opens its spans (``picklebot_tpu_torch/utils/profiling.py``
``span``) as op-scope ranges: they are host spans of the trace, with no
device event of their own, so the window's device spans are the same
with them as without.

**Launches.** A ``Span`` carries no correlation id, so a device event is
paired with the runtime call that launched it by order, counted from
the window's end: the k-th last device event by start with the k-th
last launching runtime call by start, whichever thread made it. Work
launched later starts after work launched earlier has ended (one stream;
cuDNN forks a grouped conv over streams of its own and joins them before
the next call), so the order holds between calls, and within one call,
whose events may interleave, every event has the same spans around its
launch. Counted from the end, because the profiler may miss the device
records of a window's first launches (seen on the H100: 3 to 24 runtime
calls in the first 14 ms of a window had none), never those of its last;
a device event left unpaired at the start belongs to no span. More than
1% of them unpaired, and the pairing is not trusted: nothing is
attributed.

A device event belongs to the spans open at its launch's start, on any
thread: the autograd engine's device thread launches a backward's
kernels while the calling thread waits inside
``picklebot.step.backward``, and a function's own spans on that thread
lie inside it.

**The partition.** Every instant of the window goes to one step phase
or to ``outside``. A busy instant goes to the phase that launched the
earliest-started device event running then. An idle interval goes to the
phases the host was in over it, placed on the host's clock as ending at
the launch of the device event that ends it (the device waits for that
launch), or at the window's end: the trace's device clock drifts from
its host clock by up to 4 ms over a window (seen on the H100), so the
device's own times cannot be laid on the host's phases.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Optional

from portbench.harness import trace, work

PREFIX = "picklebot."
PHASE_PREFIX = "picklebot.step."
INPUT, FORWARD = "picklebot.step.input", "picklebot.step.forward"
BACKWARD, UPDATE = "picklebot.step.backward", "picklebot.step.update"
OUTSIDE = "outside"
FUSED_FORWARD = "picklebot.fused_bottleneck.forward"
FUSED_BACKWARD = "picklebot.fused_bottleneck.backward"
FLASH = ("picklebot.flash.forward", "picklebot.flash.backward")
FOLDED_CONV = ("picklebot.folded_conv.forward", "picklebot.folded_conv.dx")

# runtime calls that enqueue one device event each (CUDA runtime and
# driver API); a host callback enqueues none
LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cuMemcpy",
                   "cudaMemset", "cuMemset")
NOT_LAUNCHES = ("cudaLaunchHostFunc", "cuLaunchHostFunc")


def is_launch(name: str) -> bool:
    return name.startswith(LAUNCH_PREFIXES) and name not in NOT_LAUNCHES


@dataclasses.dataclass
class Attribution:
    """``phase_us``: {phase or ``outside``: (busy us, idle us)} over the
    window; ``device``: {function span name: [the device spans whose
    launch it was the innermost span around]}; ``busy_us``: {function
    span name: those device spans' share of the busy time}."""
    phase_us: dict
    device: dict
    busy_us: dict


def _owners(launches, program):
    """(phase, innermost function span or None) of each launch time in
    ``launches`` (sorted), from the program's host spans."""
    spans = sorted(program, key=lambda h: h.start)
    out, active, i = [], [], 0
    for t in launches:
        while i < len(spans) and spans[i].start <= t:
            active.append(spans[i])
            i += 1
        active = [h for h in active if h.end >= t]
        phase, fn = OUTSIDE, None
        for h in sorted(active, key=lambda h: h.start - h.end):
            if h.name.startswith(PHASE_PREFIX):
                phase = h.name
            else:
                fn = h.name           # the shortest open span wins
        out.append((phase, fn))
    return out


def _idle_on_host(dev, launch, window):
    """The window's idle intervals (the window less the union of ``dev``,
    sorted by start) placed on the host's clock: each ends at the launch
    (``launch``, in ``dev``'s order; None where unpaired) of the event
    that ends it, the last at the window's end."""
    lo, hi = window
    out, cur = [], lo
    for d, t in zip(dev, launch):
        if d.start > cur and cur < hi:
            gap = min(d.start, hi) - cur
            end = hi if d.start >= hi else (d.start if t is None else t)
            out.append((end - gap, end))
        cur = max(cur, d.end)
    if hi > cur:
        out.append((max(cur, lo), hi))
    return out


def _idle_by_phase(idle, phases):
    """{phase or ``outside``: idle us}: each host-clock idle interval
    split where the host's phases (disjoint, sorted) begin and end."""
    by = {OUTSIDE: 0.0}
    for s, e in idle:
        covered = 0.0
        for h in phases:              # few phases a window: no sweep
            ov = min(e, h.end) - max(s, h.start)
            if ov > 0:
                by[h.name] = by.get(h.name, 0.0) + ov
                covered += ov
        by[OUTSIDE] += (e - s) - covered
    return by


def attribute(device_spans, host_spans, window) -> Optional[Attribution]:
    """The window's device events put down to the program's spans, or
    None when the trace holds no program span or its launches and
    device events do not pair."""
    program = [h for h in host_spans if h.name.startswith(PREFIX)]
    if not program:
        return None
    launches = sorted(h.start for h in host_spans if is_launch(h.name))
    dev = sorted(device_spans, key=lambda d: d.start)
    paired = min(len(launches), len(dev))
    if len(dev) - paired > 0.01 * len(dev) or not paired:
        print(f"portbench: {len(launches)} launching runtime calls for "
              f"{len(dev)} device events; program spans not attributed",
              file=sys.stderr)
        return None
    launch = [None] * (len(dev) - paired) + launches[len(launches) - paired:]
    owners = [(OUTSIDE, None)] * (len(dev) - paired) + _owners(
        launch[len(dev) - paired:], program)
    lo, hi = window
    busy_phase, device, busy_fn = {}, {}, {}
    reach = lo
    for d, (phase, fn) in zip(dev, owners):
        # the part of d that no earlier-started event already covers
        own = max(0.0, min(d.end, hi) - max(d.start, reach))
        reach = max(reach, d.end)
        busy_phase[phase] = busy_phase.get(phase, 0.0) + own
        if fn is not None:
            device.setdefault(fn, []).append(d)
            busy_fn[fn] = busy_fn.get(fn, 0.0) + own
    phases = sorted((h for h in program if h.name.startswith(PHASE_PREFIX)),
                    key=lambda h: h.start)
    idle = _idle_by_phase(_idle_on_host(dev, launch, window), phases)
    names = set(busy_phase) | set(idle)
    return Attribution({n: (busy_phase.get(n, 0.0), idle.get(n, 0.0))
                        for n in names}, device, busy_fn)


def of(win) -> Optional[Attribution]:
    """``attribute`` of a ``session.Window``, worked out once per window
    (every reader of a run asks for it)."""
    key = "_program_spans"
    if key not in win.__dict__:
        win.__dict__[key] = attribute(win.device_spans, win.host_spans,
                                      win.window)
    return win.__dict__[key]


# ------------------------------------------------------------- readers

def _attributed(win, mode):
    if win.mode != mode or win.clips <= 0:
        return None
    return of(win)


def phase_ms(win, mode, phase, per):
    """The phase's busy plus idle time, ms per clip (``per`` "clip") or
    per optimizer step ("step"); None without the phase's span."""
    att = _attributed(win, mode)
    if att is None or phase not in att.phase_us:
        return None
    n = win.clips if per == "clip" else win.steps
    return sum(att.phase_us[phase]) / 1e3 / n if n else None


def fused_bottleneck_backward_ms_per_clip(win, mode):
    att = _attributed(win, mode)
    if att is None or FUSED_BACKWARD not in att.device:
        return None
    return att.busy_us[FUSED_BACKWARD] / 1e3 / win.clips


def _span_share(win, mode, names, least_ms):
    att = _attributed(win, mode)
    if att is None or not any(n in att.device for n in names):
        return None
    spent_us = sum(trace.summed_us(att.device.get(n, [])) for n in names)
    if spent_us <= 0 or least_ms <= 0:
        return None
    return 100.0 * least_ms * 1e3 / spent_us


def fused_bottleneck_span_roofline(win, mode):
    """``readers.fused_bottleneck_roofline``'s least time over the device
    time of everything launched under the fused forward's spans: the
    pool pass, the SE MLP, the main pass and their buffers."""
    return _span_share(win, mode, (FUSED_FORWARD,),
                       work.fused_bottleneck_least_ms(win))


def flash_attention_span_roofline(win, mode):
    """``readers.flash_attention_roofline``'s least time over the device
    time of everything launched under the flash forward and backward
    spans: the kernels, the backward's D pass and the layout copies."""
    return _span_share(win, mode, FLASH, work.flash_attention_least_ms(win))


def folded_conv_span_roofline(win, mode):
    """``readers.folded_conv_roofline``'s least time over the device time
    of everything launched under the conv's forward and dx spans."""
    return _span_share(win, mode, FOLDED_CONV,
                       work.folded_conv_least_ms(win))
