"""Reductions of a profiled window to numbers: busy time, idle share,
launches, the union of one class of kernels, exposed collective time and
the breakdown of device time and idle gaps.

Spans are (start_us, end_us) in the profiler's clock. ``events`` reads a
``torch.profiler.profile`` into plain tuples, so everything below runs on
synthetic lists in the tests.
"""

from __future__ import annotations

import heapq
from collections import namedtuple

Span = namedtuple("Span", "name start end")

COPY_PREFIXES = ("Memcpy", "Memset", "memcpy", "memset")
WINDOW_SPAN = "portbench.window"


def union_us(spans):
    """Length of the union of (start, end) spans."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total if cur_e is None else total + cur_e - cur_s


def merged(spans):
    """The union of (start, end) spans as sorted disjoint intervals."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def clip(spans, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in spans if e > lo and s < hi]


def is_copy(name: str) -> bool:
    return name.startswith(COPY_PREFIXES)


def kernels_of(device_spans):
    """The device spans that are kernels (not copies or memsets)."""
    return [d for d in device_spans if not is_copy(d.name)]


def busy_us(device_spans, window):
    """Union of every device span (kernels and copies) inside ``window``."""
    lo, hi = window
    return union_us(clip([(d.start, d.end) for d in device_spans], lo, hi))


def idle_pct(device_spans, window):
    lo, hi = window
    return 100.0 * (1.0 - busy_us(device_spans, window) / (hi - lo))


def matching(device_spans, patterns):
    return [d for d in device_spans if any(p in d.name for p in patterns)]


def summed_us(spans):
    return sum(d.end - d.start for d in spans)


def exposed_us(device_spans, patterns):
    """Time of the kernels matching ``patterns`` (collectives) during
    which no other kernel runs: their union minus its overlap with the
    union of all other kernels."""
    mine = merged([(d.start, d.end) for d in matching(device_spans,
                                                      patterns)])
    others = merged([(d.start, d.end) for d in kernels_of(device_spans)
                     if not any(p in d.name for p in patterns)])
    total = 0.0
    for s, e in mine:
        covered = union_us(clip(others, s, e))
        total += (e - s) - covered
    return total


def top_device_ops(device_spans, n=10):
    """[[name, seconds]] of the ``n`` names with the most device time."""
    by = {}
    for d in device_spans:
        by[d.name] = by.get(d.name, 0.0) + (d.end - d.start)
    top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:160], us / 1e6] for name, us in top]


def idle_gaps(device_spans, host_spans, window, n=10, min_us=10.0):
    """The device's idle gaps inside ``window``, each named by the host
    operation that overlaps it most (the shorter one on a tie), summed by
    that name: [[name, seconds]] of the ``n`` largest."""
    lo, hi = window
    busy = merged(clip([(d.start, d.end) for d in device_spans], lo, hi))
    gaps, cur = [], lo
    for s, e in busy:
        if s - cur >= min_us:
            gaps.append((cur, s))
        cur = max(cur, e)
    if hi - cur >= min_us:
        gaps.append((cur, hi))
    hosts = sorted((h for h in host_spans if h.name != WINDOW_SPAN),
                   key=lambda h: h.start)
    by, active, i = {}, [], 0
    for gs, ge in gaps:        # in order: a sweep over the host spans
        while i < len(hosts) and hosts[i].start < ge:
            heapq.heappush(active, (hosts[i].end, i))
            i += 1
        while active and active[0][0] <= gs:
            heapq.heappop(active)
        best, best_key = "(no host op)", None
        for end, j in active:
            h = hosts[j]
            ov = min(h.end, ge) - max(h.start, gs)
            key = (ov, -(h.end - h.start))
            if ov > 0 and (best_key is None or key > best_key):
                best, best_key = h.name, key
        by[best] = by.get(best, 0.0) + (ge - gs)
    top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:160], us / 1e6] for name, us in top]


def events(prof):
    """(device spans, host spans, window) of a finished
    ``torch.profiler.profile``; the window is the harness's
    ``portbench.window`` host span."""
    import torch
    dev, host, window = [], [], None
    for e in prof.events():
        span = Span(e.name, float(e.time_range.start),
                    float(e.time_range.end))
        on_device = e.device_type == torch.autograd.DeviceType.CUDA
        if e.name == WINDOW_SPAN:
            # the host span; its annotation on the device is no work
            if not on_device:
                window = (span.start, span.end)
        elif on_device:
            dev.append(span)
        else:
            host.append(span)
    if window is None:
        raise RuntimeError("the trace holds no portbench.window span")
    return dev, host, window
