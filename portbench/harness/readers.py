"""The arithmetic of the per-layer metrics, over a profiled ``Window``.

Each metric's file in ``portbench/metrics`` calls one of these with the
path it belongs to (``"serve"`` or ``"train"``); a reader that finds
nothing to read in the window returns None, and the metric is left out.
Kernels are attributed by name, to the source file that defines them.
"""

from __future__ import annotations

import statistics

from portbench.harness import trace, work

FUSED_BOTTLENECK = ("pool_bf16_kernel", "main_bf16_kernel",
                    "pool_f32_kernel", "main_f32_kernel",
                    "pool_split_sum_kernel", "main_split_sum_kernel")
FLASH = ("fwd_bf16_kernel", "dq_bf16_kernel", "dkv_bf16_kernel",
         "fwd_f32_kernel", "dq_f32_kernel", "dkv_f32_kernel")
FOLDED_CONV = ("conv_bf16_kernel", "conv_f32_kernel",
               "conv_split_sum_kernel")
WGRAD = ("wgrad",)
NCCL = ("nccl", "Nccl")


def _on(win, mode):
    return win.mode == mode and win.clips > 0


def records_host_ms(win, mode):
    if not _on(win, mode) or not win.host_ms:
        return None
    return statistics.median(win.host_ms)


def launches_per_clip(win, mode):
    if not _on(win, mode) or not win.kernels:
        return None
    return len(win.kernels) / win.clips


def device_idle_pct(win, mode):
    if not _on(win, mode) or not win.device_spans:
        return None
    return trace.idle_pct(win.device_spans, win.window)


def step_mfu_pct(win, mode):
    # no kernel in the window: no card measured this rate
    if not _on(win, mode) or not win.kernels or not win.flops_per_clip:
        return None
    return 100.0 * win.flops_per_clip * win.rate / work.PEAK_BF16_FLOPS


def _share(least_ms, spans):
    spent_us = trace.summed_us(spans)
    if spent_us <= 0 or least_ms <= 0:
        return None
    return 100.0 * least_ms * 1e3 / spent_us


def fused_bottleneck_roofline(win, mode):
    """Each call's least time (one fused bottleneck, counted once) over
    the device time of ``csrc/fused_bottleneck.cu``'s kernels."""
    if not _on(win, mode):
        return None
    return _share(work.fused_bottleneck_least_ms(win),
                  trace.matching(win.kernels, FUSED_BOTTLENECK))


def flash_attention_roofline(win, mode):
    """The forward's least time (with the lse in training) plus the
    backward's as one function, over the device time of the forward,
    dQ and dK/dV kernels."""
    if not _on(win, mode):
        return None
    return _share(work.flash_attention_least_ms(win),
                  trace.matching(win.kernels, FLASH))


def folded_conv_roofline(win, mode):
    """The forward's and the input gradient's least times over the
    device time of ``csrc/folded_conv.cu``'s kernels."""
    if not _on(win, mode):
        return None
    return _share(work.folded_conv_least_ms(win),
                  trace.matching(win.kernels, FOLDED_CONV))


def wgrad_ms_per_clip(win, mode):
    if not _on(win, mode):
        return None
    spans = trace.matching(win.kernels, WGRAD)
    if not spans:
        return None
    return trace.union_us([(d.start, d.end) for d in spans]) / 1e3 / win.clips


def collective_exposed_ms_per_step(win, mode):
    if not _on(win, mode) or not win.steps:
        return None
    if not trace.matching(win.kernels, NCCL):
        return None
    return trace.exposed_us(win.device_spans, NCCL) / 1e3 / win.steps
