"""The trace arithmetic and the per-layer readers on synthetic spans."""

import pytest

from portbench.harness import readers, session, trace, work
from portbench.harness.trace import Span

DEVICE = [Span("void main_bf16_kernel<3>(...)", 0, 10),
          Span("cudnn::convolveNd_wgrad_engine<...>", 5, 15),
          Span("Memcpy HtoD (Pageable -> Device)", 20, 30),
          Span("ncclDevKernel_AllReduce_Sum_f32", 40, 60),
          Span("void convolveNd_wgrad_engine<2>", 50, 55)]
HOST = [Span("aten::copy_", 14, 22), Span("train_step", 0, 100),
        Span("aten::item", 60, 100), Span(trace.WINDOW_SPAN, 0, 100)]
WINDOW = (0.0, 100.0)


def test_union_and_idle():
    assert trace.union_us([(0, 10), (5, 15), (20, 30)]) == 25
    assert trace.union_us([]) == 0
    assert trace.busy_us(DEVICE, WINDOW) == 15 + 10 + 20
    assert trace.idle_pct(DEVICE, WINDOW) == pytest.approx(55.0)
    assert trace.busy_us(DEVICE, (25, 45)) == 5 + 5


def test_launches_exclude_copies():
    assert len(trace.kernels_of(DEVICE)) == 4


def test_wgrad_union():
    spans = trace.matching(DEVICE, readers.WGRAD)
    assert trace.union_us([(d.start, d.end) for d in spans]) == 10 + 5


def test_exposed_collective():
    # the all-reduce's 20 us, of which another kernel covers 5
    assert trace.exposed_us(DEVICE, readers.NCCL) == 15


def test_breakdown():
    ops = trace.top_device_ops(DEVICE, n=2)
    assert ops[0] == ["ncclDevKernel_AllReduce_Sum_f32", 20e-6]
    assert len(ops) == 2
    # gaps (15, 20), (30, 40), (60, 100): the host op overlapping each
    # most, the shorter on a tie, the window span never
    gaps = trace.idle_gaps(DEVICE, HOST, WINDOW, min_us=1.0)
    assert gaps == [["aten::item", 40e-6], ["train_step", 10e-6],
                    ["aten::copy_", 5e-6]]


def window(mode, kernels, **kw):
    base = dict(clips=8, forwards=1, backwards=0, steps=0, rate=100.0,
                flops_per_clip=1e9, calls={"fused_bottleneck": [],
                                           "attention": [],
                                           "folded_conv": []})
    base.update(kw)
    return session.Window(mode, kernels, [], WINDOW, **base)


def test_readers():
    geom = ((1, 2, 4, 4, 8), 3, 1, 16, 8, False)
    win = window("serve", DEVICE, calls={"fused_bottleneck": [geom],
                                         "attention": [],
                                         "folded_conv": []},
                 host_ms=[3.0, 1.0, 2.0])
    assert readers.records_host_ms(win, "serve") == 2.0
    assert readers.records_host_ms(win, "train") is None
    assert readers.launches_per_clip(win, "serve") == 4 / 8
    assert readers.device_idle_pct(win, "serve") == pytest.approx(55.0)
    assert readers.step_mfu_pct(win, "serve") == pytest.approx(
        100 * 1e9 * 100 / 989e12)
    least = work.least_ms(*work.fused_bottleneck_work(*geom))
    assert readers.fused_bottleneck_roofline(win, "serve") == pytest.approx(
        100 * least * 1e3 / 10)
    # nothing of theirs in the window: no reading, never a 0
    assert readers.flash_attention_roofline(win, "serve") is None
    assert readers.folded_conv_roofline(win, "serve") is None
    train = window("train", DEVICE, steps=2, backwards=1)
    assert readers.wgrad_ms_per_clip(train, "train") == pytest.approx(
        15e-3 / 8)
    assert readers.collective_exposed_ms_per_step(
        train, "train") == pytest.approx(15e-3 / 2)
    assert readers.wgrad_ms_per_clip(window("train", DEVICE[:1]),
                                     "train") is None
