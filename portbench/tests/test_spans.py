"""The program-span attribution (``harness/spans.py``) and its readers on
synthetic spans: one update of two microbatches, the backward's kernels
launched from another thread, a fused bottleneck in each pass."""

import pytest

from portbench.harness import session, spans, trace
from portbench.harness.trace import Span

WINDOW = (0.0, 200.0)
# the calling thread's phases and the functions inside them; the
# backward's fused span is the autograd thread's, inside the phase
PROGRAM = [Span(spans.INPUT, 0, 10), Span(spans.FORWARD, 10, 40),
           Span(spans.FUSED_FORWARD, 15, 25), Span(spans.BACKWARD, 40, 90),
           Span(spans.FUSED_BACKWARD, 50, 70),
           Span(spans.INPUT, 90, 100), Span(spans.FORWARD, 100, 120),
           Span(spans.BACKWARD, 120, 150), Span(spans.UPDATE, 150, 195)]
# (launch, device start, device end, name): one stream, in order
EVENTS = [(2, 3, 12, "Memcpy HtoD (Pageable -> Device)"),
          (8, 14, 16, "elementwise"),           # input's, by its launch
          (16, 20, 30, "main_bf16_kernel"),
          (30, 32, 45, "gemm"),
          (55, 60, 80, "wgrad_engine"),         # the autograd thread's
          (75, 85, 95, "dgrad"),
          (95, 101, 104, "Memcpy HtoD (Pageable -> Device)"),
          (105, 110, 125, "gemm"),
          (130, 131, 140, "dgrad"),
          (160, 165, 190, "adamw8bit"),
          (196, 197, 199, "sum")]               # after the update
LAUNCH = {"Memcpy": "cudaMemcpyAsync"}


def _launch_name(name):
    return LAUNCH.get(name.split()[0], "cudaLaunchKernel")


DEVICE = [Span(n, s, e) for _, s, e, n in EVENTS]
HOST = (PROGRAM + [Span(_launch_name(n), t, t + 1) for t, _, _, n in EVENTS]
        + [Span("aten::copy_", 1, 9), Span("cudaStreamSynchronize", 9, 10),
           Span("cudaDeviceSynchronize", 198, 200),
           Span(trace.WINDOW_SPAN, 0, 200)])


def window(device=DEVICE, host=HOST):
    return session.Window(
        "train", device, host, WINDOW, clips=4, forwards=2, backwards=2,
        steps=1, rate=1.0, flops_per_clip=1e9,
        calls={"fused_bottleneck": [((2, 4, 8, 8, 16), 3, 1, 32, 16, True)],
               "attention": [(4, 2, 64, 32)],
               "folded_conv": [((2, 4, 8, 8, 16), 16, (3, 3, 3))]})


def test_backward_thread_launches_fall_to_the_calling_threads_phase():
    att = spans.attribute(DEVICE, HOST, WINDOW)
    # wgrad: launched at 55 inside the fused backward span (autograd
    # thread) and the calling thread's backward phase
    assert [d.name for d in att.device[spans.FUSED_BACKWARD]] == [
        "wgrad_engine"]
    assert att.busy_us[spans.FUSED_BACKWARD] == 20
    assert [d.name for d in att.device[spans.FUSED_FORWARD]] == [
        "main_bf16_kernel"]
    busy = {k: b for k, (b, _) in att.phase_us.items()}
    # the elementwise launched in the input runs in the forward; the
    # gemm launched at 30 (forward) runs on into the backward
    assert busy[spans.INPUT] == (12 - 3) + (16 - 14) + (104 - 101)
    assert busy[spans.FORWARD] == 10 + 13 + 15
    assert busy[spans.BACKWARD] == 20 + 10 + 9
    assert busy[spans.UPDATE] == 25
    assert busy[spans.OUTSIDE] == 2


def test_partition_sums_to_the_window():
    att = spans.attribute(DEVICE, HOST, WINDOW)
    total = sum(b + i for b, i in att.phase_us.values())
    assert total == pytest.approx(WINDOW[1] - WINDOW[0])
    busy = sum(b for b, _ in att.phase_us.values())
    assert busy == pytest.approx(trace.busy_us(DEVICE, WINDOW))
    # each idle interval ends, on the host's clock, at the launch of the
    # event that ends it: (45, 60) at 55, so (40, 55), all backward;
    # (95, 101) at 95, so (89, 95): backward 1, input 5; (140, 165) at
    # 160: backward 15, update 10; the first, (0, 3) at 2: outside 1,
    # input 2; the last, (199, 200), at the window's end: outside
    idle = {k: i for k, (_, i) in att.phase_us.items()}
    assert idle[spans.INPUT] == 2 + 2 + 5 + 1
    assert idle[spans.FORWARD] == 4 + 2 + 5
    assert idle[spans.BACKWARD] == 15 + 5 + 1 + 6 + 15
    assert idle[spans.UPDATE] == 10 + 6
    assert idle[spans.OUTSIDE] == 1 + 1 + 1


def test_an_earlier_launch_keeps_the_time_it_overlaps():
    device = [Span("a", 0, 10), Span("b", 5, 20)]
    host = [Span(spans.FORWARD, 0, 2), Span(spans.BACKWARD, 2, 30),
            Span("cudaLaunchKernel", 0, 1), Span("cudaLaunchKernel", 3, 4)]
    att = spans.attribute(device, host, (0, 30))
    assert att.phase_us[spans.FORWARD][0] == 10
    assert att.phase_us[spans.BACKWARD][0] == 10


def test_readers():
    win = window()
    assert spans.phase_ms(win, "train", spans.INPUT, "clip") == \
        pytest.approx((14 + 10) / 1e3 / 4)
    assert spans.phase_ms(win, "train", spans.UPDATE, "step") == \
        pytest.approx((25 + 16) / 1e3)
    assert spans.fused_bottleneck_backward_ms_per_clip(win, "train") == \
        pytest.approx(20 / 1e3 / 4)
    share = spans.fused_bottleneck_span_roofline(win, "train")
    assert 0 < share
    assert spans.phase_ms(win, "serve", spans.INPUT, "clip") is None


def _metric(name, win):
    from portbench.harness.manifest import metric_reader
    return metric_reader(name)(win)


NEW = ["input_ms_per_clip.train", "forward_ms_per_clip.train",
       "backward_ms_per_clip.train", "update_ms_per_step.train",
       "fused_bottleneck_backward_ms_per_clip.train",
       "fused_bottleneck_span_roofline.train",
       "flash_attention_span_roofline.train",
       "folded_conv_span_roofline.train"]


@pytest.mark.parametrize("name", NEW)
def test_each_reader_is_none_without_its_span(name):
    """A trace of a program without spans (the parent's) reads None, and
    so does one whose launches and device events do not pair."""
    bare = [h for h in HOST if not h.name.startswith(spans.PREFIX)]
    assert _metric(name, window(host=bare)) is None
    unpaired = [h for h in HOST if h.name != "cudaMemcpyAsync"]
    assert _metric(name, window(host=unpaired)) is None


def test_readers_name_their_spans():
    win = window()
    present = {n for n in NEW if _metric(n, win) is not None}
    # the window holds no flash or folded conv span
    assert present == set(NEW) - {"flash_attention_span_roofline.train",
                                  "folded_conv_span_roofline.train"}


def test_program_spans_leave_the_device_readings_alone():
    """Op-scope program spans are host spans only: the device spans, and
    so the launches, the idle share and the device ops, are the trace's
    without them."""
    from portbench.harness import readers
    bare = [h for h in HOST if not h.name.startswith(spans.PREFIX)]
    for fn in (readers.launches_per_clip, readers.device_idle_pct):
        assert fn(window(), "train") == fn(window(host=bare), "train")
    assert trace.top_device_ops(window().device_spans) == \
        trace.top_device_ops(window(host=bare).device_spans)


def test_first_device_records_missing_pair_from_the_end():
    """The profiler may drop the device records of a window's first
    launches: the rest pair as before, and the first events' busy time
    goes nowhere but to the partition's busy total."""
    att = spans.attribute(DEVICE[2:], HOST, WINDOW)
    full = spans.attribute(DEVICE, HOST, WINDOW)
    assert att.device == full.device
    busy = {k: b for k, (b, _) in att.phase_us.items()}
    assert busy[spans.FORWARD] == 10 + 13 + 15
    assert busy[spans.INPUT] == 104 - 101


def test_a_calls_interleaved_streams_keep_its_span():
    """cuDNN runs one call's kernels on streams of its own: they overlap
    and start out of launch order, all under the same span."""
    device = [Span("nhwcToNchw", 10, 12), Span("wgrad", 11, 20),
              Span("nhwcToNchw", 11.5, 13), Span("sum", 25, 26)]
    host = [Span(spans.BACKWARD, 0, 30), Span(spans.FUSED_BACKWARD, 1, 9),
            *(Span("cudaLaunchKernel", t, t + 0.5) for t in (2, 4, 6, 22))]
    att = spans.attribute(device, host, (0, 30))
    assert len(att.device[spans.FUSED_BACKWARD]) == 3
    assert att.busy_us[spans.FUSED_BACKWARD] == 10


def test_idle_lies_on_the_hosts_clock_whatever_the_devices_drift():
    """Device times drifted early by 3 (as the trace's device clock
    drifts from its host clock): the idle time between the first and the
    last device event falls to the same phases."""
    drift = [Span(d.name, d.start - 3, d.end - 3) for d in DEVICE]
    a = spans.attribute(DEVICE, HOST, WINDOW).phase_us
    b = spans.attribute(drift, HOST, WINDOW).phase_us
    for phase in (spans.FORWARD, spans.BACKWARD):
        assert a[phase] == b[phase]


# a forward and a backward that run every hand-written family, each
# under its function's span
FAMILY_PROGRAM = [
    Span(spans.FORWARD, 0, 50), Span(spans.FUSED_FORWARD, 1, 10),
    Span(spans.FLASH[0], 11, 20), Span(spans.FOLDED_CONV[0], 21, 30),
    Span(spans.BACKWARD, 50, 100), Span(spans.FLASH[1], 51, 60),
    Span(spans.FOLDED_CONV[1], 61, 70)]
FAMILY_EVENTS = [(2, 3, 9, "main_bf16_kernel<3>"), (4, 9, 10, "elementwise"),
                 (12, 13, 19, "fwd_bf16_kernel<16>"),
                 (22, 23, 29, "conv_bf16_kernel"),
                 (52, 53, 57, "dq_bf16_kernel"),
                 (55, 57, 60, "dkv_bf16_kernel"),
                 (62, 63, 68, "conv_bf16_kernel"),
                 (64, 68, 69, "conv_split_sum_kernel")]


def family_window():
    device = [Span(n, s, e) for _, s, e, n in FAMILY_EVENTS]
    host = FAMILY_PROGRAM + [Span("cudaLaunchKernel", t, t + 0.5)
                             for t, _, _, _ in FAMILY_EVENTS]
    return session.Window(
        "train", device, host, (0.0, 100.0), clips=2, forwards=1,
        backwards=1, steps=1, rate=1.0, flops_per_clip=1e9,
        calls={"fused_bottleneck": [((2, 4, 8, 8, 16), 3, 1, 32, 16, True),
                                    ((2, 4, 8, 8, 16), 5, 2, 64, 24, False)],
               "attention": [(4, 2, 64, 32), (4, 2, 16, 32)],
               "folded_conv": [((2, 4, 8, 8, 32), 32, (3, 3, 3))]})


def least_ms_inline(win):
    """The per-family least times as each reader worked them out before
    ``work`` held them: the oracle of the readings."""
    from portbench.harness import work
    fused = win.forwards * sum(work.least_ms(*work.fused_bottleneck_work(*c))
                               for c in win.calls["fused_bottleneck"])
    train = win.backwards > 0
    fwd = sum(work.least_ms(*work.flash_work(*c, with_lse=train))
              for c in win.calls["attention"])
    bwd = sum(work.least_ms(*work.flash_backward_work(*c))
              for c in win.calls["attention"])
    conv = (win.forwards + win.backwards) * sum(
        work.least_ms(*work.conv_work(*c)) for c in win.calls["folded_conv"])
    return {"fused_bottleneck": fused,
            "flash_attention": win.forwards * fwd + win.backwards * bwd,
            "folded_conv": conv}


@pytest.mark.parametrize("family", ["fused_bottleneck", "flash_attention",
                                    "folded_conv"])
def test_family_readings_equal_the_inline_sums(family):
    """Both readers of a family's roofline share one least-time sum, and
    read what each read with its own copy."""
    from portbench.harness import readers
    win = family_window()
    least = least_ms_inline(win)[family]
    names = {"fused_bottleneck": readers.FUSED_BOTTLENECK,
             "flash_attention": readers.FLASH,
             "folded_conv": readers.FOLDED_CONV}[family]
    span_names = {"fused_bottleneck": (spans.FUSED_FORWARD,),
                  "flash_attention": spans.FLASH,
                  "folded_conv": spans.FOLDED_CONV}[family]
    by_kernel = getattr(readers, f"{family}_roofline")(win, "train")
    by_span = getattr(spans, f"{family}_span_roofline")(win, "train")
    assert by_kernel is not None and by_span is not None
    assert by_kernel == readers._share(
        least, trace.matching(win.kernels, names))
    assert by_span == spans._span_share(win, "train", span_names, least)
    # the fused span holds its elementwise kernel too: its share is lower
    if family == "fused_bottleneck":
        assert by_span < by_kernel
