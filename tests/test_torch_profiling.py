"""Port: the profiling utilities (``utils/profiling.py``) on the CPU: a
torch.profiler trace that TensorBoard / Perfetto read, the program's
spans in it (the train step's four phases, each hand-written function's
forward and backward), and no memory statistics off a card."""

import glob
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from picklebot_tpu_torch.core.policy import DtypePolicy
from picklebot_tpu_torch.data.augment import Augment
from picklebot_tpu_torch.ops import flash_attention as fa
from picklebot_tpu_torch.ops import folded_conv as fc
from picklebot_tpu_torch.ops import fused_bottleneck as fb
from picklebot_tpu_torch.train.optim import AdamW
from picklebot_tpu_torch.train.step import make_train_step
from picklebot_tpu_torch.utils import profiling

USER_SCOPE = int(torch._C._profiler.RecordScope.USER_SCOPE.value)


def _spans(prof, prefix="picklebot."):
    return sorted((e for e in prof.events() if e.name.startswith(prefix)),
                  key=lambda e: e.time_range.start)


def test_trace_writes_a_readable_chrome_trace(tmp_path):
    a = torch.rand(64, 64)
    with profiling.trace(str(tmp_path / "tr")) as prof:
        (a @ a).sum()
    assert prof is not None
    files = glob.glob(os.path.join(tmp_path, "tr", "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::mm" in names


def test_trace_records_cpu_activity_only_without_a_card(tmp_path,
                                                       monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the check is for one without")
    seen = {}
    real = torch.profiler.profile

    def spy(*args, activities=None, **kw):
        seen["activities"] = activities
        return real(*args, activities=activities, **kw)
    monkeypatch.setattr(torch.profiler, "profile", spy)
    with profiling.trace(str(tmp_path)):
        torch.ones(2).add_(1)
    assert seen["activities"] == [ProfilerActivity.CPU]


def test_memory_stats_is_none_on_the_cpu():
    assert profiling.memory_stats("cpu") is None
    if not torch.cuda.is_available():
        assert profiling.memory_stats() is None


def test_span_is_the_shared_no_op_without_a_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("span opened a range with no profiler on")
    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    outer, inner = profiling.span("picklebot.a"), profiling.span("picklebot.b")
    assert outer is inner
    with outer, inner:
        torch.ones(2).add_(1)


def test_span_records_its_name_under_the_profiler():
    """In the trace, around the ops it holds, and not as a user-scope
    range (which would be mirrored on the device as an annotation)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("picklebot.test"):
            torch.ones(4).add_(1)
    [ev] = _spans(prof)
    assert ev.name == "picklebot.test"
    assert ev.scope != USER_SCOPE
    [add] = [e for e in prof.events() if e.name == "aten::add_"]
    assert ev.time_range.start <= add.time_range.start
    assert add.time_range.end <= ev.time_range.end


class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(3, 5)

    def forward(self, x):                      # (B, T, H, W, C)
        return self.fc(x.mean(dim=(1, 2, 3)))


@pytest.mark.parametrize("augment", [None, Augment(flip=True, crop=1)])
def test_train_step_phases_tile_each_update(augment):
    """Per update: input, forward and backward once per microbatch, in
    that order, then the update once; no two overlap."""
    a = 3
    model = _Tiny()
    step = make_train_step(model, AdamW(model.parameters()), "CE",
                           lambda e: 1e-3, DtypePolicy.f32(),
                           max_grad_norm=1.0, device="cpu", augment=augment)
    rng = np.random.RandomState(0)
    feats = rng.randint(0, 256, (a, 2, 2, 6, 6, 3)).astype(np.uint8)
    labels = rng.randint(0, 5, (a, 2))
    step(0, feats, labels)                     # nothing recorded off-trace
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for position in (0, a):
            step(0, feats, labels, position)
    spans = _spans(prof, "picklebot.step.")
    phase = ["picklebot.step.input", "picklebot.step.forward",
             "picklebot.step.backward"]
    assert [e.name for e in spans] == 2 * (a * phase
                                           + ["picklebot.step.update"])
    for prev, nxt in zip(spans, spans[1:]):
        assert prev.time_range.end <= nxt.time_range.start


def _fused_bottleneck():
    g = torch.Generator().manual_seed(0)
    c, e, co, k = 4, 8, 6, 3

    def r(*shape):
        return (0.3 * torch.randn(*shape, generator=g)).requires_grad_()
    return fb.fused_bottleneck(r(2, 3, 6, 6, c), r(c, e), r(k, k, e),
                               r(e, co), r(e, e // 4), r(e // 4),
                               r(e // 4, e), r(e), k, 2, True)


def _qkv(n=16, hd=16):
    g = torch.Generator().manual_seed(1)
    return [torch.randn(2, n, hd, generator=g).requires_grad_()
            for _ in range(3)]


def _folded_conv():
    g = torch.Generator().manual_seed(2)
    x = torch.randn(1, 3, 4, 4, 4, generator=g).requires_grad_()
    w = torch.randn(3, 3, 3, 4, 5, generator=g).requires_grad_()
    return fc.folded_conv_s1(x, w, [(1, 1)] * 3)


@pytest.mark.parametrize("name, call, forward, backward", [
    ("fused_bottleneck", _fused_bottleneck,
     "picklebot.fused_bottleneck.forward",
     "picklebot.fused_bottleneck.backward"),
    ("flash_packed", lambda: fa.flash_attention_packed(*_qkv(), heads=2),
     fa.FORWARD_SPAN, fa.BACKWARD_SPAN),
    ("flash_heads", lambda: fa.flash_attention(*_qkv(hd=8)),
     fa.FORWARD_SPAN, fa.BACKWARD_SPAN),
    ("flash_qkvpacked", lambda: fa.flash_attention_qkvpacked(
        torch.randn(2, 16, 3, 2, 8).requires_grad_()),
     fa.FORWARD_SPAN, fa.BACKWARD_SPAN),
    ("folded_conv", _folded_conv, "picklebot.folded_conv.forward",
     "picklebot.folded_conv.dx"),
])
def test_function_spans_once_per_call(name, call, forward, backward):
    """The function's forward span once in its forward, its backward (dx)
    span once in its backward, and no other program span."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call().float().square().sum().backward()
    assert [e.name for e in _spans(prof)] == [forward, backward], name
