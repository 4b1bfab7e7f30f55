"""Port: the profiling utilities (``utils/profiling.py``) on the CPU: a
torch.profiler trace that TensorBoard / Perfetto read, ``timeit_fn`` with
the JAX package's keys, and no memory statistics off a card."""

import glob
import json
import os

import jax.numpy as jnp
import pytest
import torch

from picklebot_tpu.utils import profiling as jax_profiling
from picklebot_tpu_torch.utils import profiling


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
    from torch.profiler import ProfilerActivity
    seen = {}
    real = torch.profiler.profile

    def spy(*args, activities=None, **kw):
        seen["activities"] = activities
        return real(*args, activities=activities, **kw)
    monkeypatch.setattr(torch.profiler, "profile", spy)
    with profiling.trace(str(tmp_path)):
        torch.ones(2).add_(1)
    assert seen["activities"] == [ProfilerActivity.CPU]


def test_timeit_fn_returns_the_jax_keys():
    calls = []

    def fn(x, scale=1.0):
        calls.append(1)
        return x * scale

    got = profiling.timeit_fn(fn, torch.ones(4), warmup=2, iters=5,
                              scale=2.0, device="cpu")
    assert len(calls) == 7
    want = jax_profiling.timeit_fn(lambda: jnp.ones(4) * 2.0, warmup=1,
                                   iters=3)
    assert list(got) == list(want) == ["mean_s", "median_s", "min_s",
                                       "max_s"]
    assert 0 <= got["min_s"] <= got["median_s"] <= got["max_s"]
    assert got["min_s"] <= got["mean_s"] <= got["max_s"]


def test_memory_stats_is_none_on_the_cpu():
    assert profiling.memory_stats("cpu") is None
    if not torch.cuda.is_available():
        assert profiling.memory_stats() is None
