"""Port: the autotuner (``utils/autotune.py``): the cases of
``tests/test_autotune.py`` that apply to the port's lattice,
``cudnn.benchmark`` off and on, with the measurement stubbed as there
(measure once then cache; keys by mode, shape, architecture, remat and
device; ``varying_input_size``; failed candidates recorded and retried;
all failing raises), the winner applied by ``train()`` and the flag
restored, the deterministic short-circuit, the CLI, and one real tiny
measurement on the CPU."""

import dataclasses
import json

import pytest
import torch

from picklebot_tpu.utils import autotune as jax_at
from picklebot_tpu.utils.config import Config as JaxConfig
from picklebot_tpu_torch.train import loop
from picklebot_tpu_torch.utils import autotune as at
from picklebot_tpu_torch.utils.config import Config


def _cfg(**kw):
    kw.setdefault("model_name", "MobileNetSmall3D")
    kw.setdefault("batch_size", 2)
    kw.setdefault("effective_batch_size", 2)
    kw.setdefault("synthetic_shape", (2, 32, 32))
    kw.setdefault("data_backend", "synthetic")
    return Config(**kw).validate()


@pytest.fixture()
def benchmark_flag():
    """The global flag as the test found it, put back after."""
    prev = torch.backends.cudnn.benchmark
    yield prev
    torch.backends.cudnn.benchmark = prev


@pytest.fixture()
def deterministic():
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def _stub(monkeypatch, rates, calls=None):
    """measure_candidate -> rates[benchmark] (an Exception is raised)."""
    def fake(config, benchmark, mode, shape, device="cuda", steps=1,
             warmup=2):
        if calls is not None:
            calls.append(benchmark)
        rate = rates[benchmark]
        if isinstance(rate, Exception):
            raise rate
        return rate
    monkeypatch.setattr(at, "measure_candidate", fake)


def test_candidates_and_names(deterministic):
    assert at.candidates() == [False]
    torch.use_deterministic_algorithms(False)
    assert at.candidates() == [False, True]
    assert [at.candidate_name(b) for b in (False, True)] == \
        ["benchmark_off", "benchmark_on"]


def test_autotune_measures_once_then_caches(tmp_path, monkeypatch):
    cache = str(tmp_path / "autotune.json")
    calls = []
    _stub(monkeypatch, {False: 100.0, True: 120.0}, calls)
    cfg = _cfg()
    assert at.autotune(cfg, "train", device="cpu", cache_path=cache) is True
    assert calls == [False, True]
    calls.clear()
    assert at.autotune(cfg, "train", device="cpu", cache_path=cache) is True
    assert calls == []
    (entry,) = json.load(open(cache)).values()
    assert entry["benchmark"] is True
    assert entry["measured"] == {"benchmark_off": 100.0,
                                 "benchmark_on": 120.0}
    # ms per step of the batch of 2
    assert entry["ms_per_step"] == {"benchmark_off": 20.0,
                                    "benchmark_on": 1e3 * 2 / 120.0}


def test_tune_shape_is_the_jax_one():
    for kw in ({}, {"autotune_shape": (4, 64, 48)},
               {"model_name": "MobileViTV2", "synthetic_shape": (1, 32, 32),
                "num_classes": 13}):
        port, jax = _cfg(**kw), JaxConfig(**dataclasses.asdict(_cfg(**kw)))
        for mode in ("train", "infer"):
            assert at._tune_shape(port, mode) == jax_at._tune_shape(jax,
                                                                    mode)


def test_cache_key_separates_modes_and_shapes(tmp_path, monkeypatch):
    cache = str(tmp_path / "autotune.json")
    _stub(monkeypatch, {False: 2.0, True: 1.0})
    cfg = _cfg()
    assert at.autotune(cfg, "train", device="cpu", cache_path=cache) is False
    at.autotune(cfg, "infer", device="cpu", cache_path=cache)
    at.autotune(dataclasses.replace(cfg, autotune_shape=(2, 64, 64)),
                "train", device="cpu", cache_path=cache)
    assert len(json.load(open(cache))) == 3


def test_cache_key_separates_architectures_and_remat(tmp_path, monkeypatch):
    cache = str(tmp_path / "autotune.json")
    _stub(monkeypatch, {False: 1.0, True: 1.0})
    base = _cfg(model_name="MobileViT", dims=[64, 80, 96],
                channels=[16, 16, 24, 24, 48, 48, 64, 64, 80, 80, 320])
    for cfg in (base, dataclasses.replace(base, dims=(96, 120, 144)),
                dataclasses.replace(base, attention_backend="packed"),
                _cfg(), _cfg(remat=1)):
        at.autotune(cfg, "train", device="cpu", cache_path=cache)
    assert len(json.load(open(cache))) == 5
    # remat changes nothing an inference measures
    at.autotune(_cfg(remat=1), "infer", device="cpu", cache_path=cache)
    at.autotune(_cfg(), "infer", device="cpu", cache_path=cache)
    assert len(json.load(open(cache))) == 6


def test_cache_key_separates_cards_and_cudnn_versions(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.backends.cudnn, "version", lambda: 91002)
    cfg, shape = _cfg(), (2, 2, 32, 32, 3)
    card = at._cache_key(cfg, "train", shape, "cuda")
    assert card.startswith("cuda:NVIDIA H100 80GB HBM3:cudnn91002|")
    assert at._cache_key(cfg, "train", shape, "cpu").startswith("cpu|")
    monkeypatch.setattr(torch.backends.cudnn, "version", lambda: 90100)
    assert at._cache_key(cfg, "train", shape, "cuda") != card


def test_varying_input_size_skips_measurement(monkeypatch, benchmark_flag):
    _stub(monkeypatch, {False: AssertionError("measured"),
                        True: AssertionError("measured")})
    cfg = _cfg(varying_input_size=True, autotune=True)
    tuned, benchmark = at.autotune_config(cfg, "train", device="cpu")
    assert benchmark is None and tuned.autotune is False
    assert dataclasses.replace(tuned, autotune=True) == cfg


def test_failed_candidate_skipped_and_recorded(tmp_path, monkeypatch):
    cache = str(tmp_path / "autotune.json")
    _stub(monkeypatch, {False: RuntimeError("simulated OOM"), True: 10.0})
    assert at.autotune(_cfg(), "train", device="cpu", cache_path=cache)
    (entry,) = json.load(open(cache)).values()
    assert "RuntimeError" in entry["failed"]["benchmark_off"]
    assert entry["measured"] == {"benchmark_on": 10.0}


def test_all_candidates_failing_raises(tmp_path, monkeypatch):
    _stub(monkeypatch, {False: RuntimeError("device gone"),
                        True: RuntimeError("device gone")})
    with pytest.raises(RuntimeError, match="every candidate failed"):
        at.autotune(_cfg(), "train", device="cpu",
                    cache_path=str(tmp_path / "autotune.json"))
    assert not (tmp_path / "autotune.json").exists()


def test_failed_entry_is_retried_not_permanent(tmp_path, monkeypatch):
    cache = str(tmp_path / "autotune.json")
    calls = []
    _stub(monkeypatch, {False: RuntimeError("transient"), True: 10.0},
          calls)
    assert at.autotune(_cfg(), "train", device="cpu", cache_path=cache)
    calls.clear()
    _stub(monkeypatch, {False: 99.0, True: 10.0}, calls)
    assert at.autotune(_cfg(), "train", device="cpu",
                       cache_path=cache) is False
    assert calls == [False]          # only the failed one re-measured
    calls.clear()
    assert at.autotune(_cfg(), "train", device="cpu",
                       cache_path=cache) is False
    assert calls == []
    (entry,) = json.load(open(cache)).values()
    assert "failed" not in entry


def test_autotune_config_returns_the_winner(tmp_path, monkeypatch):
    _stub(monkeypatch, {False: 1.0, True: 3.0})
    tuned, benchmark = at.autotune_config(
        _cfg(autotune=True), "train", device="cpu",
        cache_path=str(tmp_path / "c.json"))
    assert benchmark is True and tuned.autotune is False


def test_deterministic_run_short_circuits(tmp_path, monkeypatch,
                                          deterministic):
    _stub(monkeypatch, {False: AssertionError("measured"),
                        True: AssertionError("measured")})
    assert at.autotune(_cfg(), "train", device="cpu",
                       cache_path=str(tmp_path / "c.json")) is False
    assert not (tmp_path / "c.json").exists()


def test_cudnn_benchmark_restores_the_flag(benchmark_flag):
    torch.backends.cudnn.benchmark = False
    with at.cudnn_benchmark(True):
        assert torch.backends.cudnn.benchmark is True
    assert torch.backends.cudnn.benchmark is False
    with pytest.raises(ValueError):
        with at.cudnn_benchmark(True):
            raise ValueError("a failed candidate")
    assert torch.backends.cudnn.benchmark is False
    with at.cudnn_benchmark(None):
        assert torch.backends.cudnn.benchmark is False


def test_measurement_restores_the_flag_after_a_failure(monkeypatch,
                                                       benchmark_flag):
    from picklebot_tpu_torch import bench

    def boom(*a, **kw):
        assert torch.backends.cudnn.benchmark is True
        raise RuntimeError("out of memory")
    monkeypatch.setattr(bench, "Workload", boom)
    torch.backends.cudnn.benchmark = False
    with pytest.raises(RuntimeError, match="out of memory"):
        at.measure_candidate(_cfg(), True, "infer", (1, 2, 32, 32, 3),
                             device="cpu")
    assert torch.backends.cudnn.benchmark is False


@pytest.mark.parametrize("fails", [False, True])
def test_train_applies_the_winner_and_restores_the_flag(
        tmp_path, monkeypatch, benchmark_flag, fails):
    monkeypatch.setenv("PICKLEBOT_AUTOTUNE_CACHE", str(tmp_path / "c.json"))
    _stub(monkeypatch, {False: 1.0, True: 3.0})
    seen = {}

    def body(config, max_steps, device):
        seen["benchmark"] = torch.backends.cudnn.benchmark
        seen["autotune"] = config.autotune
        if fails:
            raise KeyboardInterrupt("a run that ends early")
        return {"ok": True}
    monkeypatch.setattr(loop, "_train", body)
    torch.backends.cudnn.benchmark = False
    if fails:
        with pytest.raises(KeyboardInterrupt):
            loop.train(_cfg(autotune=True), device="cpu")
    else:
        assert loop.train(_cfg(autotune=True), device="cpu") == {"ok": True}
    assert seen == {"benchmark": True, "autotune": False}
    assert torch.backends.cudnn.benchmark is False


def test_cache_path_and_atomic_save(tmp_path, monkeypatch):
    monkeypatch.setenv("PICKLEBOT_AUTOTUNE_CACHE", str(tmp_path / "x.json"))
    assert at._cache_path() == str(tmp_path / "x.json")
    monkeypatch.delenv("PICKLEBOT_AUTOTUNE_CACHE")
    assert at._cache_path().endswith(
        "/.cache/picklebot_tpu_torch/autotune.json")
    path = tmp_path / "deep" / "c.json"
    at._save_cache(str(path), {"k": {"benchmark": True}})
    assert json.load(open(path)) == {"k": {"benchmark": True}}
    assert [p.name for p in path.parent.iterdir()] == ["c.json"]


def test_cli_prints_each_candidate(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("PICKLEBOT_AUTOTUNE_CACHE", str(tmp_path / "c.json"))
    _stub(monkeypatch, {False: 40.0, True: 50.0})
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"model_name": "MobileNetSmall3D",
                               "num_classes": 13}))
    assert at.main([str(cfg), "--mode", "infer", "--batch", "4",
                    "--frames", "2", "--size", "32", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "MobileNetSmall3D infer at (4, 2, 32, 32, 3) on cpu" in out
    assert "benchmark_off:      40.00 samples/s (100.000 ms/step)" in out
    assert "benchmark_on:      50.00 samples/s (80.000 ms/step)" in out
    assert "winner: cudnn.benchmark=True" in out
    (key,) = json.load(open(tmp_path / "c.json"))
    assert key.startswith("cpu|MobileNetSmall3D|infer|4x2x32x32x3|")


def test_real_tiny_measurement_on_the_cpu(tmp_path):
    """The harness the search runs per candidate: the bench's Workload,
    timed by the host clock on the CPU."""
    cfg = _cfg(use_autocast=False)
    rate = at.measure_candidate(cfg, False, "infer", (1, 2, 32, 32, 3),
                                device="cpu", steps=1, warmup=1)
    assert rate > 0
    cache = str(tmp_path / "c.json")
    at.autotune(cfg, "infer", device="cpu", cache_path=cache)
    (entry,) = json.load(open(cache)).values()
    assert set(entry["measured"]) == {"benchmark_off", "benchmark_on"}
    assert all(r > 0 for r in entry["measured"].values())
