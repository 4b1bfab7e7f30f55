"""Port: the training CLI end to end on the CPU, and the trainer's host
modules against the JAX package's.

``python -m picklebot_tpu_torch.cli cfg.json --device cpu --steps 2`` on a
tiny synthetic config of each model (MobileViT-xxs with the ``packed``
backend, MobileNetLarge3D with its channel dropout on): finite losses,
TensorBoard scalars under the JAX loop's tags, and a ``.pth`` that loads
strict into the port and, through ``load_pth`` with ``key_map_for``, into
the JAX package with the same values. The port's copies of the data
loader and the tfevents writer give what the JAX package's give, and every
trainer option not ported yet is refused with its ROADMAP.md item.
"""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from picklebot_tpu.core.module import flatten_dict
from picklebot_tpu.data import dataset as jax_dataset
from picklebot_tpu.data import loader as jax_loader
from picklebot_tpu.models.mobilenet3d import MobileNetLarge3D as JaxLarge3D
from picklebot_tpu.models.mobilevit import MobileViT as JaxMobileViT
from picklebot_tpu.train import metrics as jax_metrics
from picklebot_tpu.train.checkpoint import load_pth as jax_load_pth
from picklebot_tpu.train.key_maps import key_map_for
from picklebot_tpu_torch import cli
from picklebot_tpu_torch.convert import load_pth, state_dict_from_jax
from picklebot_tpu_torch.data import dataset as port_dataset
from picklebot_tpu_torch.data import loader as port_loader
from picklebot_tpu_torch.models.registry import initialize_model
from picklebot_tpu_torch.models.mobilevit import MOBILEVIT_CONFIGS
from picklebot_tpu_torch.train import metrics as port_metrics
from picklebot_tpu_torch.train.loop import UNPORTED, check_ported, train
from picklebot_tpu_torch.utils.config import Config, load_config

TAGS = {"training loss", "training accuracy", "learning rate", "val loss",
        "val accuracy"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel worker
    processes, and torch's OpenMP threads, each spinning at its barriers,
    slow every worker many times over once they outnumber the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(tmp_path, name, **extra):
    cfg = {"model_name": name, "num_classes": 13, "criterion": "CE",
           "use_autocast": False, "batch_size": 2, "effective_batch_size": 4,
           "max_iters": 1, "data_backend": "synthetic", "synthetic_len": 10,
           "synthetic_shape": [8, 64, 64], "t_bucket": 8, "max_frames": 8,
           "num_workers": 2, "optimizer": "adamw8bit",
           "checkpoint_dir": str(tmp_path / "ck"),
           "log_dir": str(tmp_path / "runs"), **extra}
    if name == "MobileViT":
        cfg.update(MOBILEVIT_CONFIGS["xxs"], attention_backend="packed")
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _jax_model(name):
    if name == "MobileViT":
        return JaxMobileViT(num_classes=13, attention_backend="packed",
                            **MOBILEVIT_CONFIGS["xxs"])
    return JaxLarge3D(13)


@pytest.mark.parametrize("name", ["MobileViT", "MobileNetLarge3D"])
def test_cli_trains_on_cpu_and_both_packages_load_the_pth(tmp_path, capsys,
                                                          name):
    tb = pytest.importorskip("tensorboard.backend.event_processing."
                             "event_accumulator")
    cfg_path = _config(tmp_path, name)
    summary = cli.main([cfg_path, "--device", "cpu", "--steps", "2"])
    assert capsys.readouterr().out.startswith("Using float32 on cpu (cpu)")
    # 2 optimizer steps x 2 microbatches; eval over all 10 val clips
    assert len(summary["train_losses"]) == 4 and summary["global_step"] == 4
    assert all(math.isfinite(v) for v in summary["train_losses"])
    assert math.isfinite(summary["final_val_loss"])
    assert summary["val_samples"] == 10
    assert summary["val_confusion"].sum() == 10

    config = load_config(cfg_path)
    acc = tb.EventAccumulator(str(tmp_path / "runs" / config.run_name()))
    acc.Reload()
    assert TAGS <= set(acc.Tags()["scalars"])
    assert [s.step for s in acc.Scalars("training loss")] == [0, 1, 2, 3]

    pth = summary["checkpoint"]
    assert pth.endswith(f"{config.run_name()}_finished.pth")
    saved = torch.load(pth, weights_only=True)
    port = load_pth(pth, initialize_model(config))      # strict
    for key, value in port.state_dict().items():
        assert torch.equal(value, saved[key]), key
    variables = jax_load_pth(pth, _jax_model(name).init(0),
                             key_map=key_map_for(name))  # strict
    back = state_dict_from_jax(flatten_dict(variables["params"]),
                               flatten_dict(variables["state"]), name)
    for key, value in back.items():
        if not key.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(value.numpy(), saved[key].numpy(),
                                          err_msg=key)


def test_cli_on_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the check is for one without")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main([_config(tmp_path, "MobileNetLarge3D"), "--steps", "1"])


@pytest.mark.parametrize("option,value", [
    ("ema_decay", 0.99), ("freeze_params", ["block1"]),
    ("augment_flip", True), ("remat", 1), ("auto_resume", True),
    ("early_stop_patience", 2), ("input_size", 64), ("data_parallel", 2),
    ("zero_sharding", 1), ("temporal_jitter", True)])
def test_unported_options_are_refused_naming_roadmap(tmp_path, option,
                                                     value):
    config = dataclasses.replace(load_config(_config(tmp_path, "MobileViT")),
                                 **{option: value})
    assert option in UNPORTED
    with pytest.raises(NotImplementedError, match=f"{option}.*ROADMAP"):
        train(config, device="cpu")


def test_orbax_checkpoint_is_refused_naming_roadmap():
    with pytest.raises(NotImplementedError, match="Orbax.*ROADMAP"):
        check_ported(Config(checkpoint="checkpoints/MobileViT/3"))


@pytest.mark.parametrize("shuffle,drop_last", [(True, True),
                                               (False, False)])
def test_loader_and_accumulation_match_jax(shuffle, drop_last):
    kw = dict(backend="synthetic", synthetic_shape=(5, 8, 8),
              synthetic_len=11)
    ds_p = port_dataset.ClipDataset("", "", **kw)
    ds_j = jax_dataset.ClipDataset("", "", **kw)
    lk = dict(shuffle=shuffle, num_workers=3, t_bucket=4, max_frames=8,
              seed=7, drop_last=drop_last)
    lp = port_loader.DataLoader(ds_p, 3, **lk)
    lj = jax_loader.DataLoader(ds_j, 3, **lk)
    assert len(lp) == len(lj)
    for epoch in (0, 1):
        lp.set_epoch(epoch)
        lj.set_epoch(epoch)
        # the train loader groups microbatches; the val loader keeps its
        # short tail batch
        accum = 2 if drop_last else 1
        got = list(port_loader.accumulate_batches(iter(lp), accum))
        want = list(jax_loader.accumulate_batches(iter(lj), accum))
        assert len(got) == len(want) > 0
        for (fp, lbp), (fj, lbj) in zip(got, want):
            np.testing.assert_array_equal(fp, fj)
            np.testing.assert_array_equal(lbp, lbj)


def test_metrics_writer_and_windowed_average_match_jax(tmp_path):
    tb = pytest.importorskip("tensorboard.backend.event_processing."
                             "event_accumulator")
    values = [2.5, 2.25, 1.75, float(np.float32(1.1))]
    for mod, sub in ((port_metrics, "port"), (jax_metrics, "jax")):
        w = mod.SummaryWriter(str(tmp_path / sub))
        for step, v in enumerate(values):
            w.add_scalar("training loss", v, step)
        w.close()
    read = {}
    for sub in ("port", "jax"):
        acc = tb.EventAccumulator(str(tmp_path / sub))
        acc.Reload()
        read[sub] = [(s.step, s.value) for s in acc.Scalars("training loss")]
    assert read["port"] == read["jax"] and len(read["port"]) == 4
    assert port_metrics.crc32c(b"123456789") == jax_metrics.crc32c(
        b"123456789")
    vals = np.random.RandomState(0).rand(2345).tolist()
    np.testing.assert_array_equal(port_metrics.windowed_average(vals),
                                  jax_metrics.windowed_average(vals))


def _jax_best_val_loss(val_losses):
    """The JAX loop's summary rule, restated: ``best_val_loss`` starts at
    ``resume_best = inf`` (``picklebot_tpu/train/loop.py:289``, ``:583``),
    moves only on an eval that is not NaN and lower than it (``:811-822``;
    NaN is an empty val set) and is returned as is, or None when no eval
    ran (``:924-925``)."""
    best = float("inf")
    for v in val_losses:
        if not math.isnan(v) and v < best:
            best = v
    return best if val_losses else None


class _ScriptedEval:
    """An eval step whose evals give the scripted mean losses; NaN is an
    eval that counted no sample, the path an empty val set takes."""

    def __init__(self, losses):
        self.losses = list(losses)

    def __call__(self, feats, labels, mask):
        v = self.losses.pop(0)
        n = 0.0 if math.isnan(v) else float(mask.sum())
        return {"loss_sum": 0.0 if n == 0 else v * n, "correct": 0.0,
                "samples": n, "confusion": np.zeros((13, 13))}


def _summary_config(tmp_path, epochs):
    tmp_path.mkdir(exist_ok=True)
    return load_config(_config(
        tmp_path, "MobileNetLarge3D", batch_size=2, effective_batch_size=2,
        synthetic_len=2, synthetic_shape=[4, 32, 32], t_bucket=4,
        max_frames=4, max_iters=epochs, eval_interval=1))


@pytest.mark.parametrize("losses", [
    [float("nan"), float("nan")], [0.5, float("nan"), 0.4],
    [0.3, 0.5, float("nan")], [float("nan"), 0.7]])
def test_summary_best_val_loss_and_stopped_early_follow_jax(
        tmp_path, monkeypatch, losses):
    """One eval per epoch (two val clips, one batch) with scripted losses:
    the summary's ``best_val_loss`` is the JAX loop's tracked best (inf
    when every eval was NaN, not None), and ``stopped_early`` is False
    (``early_stop_patience`` is refused, ROADMAP A8)."""
    from picklebot_tpu_torch.train import loop
    scripted = _ScriptedEval(losses)
    monkeypatch.setattr(loop, "make_eval_step", lambda *a, **k: scripted)
    summary = train(_summary_config(tmp_path, len(losses)), device="cpu")
    assert scripted.losses == []
    np.testing.assert_array_equal(summary["val_losses"], losses)
    assert summary["best_val_loss"] == _jax_best_val_loss(losses)
    assert summary["best_val_loss"] == min(
        [v for v in losses if not math.isnan(v)], default=float("inf"))
    assert summary["stopped_early"] is False


def test_summary_on_an_empty_val_set_and_with_no_eval(tmp_path, monkeypatch):
    """An empty val set gives NaN evals and a best of inf, as in the JAX
    loop; a run stopped (Ctrl-C) before its first eval gives None."""
    from picklebot_tpu_torch.train import loop
    make = loop._make_datasets
    monkeypatch.setattr(loop, "_make_datasets",
                        lambda config: (make(config)[0], []))
    summary = train(_summary_config(tmp_path / "empty", 2), device="cpu")
    assert [math.isnan(v) for v in summary["val_losses"]] == [True, True]
    assert summary["best_val_loss"] == float("inf") == _jax_best_val_loss(
        summary["val_losses"])
    assert summary["stopped_early"] is False

    def interrupted(*args, **kwargs):
        def step(*a, **k):
            raise KeyboardInterrupt
        return step
    monkeypatch.setattr(loop, "make_train_step", interrupted)
    summary = train(_summary_config(tmp_path / "stopped", 2), device="cpu")
    assert summary["val_losses"] == [] and summary["best_val_loss"] is None
    assert _jax_best_val_loss([]) is None
    assert summary["stopped_early"] is False
    assert loop.track_best(0.5, float("nan")) == 0.5
