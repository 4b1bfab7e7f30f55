"""Port: the loader's ``skip`` and ``temporal_jitter``, the snapshot files
(``train/checkpoint.py``) and a mid-epoch resume through
``train(device="cpu")``, against the JAX package's loader and checkpoint
helpers on the same inputs.

The resume test is the JAX test's (``tests/test_midepoch_resume.py``,
interrupted by a wrapped step that raises) on MobileNetLarge3D at
4x32x32 with dropout, augmentation, the EMA, temporal jitter, AdamW8bit
and background snapshot writes on: the resumed run's tail losses and
its final snapshot (weights, BatchNorm buffers, EMA, optimizer state,
loop and early-stop state) equal the uninterrupted run's bit for bit.
"""

import dataclasses
import os
import signal

import numpy as np
import pytest
import torch

from picklebot_tpu.data import dataset as jax_dataset
from picklebot_tpu.data import loader as jax_loader
from picklebot_tpu.train import checkpoint as jax_ckpt
from picklebot_tpu_torch.data import dataset as port_dataset
from picklebot_tpu_torch.data import loader as port_loader
from picklebot_tpu_torch.models.mobilenet3d import MobileNetLarge3D
from picklebot_tpu_torch.train import checkpoint as ckpt
from picklebot_tpu_torch.train import loop
from picklebot_tpu_torch.train.optim import AdamW8bit
from picklebot_tpu_torch.utils.config import Config


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel worker
    processes, and torch's OpenMP threads, each spinning at its barriers,
    slow every worker many times over once they outnumber the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _loaders(jitter, shuffle=True, drop_last=True):
    kw = dict(backend="synthetic", synthetic_shape=(9, 8, 8),
              synthetic_len=13)
    lk = dict(shuffle=shuffle, num_workers=3, t_bucket=4, max_frames=4,
              seed=11, drop_last=drop_last, temporal_jitter=jitter)
    return (port_loader.DataLoader(port_dataset.ClipDataset("", "", **kw), 2,
                                   **lk),
            jax_loader.DataLoader(jax_dataset.ClipDataset("", "", **kw), 2,
                                  **lk))


@pytest.mark.parametrize("jitter,skip,drop_last", [
    (False, 2, True), (True, 0, True), (True, 3, True), (True, 2, False)])
def test_skip_and_temporal_jitter_match_jax(jitter, skip, drop_last):
    lp, lj = _loaders(jitter, drop_last=drop_last)
    for epoch in (0, 1):
        for ld in (lp, lj):
            ld.set_epoch(epoch)
            ld.skip(skip)
        got, want = list(lp), list(lj)
        assert len(got) == len(want) == len(lp) - skip
        for (fp, bp), (fj, bj) in zip(got, want):
            np.testing.assert_array_equal(fp, fj)
            np.testing.assert_array_equal(bp, bj)
        assert got[0][0].shape[1] == 4        # cut to max_frames
    # one-shot: the next iteration is whole again, and the jittered
    # windows differ from the head's
    lp.set_epoch(0)
    head, _ = _loaders(False, drop_last=drop_last)
    head.set_epoch(0)
    assert len(list(lp)) == len(lp)
    if jitter:
        assert any(not np.array_equal(a[0], b[0])
                   for a, b in zip(lp, head))


@pytest.mark.parametrize("names", [
    ["step_0_2", "step_0", "step_1_2", "step_1_4"],
    ["step_0_2", "step_0", "step_1_2", "step_1_4", "step_1"],
    ["step_0", "step_1", "step_2_1", "step_3", "step_10", "step_9_9",
     "other", "step_x"],
    ["step_0_2", "step_0_4", "step_0", "step_1_2", ".step_2.tmp9"],
    []])
def test_latest_and_prune_match_jax(tmp_path, names):
    for sub in ("port", "jax"):
        for name in names:
            (tmp_path / sub / name).mkdir(parents=True)
        (tmp_path / sub).mkdir(exist_ok=True)
    port, jax = str(tmp_path / "port"), str(tmp_path / "jax")
    assert (os.path.basename(ckpt.latest_checkpoint(port) or "")
            == os.path.basename(jax_ckpt.latest_checkpoint(jax) or ""))
    for keep in (2, 1):
        ckpt.prune_midepoch(port, keep=keep)
        jax_ckpt.prune_midepoch(jax, keep=keep)
        assert sorted(os.listdir(port)) == sorted(os.listdir(jax))
        ckpt.prune_epochs(port, keep=keep)
        jax_ckpt.prune_epochs(jax, keep=keep)
        assert sorted(os.listdir(port)) == sorted(os.listdir(jax))
    assert ckpt.latest_checkpoint(str(tmp_path / "missing")) is None


def _config(tmp_path, tag, **kw):
    base = dict(model_name="MobileNetLarge3D", num_classes=13,
                criterion="CE", use_autocast=False, learning_rate=1e-3,
                batch_size=2, effective_batch_size=2, max_iters=1,
                eval_interval=1, weight_decay=5e-4, data_backend="synthetic",
                synthetic_len=8, synthetic_shape=[6, 32, 32], t_bucket=4,
                max_frames=4, num_workers=2, optimizer="adamw8bit",
                temporal_jitter=True, ema_decay=0.9, augment_flip=True,
                augment_crop=4, augment_brightness=0.2,
                checkpoint_dir=str(tmp_path / tag / "ck"),
                log_dir=str(tmp_path / tag / "runs"))
    base.update(kw)
    return Config(**base).validate()


def _interrupt(monkeypatch, after, how="raise"):
    """The loop's train step, made to stop the run before its
    (after + 1)-th call: by raising KeyboardInterrupt, or by the process
    sending itself SIGTERM."""
    real = loop.make_train_step
    calls = []

    def make(*a, **k):
        fn = real(*a, **k)

        def step(*args):
            if len(calls) >= after:
                if how == "raise":
                    raise KeyboardInterrupt("injected preemption")
                os.kill(os.getpid(), signal.SIGTERM)
            calls.append(1)
            return fn(*args)
        return step

    monkeypatch.setattr(loop, "make_train_step", make)


def _final(tmp_path, tag, config):
    d = tmp_path / tag / "ck" / f"{config.run_name()}_finished"
    return ckpt.load_checkpoint(ckpt.latest_checkpoint(str(d)))


def _assert_same_state(a, b):
    for key in ("model", "ema"):
        assert a[key].keys() == b[key].keys()
        for k in a[key]:
            assert torch.equal(a[key][k], b[key][k]), (key, k)
    oa, ob = a["optimizer"], b["optimizer"]
    assert oa["steps"] == ob["steps"] and oa["shapes"] == ob["shapes"]
    for ma, mb in zip(oa["m"] + oa["v"], ob["m"] + ob["v"]):
        for x, y in zip(*(((t,) if torch.is_tensor(t) else t)
                          for t in (ma, mb))):
            assert torch.equal(x, y)
    assert a["epoch"] == b["epoch"]
    assert torch.equal(a["loop_state"], b["loop_state"])
    assert torch.equal(a["early_stop"], b["early_stop"])


def test_midepoch_resume_is_bit_identical(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg_a = _config(tmp_path, "a")
    a = loop.train(cfg_a, device="cpu")
    assert len(a["train_losses"]) == 4

    cfg_b = _config(tmp_path, "b", checkpoint_every_steps=1,
                    async_checkpoint=True)
    with monkeypatch.context() as m:
        _interrupt(m, 2)
        part = loop.train(cfg_b, device="cpu")
    assert part["train_losses"] == a["train_losses"][:2]
    snaps = tmp_path / "b" / "ck" / "MobileNetLarge3D"
    assert sorted(os.listdir(snaps)) == ["step_0_1", "step_0_2"]

    b = loop.train(dataclasses.replace(cfg_b, auto_resume=True),
                   device="cpu")
    # only the 2 remaining steps ran, and they are A's, bit for bit
    assert b["train_losses"] == a["train_losses"][2:]
    assert b["global_step"] == a["global_step"] == 4
    _assert_same_state(_final(tmp_path, "a", cfg_a),
                       _final(tmp_path, "b", cfg_b))
    # the end-of-epoch snapshot dominates, one mid-epoch fallback stays
    assert sorted(os.listdir(snaps)) == ["step_0", "step_0_4"]
    assert ckpt.latest_checkpoint(str(snaps)).endswith("step_0")


def test_async_snapshot_round_trips_and_resumes_exactly(tmp_path):
    """A background write gives back every tensor bit for bit, and an
    AdamW8bit restored from it makes the uninterrupted run's update."""
    torch.manual_seed(0)
    model = MobileNetLarge3D(13)
    opt = AdamW8bit(model.parameters(), weight_decay=5e-4)

    def fake_step(seed):
        g = torch.Generator().manual_seed(seed)
        for p in model.parameters():
            p.grad = torch.randn(p.shape, generator=g)
        opt.step(1e-3)

    fake_step(1)
    ema = {n: p.detach().clone() for n, p in model.named_parameters()}
    payload = ckpt.snapshot(model, opt, ema, 3, [8, 2],
                            [0.5, float("inf"), 1])
    writer = ckpt.SnapshotWriter()
    path = writer.save(str(tmp_path / "snaps"), 3, payload, block=False,
                       minor=2)
    fake_step(2)                         # training goes on meanwhile
    writer.wait()
    assert path.endswith("step_3_2") and ckpt.is_snapshot(path)
    assert os.listdir(tmp_path / "snaps") == ["step_3_2"]
    back = ckpt.load_checkpoint(path)
    assert back["epoch"] == 3 and back["loop_state"].tolist() == [8, 2]
    assert back["early_stop"].dtype == torch.float64
    assert back["early_stop"].tolist() == [0.5, float("inf"), 1.0]
    for k, v in payload["model"].items():
        assert torch.equal(back["model"][k], v), k

    resumed = MobileNetLarge3D(13)
    resumed.load_state_dict(back["model"])
    opt_r = AdamW8bit(resumed.parameters(), weight_decay=5e-4)
    opt_r.load_state_dict(back["optimizer"])
    assert opt_r.steps == 1
    g = torch.Generator().manual_seed(2)
    for p in resumed.parameters():
        p.grad = torch.randn(p.shape, generator=g)
    opt_r.step(1e-3)
    for (n, p), q in zip(model.named_parameters(), resumed.parameters()):
        assert torch.equal(p, q), n
    with pytest.raises(ValueError, match="does not fit"):
        AdamW8bit(list(resumed.parameters())[1:]).load_state_dict(
            back["optimizer"])
    assert not ckpt.is_snapshot(str(tmp_path / "snaps"))
    # a background write that fails is raised by the next wait, and
    # leaves no file that could pass for a snapshot
    writer.save(str(tmp_path / "bad"), 0, {"x": lambda: 0}, block=False)
    with pytest.raises(RuntimeError, match="background snapshot write"):
        writer.wait()
    assert os.listdir(tmp_path / "bad") == []


def test_sigterm_finishes_gracefully_with_the_final_snapshot(tmp_path,
                                                             monkeypatch):
    monkeypatch.chdir(tmp_path)
    before = signal.getsignal(signal.SIGTERM)
    cfg = _config(tmp_path, "s", max_iters=2)
    with monkeypatch.context() as m:
        _interrupt(m, 3, how="sigterm")
        summary = loop.train(cfg, device="cpu")
    assert signal.getsignal(signal.SIGTERM) == before
    # 3 steps ran (the first epoch's 4 were cut), then the final writes
    assert len(summary["train_losses"]) == 3 and summary["val_losses"] == []
    fin = _final(tmp_path, "s", cfg)
    assert fin["epoch"] == 0 and fin["loop_state"].tolist() == [3, 3]
    assert os.path.exists(summary["checkpoint"])
    assert (tmp_path / "statistics" /
            f"{cfg.run_name()}_finished_train_losses.npy").exists()
    # its weights are the model's at the interrupt
    pth = torch.load(summary["checkpoint"], weights_only=True)
    for k, v in pth.items():
        assert torch.equal(fin["model"][k], v), k
