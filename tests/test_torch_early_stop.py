"""Port: ``save_best``, ``early_stop_patience`` and the warm starts of
``train()``, by the JAX tests' determinism trick (``tests/
test_early_stop.py``): ``learning_rate`` 0 keeps the weights where they
are (only the BatchNorm statistics drift, by tiny amounts) and
``early_stop_min_delta`` 10 makes that drift no improvement, so eval 0
improves (anything beats inf) and no later eval does: patience P stops
the run after 1 + P evals. ``warm_start_partial``'s grafted and skipped
sets are held against the JAX package's ``graft_matching`` through the
key table, and grafting nothing is an error for a snapshot donor and a
``.pth`` donor alike.
"""

import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

from picklebot_tpu.core.module import flatten_dict
from picklebot_tpu.models.mobilenet3d import MobileNetLarge3D as JaxLarge3D
from picklebot_tpu.train import checkpoint as jax_ckpt
from picklebot_tpu_torch.convert import _torch_key, state_dict_from_jax
from picklebot_tpu_torch.models.mobilenet3d import MobileNetLarge3D
from picklebot_tpu_torch.train import checkpoint as ckpt
from picklebot_tpu_torch.train.loop import train
from picklebot_tpu_torch.utils.config import Config

ES = dict(learning_rate=0.0, early_stop_patience=2,
          early_stop_min_delta=10.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel worker
    processes, and torch's OpenMP threads, each spinning at its barriers,
    slow every worker many times over once they outnumber the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(root, **kw):
    base = dict(model_name="MobileNetLarge3D", num_classes=13,
                criterion="CE", use_autocast=False, learning_rate=1e-3,
                batch_size=2, effective_batch_size=2, max_iters=1,
                eval_interval=1, data_backend="synthetic", synthetic_len=4,
                synthetic_shape=[4, 32, 32], t_bucket=4, max_frames=4,
                num_workers=1, optimizer="adamw8bit",
                checkpoint_dir=str(root / "ck"), log_dir=str(root / "runs"))
    base.update(kw)
    return Config(**base).validate()


def _snaps(root, sub="MobileNetLarge3D"):
    return str(root / "ck" / sub)


def test_early_stop_halts_after_patience(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = _config(tmp_path, max_iters=10, **ES)
    summary = train(cfg, device="cpu")
    assert summary["stopped_early"] is True
    # evals at epochs 0 (improves), 1, 2 (patience spent)
    assert len(summary["val_losses"]) == 3
    np.testing.assert_allclose(summary["val_losses"][0],
                               summary["val_losses"][-1], rtol=0.2)
    # the graceful finish still wrote the final snapshot and statistics
    fin = glob.glob(str(tmp_path / "ck" / "*_finished" / "step_*"))
    assert [os.path.basename(p) for p in fin] == ["step_3"]
    state = ckpt.load_checkpoint(fin[0])
    assert state["early_stop"].tolist()[2] == 2
    stats = tmp_path / "statistics" / f"{cfg.run_name()}_finished"
    assert np.load(f"{stats}_val_losses.npy").shape == (3,)
    assert np.load(f"{stats}_train_losses.npy").shape[1] == 1
    assert np.load(f"{stats}_val_confusion.npy").shape == (13, 13)


def test_save_best_writes_and_prunes(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    summary = train(_config(tmp_path, max_iters=3, save_best=True,
                            keep_checkpoints=2), device="cpu")
    assert summary["stopped_early"] is False
    best = sorted(os.listdir(_snaps(tmp_path, "MobileNetLarge3D_best")))
    assert 1 <= len(best) <= 2      # keep-1 before each save
    vl = summary["val_losses"]
    assert int(best[-1].split("_")[1]) == int(np.argmin(vl))
    assert summary["best_val_loss"] == min(vl)
    payload = ckpt.load_checkpoint(ckpt.latest_checkpoint(
        _snaps(tmp_path, "MobileNetLarge3D_best")))
    assert payload["optimizer"]["steps"] > 0
    assert payload["early_stop"].tolist()[0] == min(vl)
    # keep_checkpoints: the newest two end-of-epoch snapshots
    assert sorted(os.listdir(_snaps(tmp_path))) == ["step_1", "step_2"]


def test_early_stop_state_survives_resume(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    sa = train(_config(tmp_path, max_iters=2, **ES), device="cpu")
    assert sa["stopped_early"] is False and len(sa["val_losses"]) == 2
    snap = ckpt.latest_checkpoint(_snaps(tmp_path))
    assert snap.endswith("step_1")
    # the resumed run spends its patience at its first eval, as an
    # uninterrupted max_iters=10 run would at its third
    sb = train(_config(tmp_path, max_iters=10, checkpoint=snap, **ES),
               device="cpu")
    assert sb["stopped_early"] is True and len(sb["val_losses"]) == 1
    assert sb["best_val_loss"] == min(sa["val_losses"])
    # auto_resume finds the same snapshot by itself
    sc = train(_config(tmp_path, max_iters=10, auto_resume=True, **ES),
               device="cpu")
    assert sc["stopped_early"] is True and len(sc["val_losses"]) == 1


def test_warm_start_resets_run_state(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    sa = train(_config(tmp_path, max_iters=2, **ES), device="cpu")
    snap = ckpt.latest_checkpoint(_snaps(tmp_path))
    ft = tmp_path / "ft"
    ft.mkdir()
    monkeypatch.chdir(ft)
    sb = train(_config(ft, max_iters=2, checkpoint=snap, warm_start=True,
                       **ES), device="cpu")
    # epochs 0 and 1 both ran: a fresh epoch, optimizer and early stop
    assert sb["stopped_early"] is False and len(sb["val_losses"]) == 2
    np.testing.assert_allclose(sb["val_losses"][0], sa["val_losses"][-1],
                               rtol=0.2)
    ft_snap = ckpt.load_checkpoint(ckpt.latest_checkpoint(_snaps(ft)))
    assert ft_snap["optimizer"]["steps"] == 4
    # under auto_resume a warm start's own snapshots outrank its donor
    sc = train(_config(ft, max_iters=3, checkpoint=snap, warm_start=True,
                       auto_resume=True, **ES), device="cpu")
    assert len(sc["val_losses"]) == 1 and sc["stopped_early"] is True


def _jax_sets(donor_classes, fresh_classes):
    jd, jf = JaxLarge3D(donor_classes).init(0), JaxLarge3D(
        fresh_classes).init(0)
    out = []
    for kind, is_state in (("params", False), ("state", True)):
        _, got, skipped = jax_ckpt.graft_matching(jd[kind], jf[kind])
        out.append(({_torch_key(p, is_state, "MobileNetLarge3D")
                     for p in got},
                    {_torch_key(p, is_state, "MobileNetLarge3D")
                     for p, _ in skipped}))
    return out, jd


def test_warm_start_partial_grafts_what_jax_grafts(tmp_path, monkeypatch,
                                                   capsys):
    monkeypatch.chdir(tmp_path)
    ((p_got, p_skip), (s_got, s_skip)), jd = _jax_sets(13, 5)
    donor = state_dict_from_jax(flatten_dict(jd["params"]),
                                flatten_dict(jd["state"]),
                                "MobileNetLarge3D")
    fresh = MobileNetLarge3D(5).state_dict()
    merged, grafted, skipped = ckpt.graft_matching(donor, fresh)
    stats = {k for k in donor if k.endswith("num_batches_tracked")}
    assert set(grafted) - stats == p_got | s_got
    assert {k for k, _ in skipped} == p_skip | s_skip == {
        "classifier.3.weight", "classifier.3.bias"}
    assert torch.equal(merged["classifier.3.bias"],
                       fresh["classifier.3.bias"])
    assert torch.equal(merged["block1.0.weight"], donor["block1.0.weight"])

    # through train(): a .pth donor at 13 classes into a 5-class run
    pth = tmp_path / "donor.pth"
    torch.save(donor, pth)
    summary = train(_config(tmp_path, num_classes=5, synthetic_classes=5,
                            checkpoint=str(pth), warm_start=True,
                            warm_start_partial=True), device="cpu")
    out = capsys.readouterr().out
    assert "kept fresh classifier.3.weight" in out
    assert f"grafted {len(grafted)} tensors" in out
    assert np.isfinite(summary["final_val_loss"])


def test_warm_start_partial_grafting_nothing_is_an_error(tmp_path,
                                                          monkeypatch):
    monkeypatch.chdir(tmp_path)
    foreign = {"stem.0.weight": torch.zeros(3), "head.weight":
               torch.zeros(2, 2)}
    pth = tmp_path / "foreign.pth"
    torch.save(foreign, pth)
    cfg = _config(tmp_path, checkpoint=str(pth), warm_start=True,
                  warm_start_partial=True)
    with pytest.raises(ValueError, match="NO donor param leaf matched"):
        train(cfg, device="cpu")
    snap = ckpt.SnapshotWriter().save(str(tmp_path / "snaps"), 0, {
        "format": ckpt.SNAPSHOT_FORMAT, "model": foreign})
    with pytest.raises(ValueError, match="NO donor param leaf matched"):
        train(dataclasses.replace(cfg, checkpoint=snap), device="cpu")


def _jax_early_stop(losses, patience, min_delta):
    """The JAX loop's rule, restated (``picklebot_tpu/train/loop.py``
    after each eval): the patience baseline moves only on an improvement
    larger than ``min_delta``, the best on any; a NaN eval moves neither.
    Returns (evals run, stopped early, best)."""
    best = baseline = float("inf")
    since = 0
    for i, v in enumerate(losses):
        if v == v:
            if v < baseline - min_delta:
                since, baseline = 0, v
            else:
                since += 1
            best = min(best, v)
        if patience and since >= patience:
            return i + 1, True, best
    return len(losses), False, best


class _ScriptedEval:
    def __init__(self, losses):
        self.losses = list(losses)

    def __call__(self, feats, labels, mask):
        v = self.losses.pop(0)
        n = 0.0 if v != v else float(mask.sum())
        return {"loss_sum": 0.0 if n == 0 else v * n, "correct": 0.0,
                "samples": n, "confusion": np.zeros((13, 13))}


@pytest.mark.parametrize("losses,patience,min_delta", [
    ([0.9, 0.8, 0.85, 0.84, 0.7], 2, 0.0),
    ([0.9, 0.89, 0.88, 0.87, 0.86], 2, 0.05),
    ([0.9, float("nan"), 0.95, 0.5, 0.6], 2, 0.0),
    ([0.5, 0.6, 0.4, 0.45, 0.44], 3, 0.0)])
def test_early_stop_follows_the_jax_rule(tmp_path, monkeypatch, losses,
                                         patience, min_delta):
    from picklebot_tpu_torch.train import loop
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(loop, "make_eval_step",
                        lambda *a, **k: _ScriptedEval(losses))
    summary = train(_config(tmp_path, max_iters=len(losses),
                            synthetic_len=2, early_stop_patience=patience,
                            early_stop_min_delta=min_delta, save_best=True),
                    device="cpu")
    n, stopped, best = _jax_early_stop(losses, patience, min_delta)
    assert len(summary["val_losses"]) == n
    assert summary["stopped_early"] is stopped
    assert summary["best_val_loss"] == best
    # save_best kept the snapshot of the best eval
    newest = sorted(os.listdir(_snaps(tmp_path, "MobileNetLarge3D_best")),
                    key=lambda name: int(name.split("_")[1]))[-1]
    assert losses[int(newest.split("_")[1])] == best


def test_warm_start_with_freeze_keeps_the_donor_weights(tmp_path,
                                                        monkeypatch):
    """The fine-tune flow, checkpoint + warm_start + freeze_params: the
    frozen tensors stay the donor's bit for bit while the head trains."""
    monkeypatch.chdir(tmp_path)
    train(_config(tmp_path, max_iters=1), device="cpu")
    snap = ckpt.latest_checkpoint(_snaps(tmp_path))
    donor = ckpt.load_checkpoint(snap)["model"]
    ft = tmp_path / "ft"
    train(_config(ft, checkpoint=snap, warm_start=True, learning_rate=1e-2,
                  freeze_params=["block*"]), device="cpu")
    tuned = ckpt.load_checkpoint(ckpt.latest_checkpoint(_snaps(ft)))
    frozen = moved = 0
    for key, value in tuned["model"].items():
        if key.startswith("block") and not key.split(".")[-1].startswith(
                ("running", "num_batches")):
            assert torch.equal(value, donor[key]), key
            frozen += 1
        elif key.startswith("classifier"):
            moved += not torch.equal(value, donor[key])
    assert frozen > 100 and moved == 4
