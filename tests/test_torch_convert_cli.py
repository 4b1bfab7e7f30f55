"""Port: the checkpoint-conversion CLI (``picklebot_tpu_torch.convert``
``main``) on the port's formats, against the JAX package's ``.pth``
files and its CLI: a JAX export goes into the port's snapshot and back
with every tensor equal, ``--like`` names keys as the JAX CLI does,
``--ema`` takes a trainer snapshot's EMA weights, and the refusals."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from picklebot_tpu import convert as jax_convert
from picklebot_tpu.models.registry import initialize_model as jax_model
from picklebot_tpu.train import checkpoint as jax_ckpt
from picklebot_tpu.train.key_maps import export_rank_for, key_map_for
from picklebot_tpu.utils.config import Config as JaxConfig
from picklebot_tpu_torch import convert
from picklebot_tpu_torch.models.registry import initialize_model
from picklebot_tpu_torch.train import checkpoint as ckpt
from picklebot_tpu_torch.train.loop import train
from picklebot_tpu_torch.utils.config import Config, load_config


@pytest.fixture(autouse=True)
def _in_tmp_path(tmp_path, monkeypatch):
    """train() writes its statistics/ under the working directory."""
    monkeypatch.chdir(tmp_path)


def _config(tmp_path, name, **extra):
    cfg = {"model_name": name, "num_classes": 13, "criterion": "CE",
           "use_autocast": False, "batch_size": 2,
           "effective_batch_size": 2, "max_iters": 1,
           "data_backend": "synthetic", "synthetic_len": 4,
           "synthetic_shape": [4, 32, 32], "t_bucket": 4, "max_frames": 4,
           "num_workers": 1, "checkpoint_dir": str(tmp_path / "ck"),
           "log_dir": str(tmp_path / "runs"), **extra}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _jax_pth(tmp_path, name, seed=7):
    """A .pth with the reference keys written by the JAX package's
    save_pth, and its variables."""
    variables = jax_model(JaxConfig(model_name=name,
                                    num_classes=13)).init(seed)
    keys = initialize_model(Config(model_name=name,
                                   num_classes=13)).state_dict().keys()
    path = tmp_path / f"jax_{name}.pth"
    jax_ckpt.save_pth(str(path), variables,
                      reverse_map=jax_ckpt.build_reverse_map(
                          keys, key_map_for(name)),
                      rank_map=export_rank_for(name))
    return str(path), variables


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("name", ["MobileNetSmall3D", "MobileNetLarge2D"])
def test_jax_pth_through_a_snapshot_and_back(tmp_path, capsys, name):
    cfg = _config(tmp_path, name)
    src, variables = _jax_pth(tmp_path, name)
    assert convert.main([src, "--config", cfg,
                         "--out", str(tmp_path / "snap")]) == 0
    info = _last_json(capsys)
    assert info == {"converted": src, "to": str(tmp_path / "snap" /
                                                 "step_0"),
                    "format": "snapshot", "model": name}
    payload = ckpt.load_checkpoint(info["to"])
    assert payload["epoch"] == 0 and payload["ema"] is None
    assert payload["optimizer"]["steps"] == 0
    theirs = convert.read_pth(src)
    assert set(payload["model"]) == set(theirs)

    back = tmp_path / "back.pth"
    assert convert.main([info["to"], "--config", cfg, "--out", str(back),
                         "--like", src]) == 0
    assert _last_json(capsys)["format"] == "torch"
    ours = torch.load(back, weights_only=True)
    assert list(ours) == list(theirs)
    for key, value in theirs.items():
        assert torch.equal(ours[key], value), key
    # and the JAX package loads it strictly into the same values
    again = jax_ckpt.load_pth(str(back), jax_model(JaxConfig(
        model_name=name, num_classes=13)).init(0), key_map=key_map_for(name))
    for a, b in zip(jax.tree_util.tree_leaves(variables),
                    jax.tree_util.tree_leaves(again)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_converted_snapshot_resumes_in_the_trainer(tmp_path, capsys):
    cfg = _config(tmp_path, "MobileNetSmall3D")
    src, _ = _jax_pth(tmp_path, "MobileNetSmall3D")
    convert.main([src, "--config", cfg, "--out", str(tmp_path / "snap")])
    snap = _last_json(capsys)["to"]
    config = load_config(cfg)
    summary = train(dataclasses.replace(config, checkpoint=snap),
                    max_steps=1, device="cpu")
    assert summary["global_step"] == 1
    assert "Loaded checkpoint at epoch 0" in capsys.readouterr().out


def test_like_mirrors_key_names_as_the_jax_cli(tmp_path, capsys):
    name = "MobileNetSmall3D"
    cfg = _config(tmp_path, name)
    src, _ = _jax_pth(tmp_path, name)
    sd = torch.load(src, weights_only=True)
    # a reference checkpoint saved from a compiled model, keys reordered
    keys = sorted(sd, reverse=True)
    like = tmp_path / "like.pth"
    torch.save({f"_orig_mod.{k}": sd[k] for k in keys}, like)
    out = tmp_path / "out.pth"
    convert.main([src, "--config", cfg, "--out", str(out), "--like",
                  str(like)])
    got = torch.load(out, weights_only=True)
    assert list(got) == keys
    for k in keys:
        assert torch.equal(got[k], sd[k]), k
    # the JAX CLI, .pth to .pth with the same --like: the same key set
    jax_out = tmp_path / "jax_out.pth"
    assert jax_convert.main([src, "--config", cfg, "--out", str(jax_out),
                             "--like", str(like)]) == 0
    assert set(torch.load(jax_out, weights_only=True)) == set(got)
    # a like file of another model is refused by key
    other, _ = _jax_pth(tmp_path, "MobileNetLarge3D", seed=1)
    with pytest.raises(KeyError, match="not this model's"):
        convert.main([src, "--config", cfg, "--out", str(out), "--like",
                      other])


def test_ema_from_a_trainer_snapshot(tmp_path, capsys):
    cfg = _config(tmp_path, "MobileNetSmall3D", ema_decay=0.5)
    train(load_config(cfg), max_steps=1, device="cpu")
    config = load_config(cfg)
    snap = ckpt.latest_checkpoint(str(tmp_path / "ck" /
                                      f"{config.run_name()}_finished"))
    payload = ckpt.load_checkpoint(snap)
    out = tmp_path / "ema.pth"
    assert convert.main([snap, "--config", cfg, "--ema", "--out",
                         str(out)]) == 0
    got = torch.load(out, weights_only=True)
    model = initialize_model(config)
    params = {n for n, _ in model.named_parameters()}
    assert params and params <= set(payload["ema"])
    moved = 0
    for key, value in got.items():
        want = payload["ema"][key] if key in params else payload["model"][key]
        assert torch.equal(value, want), key
        moved += key in params and not torch.equal(value,
                                                   payload["model"][key])
    assert moved > 0          # the EMA weights, not the live ones
    # without --ema: the live weights
    plain = tmp_path / "plain.pth"
    convert.main([snap, "--config", cfg, "--out", str(plain)])
    for key, value in torch.load(plain, weights_only=True).items():
        assert torch.equal(value, payload["model"][key]), key


def test_refusals(tmp_path):
    name = "MobileNetSmall3D"
    cfg = _config(tmp_path, name)
    src, _ = _jax_pth(tmp_path, name)
    # an Orbax snapshot is a directory: the JAX package's to convert
    orbax = tmp_path / "ck" / name / "step_3"
    orbax.mkdir(parents=True)
    with pytest.raises(NotImplementedError,
                       match="python -m picklebot_tpu.convert"):
        convert.main([str(orbax), "--config", cfg, "--out",
                      str(tmp_path / "x.pth")])
    with pytest.raises(SystemExit, match="requires a training snapshot"):
        convert.main([src, "--config", cfg, "--ema", "--out",
                      str(tmp_path / "y")])
    # a snapshot without EMA weights
    convert.main([src, "--config", cfg, "--out", str(tmp_path / "snap")])
    with pytest.raises(SystemExit, match="no EMA weights"):
        convert.main([str(tmp_path / "snap" / "step_0"), "--config", cfg,
                      "--ema", "--out", str(tmp_path / "z.pth")])
