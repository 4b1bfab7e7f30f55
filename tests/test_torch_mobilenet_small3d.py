"""Port: MobileNetSmall3D against the JAX package, and the checks that
``test_torch_movinet.py`` shares.

Weights move from the JAX package's ``init`` (with perturbed BatchNorm
statistics) to the port through ``state_dict_from_jax``; inputs come from a
numpy seed and go to both. Everything runs on the CPU, where the port's
bottlenecks take their plain chain. One JAX compile per file: the train
step's ``value_and_grad``, in a module-scoped fixture.

Bounds. Eval logits, f32: 1e-4 of max|logit| (the same f32 chain summed in
another order). bf16: 5% of max|logit| (the two frameworks round in
different places), as for MobileNetLarge3D. The train step's bounds are
those of ``test_torch_train_step.py``: loss 2e-4; each gradient within
1e-3 of its leaf's max|grad| or of a tenth of the model's largest (the
float noise that backpropagation carries through the train-mode
BatchNorms is about absolute); BatchNorm statistics 1e-4.
"""

import contextlib
import json
import math

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from picklebot_tpu import serve as jax_serve
from picklebot_tpu.core.module import DtypePolicy, flatten_dict
from picklebot_tpu.models.mobilenet3d import MobileNetSmall3D as JaxSmall3D
from picklebot_tpu.train.checkpoint import (build_reverse_map,
                                            export_torch_state_dict,
                                            save_pth)
from picklebot_tpu.train.checkpoint import load_pth as jax_load_pth
from picklebot_tpu.train.key_maps import export_rank_for, key_map_for
from picklebot_tpu_torch import cli
from picklebot_tpu_torch import serve as port_serve
from picklebot_tpu_torch.convert import load_pth, state_dict_from_jax
from picklebot_tpu_torch.core.policy import DtypePolicy as TorchPolicy
from picklebot_tpu_torch.models.mobilenet3d import MobileNetSmall3D
from picklebot_tpu_torch.models.registry import initialize_model
from picklebot_tpu_torch.ops import activations as act
from picklebot_tpu_torch.train.optim import AdamW
from picklebot_tpu_torch.train.step import make_train_step
from picklebot_tpu_torch.utils.config import load_config
from test_torch_mobilenet3d import _perturb_batchnorm
from test_torch_train_step import A, B, LR, WD, _jax_step, _no_dropout

NAME = "MobileNetSmall3D"
PARAMETERS = 1_684_091
CLIP = (8, 64, 64, 3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel worker
    processes, and torch's OpenMP threads slow every worker once they
    outnumber the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------------------
# checks shared with test_torch_movinet.py
# --------------------------------------------------------------------------

def port_from_jax(name, v, port):
    port.load_state_dict(state_dict_from_jax(
        flatten_dict(v["params"]), flatten_dict(v["state"]), name),
        strict=True)
    return port


def check_state_dict_equals_jax_export(name, jax_model, port):
    """``state_dict_from_jax`` gives, key for key and bit for bit, what the
    JAX package's own torch export gives, and it loads strictly."""
    v = jax_model.init(0)
    port_keys = port.state_dict().keys()
    want = export_torch_state_dict(
        v, build_reverse_map(port_keys, key_map_for(name)),
        rank_map=export_rank_for(name))
    got = state_dict_from_jax(flatten_dict(v["params"]),
                              flatten_dict(v["state"]), name)
    assert set(got) == set(want) == set(port_keys)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k
    port.load_state_dict(got, strict=True)


def check_eval_logits(name, jax_model, port, rng, bf16):
    v = _perturb_batchnorm(jax_model.init(0), rng)
    port = port_from_jax(name, v, port).eval()
    x = rng.rand(2, *CLIP).astype(np.float32)
    if bf16:
        want, _ = jax_model.apply(v, jnp.asarray(x, jnp.bfloat16),
                                  train=False, policy=DtypePolicy.bf16())
        with torch.inference_mode():
            got = port(torch.from_numpy(x.copy()).bfloat16())
        assert got.dtype == torch.bfloat16
        tol = 0.05
    else:
        want, _ = jax_model.apply(v, jnp.asarray(x), train=False,
                                  policy=DtypePolicy.f32())
        with torch.inference_mode(), TorchPolicy.f32().precision():
            got = port(torch.from_numpy(x.copy()))
        assert got.dtype == torch.float32
        tol = 1e-4
    want = np.asarray(want, np.float32)
    assert got.shape == (2, 13)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())


def train_step_against_jax(name, jax_model, port, seed=1234, clip=CLIP):
    """One f32 train step (A microbatches of B clips of shape ``clip``,
    dropout p = 0) in both packages from the same weights and uint8
    batch; returns the JAX results in the port's keys, the port after its
    step and its metrics."""
    rng = np.random.RandomState(seed)
    v = _perturb_batchnorm(jax_model.init(0), rng)
    port_from_jax(name, v, port)
    _no_dropout(jax_model, port)
    feats = rng.randint(0, 256, (A, B) + clip).astype(np.uint8)
    labels = rng.randint(0, 13, (A, B))
    losses, grads, state, _ = _jax_step(jax_model, v, feats, labels)
    want = {"grads": state_dict_from_jax(flatten_dict(grads), {}, name),
            "state": state_dict_from_jax({}, flatten_dict(state), name),
            "losses": losses}
    metrics = make_train_step(
        port, AdamW(port.parameters(), weight_decay=WD), "CE",
        lambda epoch: LR, TorchPolicy.f32(), device="cpu")(0, feats, labels)
    return want, port, metrics


def check_train_step(want, port, metrics):
    np.testing.assert_allclose(metrics["loss"].numpy(), want["losses"],
                               rtol=2e-4, atol=2e-4)
    grads = dict(port.named_parameters())
    assert set(grads) == set(want["grads"])
    top = max(float(g.abs().max()) for g in want["grads"].values())
    for key, g in want["grads"].items():
        g = g.numpy()
        np.testing.assert_allclose(grads[key].grad.numpy(), g, rtol=0,
                                   atol=1e-3 * max(np.abs(g).max(),
                                                   0.1 * top), err_msg=key)


def check_train_mode_batchnorm_statistics(want, port):
    """The train-mode forwards advanced every BatchNorm as JAX's did."""
    buffers = dict(port.named_buffers())
    stats = [k for k in want["state"] if k.endswith(("running_mean",
                                                     "running_var"))]
    assert stats
    for key in stats:
        np.testing.assert_allclose(buffers[key].numpy(),
                                   want["state"][key].numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=key)
        tracked = key.rsplit(".", 1)[0] + ".num_batches_tracked"
        assert int(buffers[tracked]) == A


def write_config(tmp_path, name, **extra):
    cfg = {"model_name": name, "num_classes": 13, "criterion": "CE",
           "use_autocast": False, "batch_size": 2, "effective_batch_size": 4,
           "max_iters": 1, "video_paths": str(tmp_path),
           "data_backend": "synthetic", "synthetic_len": 10,
           "synthetic_shape": list(CLIP[:3]), "t_bucket": 8, "max_frames": 8,
           "num_workers": 2, "optimizer": "adamw8bit",
           "checkpoint_dir": str(tmp_path / "ck"),
           "log_dir": str(tmp_path / "runs"), **extra}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def check_serve_matches_jax_serve(tmp_path, capsys, name, jax_model, port):
    """Both servers load one ``.pth`` written by the JAX package and
    evaluate the same synthetic CSV on the CPU in f32: equal predictions,
    confidences (rounded to 4 decimals by both) within 2e-4."""
    cfg = write_config(tmp_path, name)
    pth = str(tmp_path / "w.pth")
    save_pth(pth, jax_model.init(0),
             reverse_map=build_reverse_map(port.state_dict().keys(),
                                           key_map_for(name)),
             rank_map=export_rank_for(name))
    args = [cfg, "--checkpoint", pth, "--csv", "x", "--limit", "4",
            "--batch", "2"]

    def lines():
        return [json.loads(l) for l in capsys.readouterr().out.splitlines()
                if l.startswith("{")]
    assert jax_serve.main(args) == 0
    want = lines()
    assert port_serve.main(args + ["--device", "cpu"]) == 0
    got = lines()
    assert len(got) == len(want) == 5
    assert got[-1] == want[-1]
    for g, w in zip(got[:-1], want[:-1]):
        assert (g["clip"], g["pred"], g["label"]) == \
            (w["clip"], w["pred"], w["label"])
        assert abs(g["confidence"] - w["confidence"]) <= 2e-4


def check_cli_trains_and_both_packages_load_the_pth(tmp_path, name,
                                                    jax_model, **extra):
    """``python -m picklebot_tpu_torch.cli cfg.json --device cpu --steps
    2`` on synthetic clips (``extra`` overrides config keys): finite
    losses, and a ``.pth`` that loads strictly into the port and into the
    JAX package. It runs in ``tmp_path``, where it writes its
    ``statistics/``."""
    cfg_path = write_config(tmp_path, name, **extra)
    with contextlib.chdir(tmp_path):
        summary = cli.main([cfg_path, "--device", "cpu", "--steps", "2"])
    assert len(summary["train_losses"]) == 4 and summary["global_step"] == 4
    assert all(math.isfinite(v) for v in summary["train_losses"])
    assert math.isfinite(summary["final_val_loss"])
    assert summary["val_samples"] == 10
    pth = summary["checkpoint"]
    saved = torch.load(pth, weights_only=True)
    port = load_pth(pth, initialize_model(load_config(cfg_path)))
    for key, value in port.state_dict().items():
        assert torch.equal(value, saved[key]), key
    variables = jax_load_pth(pth, jax_model.init(0),
                             key_map=key_map_for(name))
    back = state_dict_from_jax(flatten_dict(variables["params"]),
                               flatten_dict(variables["state"]), name)
    for key, value in back.items():
        if not key.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(value.numpy(), saved[key].numpy(),
                                          err_msg=key)


# --------------------------------------------------------------------------
# MobileNetSmall3D
# --------------------------------------------------------------------------

def test_parameter_count():
    m = MobileNetSmall3D(num_classes=13)
    assert sum(p.numel() for p in m.parameters()) == PARAMETERS


def test_reference_keys_of_the_unrolled_head():
    keys = set(MobileNetSmall3D(13).state_dict())
    assert {"block4.0.weight", "block4.0.bias", "block4.1.se.1.weight",
            "block4.1.se.3.bias", "block4.2.running_mean",
            "block2.0.squeeze_excite.se.1.weight", "classifier.1.weight",
            "classifier.3.bias", "block1.0.weight"} <= keys


def test_bottleneck_geometries():
    """11 bottlenecks, 9 with SE, leaky relu in block2, the expansions
    whose chunking the fused kernels must handle (16, 72, 88 and 120 are
    no multiples of 32)."""
    blocks = list(MobileNetSmall3D(13).bottlenecks())
    assert len(blocks) == 11 and sum(b.use_se for b in blocks) == 9
    assert [b.pointwise_conv1.out_channels for b in blocks] == [
        16, 72, 88, 96, 240, 240, 120, 144, 288, 576, 576]
    assert [b.kernel_size for b in blocks] == [3] * 3 + [5] * 8
    assert all(b.nonlinearity is act.leaky_relu for b in blocks[:3])
    assert all(b.nonlinearity is act.hardswish for b in blocks[3:])


def test_leaky_relu_matches_jax(rng):
    from picklebot_tpu.ops.activations import leaky_relu
    x = rng.randn(64).astype(np.float32)
    np.testing.assert_array_equal(act.leaky_relu(torch.from_numpy(x)).numpy(),
                                  np.asarray(leaky_relu(jnp.asarray(x))))


def test_state_dict_from_jax_equals_jax_export():
    check_state_dict_equals_jax_export(NAME, JaxSmall3D(13),
                                       MobileNetSmall3D(13))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_eval_logits_match_jax(rng, bf16):
    check_eval_logits(NAME, JaxSmall3D(13), MobileNetSmall3D(13), rng, bf16)


@pytest.fixture(scope="module")
def step():
    # The seed matters: hardswish's derivative jumps at +-3, and this
    # model's T-padding quirk repeats one value over many positions of a
    # channel. With seed 1234 a block4 pre-activation lies 1.7e-5 from 3,
    # the two frameworks' f32 BatchNorms put it on different sides, and
    # every gradient below moves by 0.4%. Seed 7 keeps clear of the kinks.
    return train_step_against_jax(NAME, JaxSmall3D(13), MobileNetSmall3D(13),
                                  seed=7)


def test_train_step_loss_and_grads_match_jax(step):
    check_train_step(*step)


def test_train_mode_batchnorm_statistics_match_jax(step):
    check_train_mode_batchnorm_statistics(step[0], step[1])


def test_port_serve_matches_jax_serve(tmp_path, capsys):
    check_serve_matches_jax_serve(tmp_path, capsys, NAME, JaxSmall3D(13),
                                  MobileNetSmall3D(13))


def test_cli_trains_on_cpu_and_both_packages_load_the_pth(tmp_path):
    check_cli_trains_and_both_packages_load_the_pth(tmp_path, NAME,
                                                    JaxSmall3D(13))
