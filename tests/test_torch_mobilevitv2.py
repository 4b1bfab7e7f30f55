"""Port: MobileViTV2 and its ops (``GroupNorm``, ``LinearSelfAttention``,
``MobileViTV2Layer``) against the JAX package.

Weights move from the JAX package's ``init`` (BatchNorm statistics
perturbed) to the port through ``state_dict_from_jax``, or leaf by leaf
for a single op; inputs come from a numpy seed and go to both. Everything
runs on the CPU at 64x64 images (32x32 for the layer).

Bounds. Ops in f32: 1e-5 of max|ref| (the same f32 arithmetic, summed in
another order); GroupNorm in bf16: 2^-7 of max|ref|, one bf16 step at the
top of the range (both packages normalize in f32 and round once). The
layer (a bottleneck, two convs and two transformer layers) in f32: 1e-4
of max|ref|. Model logits: f32 1e-4, bf16 5% of max|logit|, as for the
other models. The train step's bounds are those of
``test_torch_mobilenet_small3d.py``.
"""

import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from picklebot_tpu.core.module import DtypePolicy, flatten_dict
from picklebot_tpu.models.mobilevitv2 import MobileViTV2 as JaxMobileViTV2
from picklebot_tpu.models.mobilevitv2 import \
    MobileViTV2Layer as JaxMobileViTV2Layer
from picklebot_tpu.ops.attention import \
    LinearSelfAttention as JaxLinearSelfAttention
from picklebot_tpu.ops.norm import GroupNorm as JaxGroupNorm
from picklebot_tpu.train.checkpoint import build_reverse_map, save_pth
from picklebot_tpu.train.key_maps import export_rank_for, key_map_for
from picklebot_tpu_torch import cli
from picklebot_tpu_torch.convert import load_pth, state_dict_from_jax
from picklebot_tpu_torch.core.policy import DtypePolicy as TorchPolicy
from picklebot_tpu_torch.models.mobilevitv2 import (MobileViTV2,
                                                    MobileViTV2Layer)
from picklebot_tpu_torch.models.registry import initialize_model
from picklebot_tpu_torch.ops.attention import LinearSelfAttention
from picklebot_tpu_torch.ops.conv import Conv2d
from picklebot_tpu_torch.ops.linear import Dense, Linear
from picklebot_tpu_torch.ops.norm import BatchNorm, GroupNorm
from picklebot_tpu_torch.train.loop import train
from picklebot_tpu_torch.utils.config import Config
from test_torch_mobilenet3d import _perturb_batchnorm
from test_torch_mobilenet_small3d import (
    check_state_dict_equals_jax_export,
    check_train_mode_batchnorm_statistics, check_train_step, port_from_jax,
    train_step_against_jax)

NAME = "MobileViTV2"
PARAMETERS_1000 = 9_223_185
IMAGE = (64, 64, 3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel worker
    processes, and torch's OpenMP threads slow every worker once they
    outnumber the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rel * np.abs(want).max())


def _t(x):
    return torch.from_numpy(np.array(x, np.float32, copy=True))


# --------------------------------------------------------------------------
# ops
# --------------------------------------------------------------------------

@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("groups", [1, 4])
def test_group_norm_matches_jax(rng, groups, bf16):
    jm = JaxGroupNorm(groups, 16)
    v = {"params": {"scale": rng.uniform(0.5, 1.5, 16).astype(np.float32),
                    "bias": rng.normal(0, 0.5, 16).astype(np.float32)},
         "state": {}}
    port = GroupNorm(groups, 16)
    port.load_state_dict({"weight": _t(v["params"]["scale"]),
                          "bias": _t(v["params"]["bias"])}, strict=True)
    x = (rng.randn(3, 5, 7, 16) * 2 + 1).astype(np.float32)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))
    want, _ = jm.apply(v, jnp.asarray(x, jdt))
    with torch.no_grad():
        got = port(_t(x).to(tdt))
    assert got.dtype == tdt and got.shape == want.shape
    _close(got.float().numpy(), np.asarray(want, np.float32),
           2 ** -7 if bf16 else 1e-5)


def test_linear_self_attention_matches_jax(rng):
    """(B, P, N, C) = (2, 4, 9, 8): the softmax over N, the summed
    context, the relu-gated value; the projections' weights in the
    reference's (O, I, 1, 1)."""
    c = 8
    jm = JaxLinearSelfAttention(c)
    v = jm.init(0)
    port = LinearSelfAttention(c)
    p = v["params"]
    with torch.no_grad():
        for name in ("qkv_proj", "out_proj"):
            lin = getattr(port, name)
            lin.weight.copy_(_t(p[name]["w"]).t().reshape(lin.weight.shape))
            lin.bias.copy_(_t(p[name]["b"]))
    assert port.qkv_proj.weight.shape == (1 + 2 * c, c, 1, 1)
    x = rng.randn(2, 4, 9, c).astype(np.float32)
    want, _ = jm.apply(v, jnp.asarray(x), policy=DtypePolicy.f32())
    with torch.no_grad():
        got = port(_t(x))
    assert got.shape == want.shape == (2, 4, 9, c)
    _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("hw", [(10, 10), (8, 8), (10, 12)],
                         ids=["odd", "even", "odd_h_even_w"])
def test_mobilevitv2_layer_matches_jax(rng, hw):
    """A downsampling layer whose conv1x1 output is 7x7 (cropped to 6x6
    for the unfold and padded back after the fold), 6x6 (no crop), or
    7x8 (H only cropped)."""
    jm = JaxMobileViTV2Layer(8, 16, 16, n_attn_blocks=2)
    v = _perturb_batchnorm(jm.init(0), rng)
    port = MobileViTV2Layer(8, 16, 16, n_attn_blocks=2)
    # the model's key rules, under a model-level prefix
    sd = state_dict_from_jax(
        {f"transformer1.{k}": a for k, a in flatten_dict(v["params"]).items()},
        {f"transformer1.{k}": a for k, a in flatten_dict(v["state"]).items()},
        NAME)
    port.load_state_dict({k[len("transformer1."):]: t for k, t in sd.items()},
                         strict=True)
    port.eval()
    x = rng.rand(2, *hw, 8).astype(np.float32)
    want, _ = jm.apply(v, jnp.asarray(x), train=False,
                       policy=DtypePolicy.f32())
    with torch.no_grad():
        got = port(_t(x))
    h, w = (s // 2 + 2 + 2 for s in hw)   # stride 2, then +2 twice
    assert got.shape == want.shape == (2, h, w, 16)
    _close(got.numpy(), want, 1e-4)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

def test_parameter_count_and_reference_keys():
    model = initialize_model(Config(model_name=NAME,
                                    num_classes=1000).validate())
    assert type(model) is MobileViTV2
    assert sum(p.numel() for p in model.parameters()) == PARAMETERS_1000
    keys = set(model.state_dict())
    assert {"conv1.weight", "bn3_5.batchnorm.running_var",
            "transformer1.downsampling_layer.pointwise_conv1.weight",
            "transformer1.convkxk.weight", "transformer1.conv1x1.weight",
            "transformer2.transformer.layer.3.attention.qkv_proj.weight",
            "transformer3.transformer.layer.2.ffn.conv2.bias",
            "transformer3.transformer.layer.0.layernorm_before.weight",
            "transformer3.layernorm.bias",
            "transformer3.conv_projection.weight", "fc.weight",
            "fc.bias"} <= keys
    assert not any(".transformer.0." in k for k in keys)
    assert model.state_dict()["transformer1.convkxk.weight"].shape == (
        256, 256, 3, 3)                       # dense, not depthwise


def test_state_dict_from_jax_equals_jax_export():
    check_state_dict_equals_jax_export(NAME, JaxMobileViTV2(num_classes=13),
                                       MobileViTV2(num_classes=13))


def test_jax_pth_export_loads_strictly(tmp_path):
    """The JAX package's ``save_pth`` writes the port's keys and shapes;
    the port's ``load_pth`` takes it strictly and holds its tensors."""
    port = MobileViTV2(num_classes=13, seed=3)
    v = _perturb_batchnorm(JaxMobileViTV2(num_classes=13).init(0),
                           np.random.RandomState(0))
    path = str(tmp_path / "v2.pth")
    save_pth(path, v, build_reverse_map(port.state_dict().keys(),
                                        key_map_for(NAME)),
             rank_map=export_rank_for(NAME))
    written = torch.load(path, weights_only=True)
    assert {k: tuple(t.shape) for k, t in written.items()} == {
        k: tuple(t.shape) for k, t in port.state_dict().items()}
    load_pth(path, port)
    for k, t in port.state_dict().items():
        assert torch.equal(t, written[k]), k


def test_init_statistics():
    """N(0, 0.02^2) conv and dense weights, zero biases, norms at the
    identity; the same seed gives the same weights."""
    model = MobileViTV2(num_classes=13, seed=11)
    weights, biases = [], []
    for m in model.modules():
        if isinstance(m, (Conv2d, Dense, Linear)):
            weights.append(m.weight.detach().flatten())
            if m.bias is not None:
                biases.append(m.bias.detach())
        elif isinstance(m, (GroupNorm, BatchNorm)):
            assert torch.equal(m.weight, torch.ones_like(m.weight))
            assert not m.bias.any()
    assert len(weights) == 68 and len(biases) == 37
    w = torch.cat(weights)
    assert abs(w.std().item() - 0.02) < 0.05 * 0.02
    assert abs(w.mean().item()) < 1e-4
    for big in (t for t in weights if t.numel() >= 10_000):
        assert abs(big.std().item() - 0.02) < 0.05 * 0.02
    assert not torch.cat(biases).any()
    again = MobileViTV2(num_classes=13, seed=11).state_dict()
    other = MobileViTV2(num_classes=13, seed=12).state_dict()
    for k, t in model.state_dict().items():
        assert torch.equal(t, again[k]), k
    assert not torch.equal(model.fc.weight, other["fc.weight"])


@pytest.fixture(scope="module")
def pair():
    """The JAX model, its variables and the port from them, in eval."""
    jm = JaxMobileViTV2(num_classes=13)
    v = _perturb_batchnorm(jm.init(0), np.random.RandomState(5))
    return jm, v, port_from_jax(NAME, v, MobileViTV2(num_classes=13)).eval()


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_eval_logits_match_jax(rng, pair, bf16):
    jm, v, port = pair
    x = rng.rand(2, *IMAGE).astype(np.float32)
    policy = DtypePolicy.bf16() if bf16 else DtypePolicy.f32()
    dt = jnp.bfloat16 if bf16 else jnp.float32
    want = np.asarray(jax.jit(lambda v, x: jm.apply(
        v, x, train=False, policy=policy)[0])(v, jnp.asarray(x, dt)),
        np.float32)
    xt = _t(x).bfloat16() if bf16 else _t(x)
    with torch.inference_mode(), (TorchPolicy.bf16() if bf16
                                  else TorchPolicy.f32()).precision():
        got = port(xt)
    assert got.dtype == xt.dtype and got.shape == (2, 13)
    _close(got.float().numpy(), want, 0.05 if bf16 else 1e-4)


@pytest.fixture(scope="module")
def step():
    """One f32 train step on (A=2, B=2, 64, 64, 3) uint8 image batches."""
    return train_step_against_jax(NAME, JaxMobileViTV2(num_classes=13),
                                  MobileViTV2(num_classes=13), clip=IMAGE)


def test_train_step_loss_and_grads_match_jax(step):
    check_train_step(*step)


def test_train_mode_batchnorm_statistics_match_jax(step):
    check_train_mode_batchnorm_statistics(step[0], step[1])


@pytest.mark.parametrize("entry", ["train", "cli"])
def test_train_refuses_the_image_classifier(tmp_path, entry):
    """train() and the CLI refuse MobileViTV2 with the JAX loop's
    ValueError, before any data is built (the annotation files do not
    exist)."""
    missing = str(tmp_path / "missing.csv")
    fields = dict(model_name=NAME, num_classes=13,
                  train_annotations_file=missing,
                  val_annotations_file=missing)
    with pytest.raises(ValueError, match="image classifier"):
        if entry == "train":
            train(Config(**fields), device="cpu")
        else:
            path = tmp_path / "cfg.json"
            path.write_text(json.dumps(fields))
            cli.main([str(path), "--device", "cpu"])
