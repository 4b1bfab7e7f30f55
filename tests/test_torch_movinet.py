"""Port: MoViNet-A2 (offline) against the JAX package.

The checks and their bounds are those of
``test_torch_mobilenet_small3d.py``, whose helpers this file shares:
weights from the JAX ``init`` through ``state_dict_from_jax``, inputs from
a numpy seed, everything on the CPU, one JAX compile (the train step's
``value_and_grad``) in a module-scoped fixture.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from picklebot_tpu.core.module import DtypePolicy
from picklebot_tpu.models.movinet import MoViNetA2 as JaxMoViNetA2
from picklebot_tpu.models.movinet import MoviNetBottleneck as JaxBottleneck
from picklebot_tpu_torch.models.mobilevit import MOBILEVIT_CONFIGS
from picklebot_tpu_torch.models.movinet import MoViNetA2, MoviNetBottleneck
from picklebot_tpu_torch.models.registry import PORTED, initialize_model
from picklebot_tpu_torch.ops.conv import Conv3d
from picklebot_tpu_torch.ops.linear import Linear
from picklebot_tpu_torch.utils.config import MODEL_NAMES, Config
from test_torch_mobilenet3d import _perturb_batchnorm
from test_torch_mobilenet_small3d import (
    check_cli_trains_and_both_packages_load_the_pth, check_eval_logits,
    check_serve_matches_jax_serve, check_state_dict_equals_jax_export,
    check_train_mode_batchnorm_statistics, check_train_step, port_from_jax,
    train_step_against_jax)

NAME = "MoViNetA2"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel worker
    processes, and torch's OpenMP threads slow every worker once they
    outnumber the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_parameter_count():
    m = MoViNetA2(num_classes=13)
    assert sum(p.numel() for p in m.parameters()) == 3_992_289


def test_reference_keys_and_stage_table():
    m = MoViNetA2(13)
    keys = set(m.state_dict())
    assert {"block1.0.weight", "block1.1.running_var", "conv.0.weight",
            "conv.1.weight", "classifier.2.weight", "classifier.2.bias",
            "classifier.3.running_mean", "classifier.6.weight",
            "block2.0.expand.weight", "block2.0.conv.weight",
            "block2.0.squeeze_excite.se.3.bias", "block6.6.project.weight",
            "block6.6.batchnorm.bias"} <= keys
    blocks = [b for b in m.modules() if isinstance(b, MoviNetBottleneck)]
    assert len(blocks) == 26
    # every k > 1 conv of the model is depthwise: none takes the dense
    # stride-1 conv kernel
    x = torch.zeros(1, 2, 8, 8, 144)
    for conv in (c for c in m.modules() if isinstance(c, Conv3d)):
        assert conv.groups == conv.in_channels or conv.is_pointwise or \
            conv.in_channels == 3
        assert not conv.takes_folded_kernel(x[..., :conv.in_channels])
    assert sorted({b.conv.kernel_size for b in blocks}) == [
        (1, 3, 3), (1, 5, 5), (3, 3, 3), (5, 3, 3)]


def test_init_bounds_follow_the_reference():
    """kaiming-uniform(fan_in, relu) convs, xavier-uniform linears with
    zero biases: every weight inside its bound and filling most of it."""
    m = MoViNetA2(13, seed=3)
    for mod in m.modules():
        if isinstance(mod, Conv3d):
            bound = (6.0 / mod.fan_in) ** 0.5
        elif isinstance(mod, Linear):
            bound = (6.0 / (mod.in_features + mod.out_features)) ** 0.5
            assert float(mod.bias.detach().abs().max()) == 0.0
        else:
            continue
        top = float(mod.weight.detach().abs().max())
        assert 0.8 * bound < top <= bound
    other = MoViNetA2(13, seed=3)
    assert all(torch.equal(a, b) for a, b in zip(m.parameters(),
                                                 other.parameters()))


@pytest.mark.parametrize("kernel,stride,padding", [
    ((3, 3, 3), (1, 1, 1), (1, 1, 1)), ((5, 3, 3), (1, 2, 2), (2, 1, 1)),
    ((1, 5, 5), (1, 2, 2), (0, 2, 2)), ((1, 3, 3), (1, 1, 1), (0, 1, 1))])
def test_bottleneck_matches_jax(rng, kernel, stride, padding):
    """One block per depthwise kernel of the stage table, BN and
    activation included; f32, 2e-4 as the Bottleneck3D test."""
    jm = JaxBottleneck(8, 16, 24, kernel, stride, padding)
    v = _perturb_batchnorm(jm.init(0), rng)
    port = port_from_jax(NAME, v, MoviNetBottleneck(8, 16, 24, kernel,
                                                    stride, padding)).eval()
    x = rng.rand(2, 5, 12, 12, 8).astype(np.float32)
    want, _ = jm.apply(v, jnp.asarray(x), train=False,
                       policy=DtypePolicy.f32())
    with torch.inference_mode():
        got = port(torch.from_numpy(x.copy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_state_dict_from_jax_equals_jax_export():
    check_state_dict_equals_jax_export(NAME, JaxMoViNetA2(13), MoViNetA2(13))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_eval_logits_match_jax(rng, bf16):
    check_eval_logits(NAME, JaxMoViNetA2(13), MoViNetA2(13), rng, bf16)


@pytest.fixture(scope="module")
def step():
    return train_step_against_jax(NAME, JaxMoViNetA2(13), MoViNetA2(13))


def test_train_step_loss_and_grads_match_jax(step):
    check_train_step(*step)


def test_train_mode_batchnorm_statistics_match_jax(step):
    check_train_mode_batchnorm_statistics(step[0], step[1])


def test_port_serve_matches_jax_serve(tmp_path, capsys):
    check_serve_matches_jax_serve(tmp_path, capsys, NAME, JaxMoViNetA2(13),
                                  MoViNetA2(13))


def test_cli_trains_on_cpu_and_both_packages_load_the_pth(tmp_path):
    check_cli_trains_and_both_packages_load_the_pth(tmp_path, NAME,
                                                    JaxMoViNetA2(13))


def test_registry_builds_the_four_models_and_refuses_the_stream_variant():
    """Kept under its first name: the registry now builds all eight
    models of the JAX package's registry, the stream variant and
    MobileViTV2 among them."""
    assert PORTED == ("MobileNetLarge3D", "MobileNetSmall3D", "MobileViT",
                      "MoViNetA2", "MoViNetA2Stream", "MobileNetLarge2D",
                      "MobileNetSmall2D", "MobileViTV2")
    assert set(PORTED) == set(MODEL_NAMES)
    for name in PORTED:
        extra = MOBILEVIT_CONFIGS["xxs"] if name == "MobileViT" else {}
        model = initialize_model(Config(model_name=name, num_classes=13,
                                        **extra).validate())
        assert type(model).__name__ == name and model.num_classes == 13
