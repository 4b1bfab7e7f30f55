"""Port: the model summary (``utils/summary.py``) against the JAX
package's: the parameter table row by row for all eight registry models,
the forward FLOPs against a count made from the module shapes and against
XLA's compiled cost, the CLI and the streaming model."""

import json
import math

import pytest
import torch

from picklebot_tpu.core.module import DtypePolicy as JaxPolicy
from picklebot_tpu.models.registry import initialize_model as jax_model
from picklebot_tpu.utils import summary as jax_summary
from picklebot_tpu.utils.config import Config as JaxConfig
from picklebot_tpu_torch.models.mobilevit import MOBILEVIT_CONFIGS
from picklebot_tpu_torch.models.registry import PORTED, initialize_model
from picklebot_tpu_torch.ops.attention import MultiHeadAttention
from picklebot_tpu_torch.ops.conv import Conv2d, Conv3d
from picklebot_tpu_torch.ops.linear import Dense, Linear
from picklebot_tpu_torch.utils import summary as S
from picklebot_tpu_torch.utils.config import Config

# The port counts every tap a convolution multiplies, those that fall on
# its zero padding too; XLA's compiled cost counts only the taps inside
# the input (a 'same' 3x3 conv on 4x4: 12,800 FLOPs against 18,432) and
# adds the elementwise work (BatchNorm, activations, gates, softmax) that
# FlopCounterMode leaves out. At the small shapes below the first wins:
# the port reads 4.4% (Large3D) and 16.3% (MobileViT-xxs, whose late
# stages are 2x2 maps) above the JAX count, 2.0% for Large3D at 224x224.
# So the port's count must lie in [1.0, 1.25] of the JAX one.
JAX_SHARE = (1.0, 1.25)


def _config(name):
    kw = dict(MOBILEVIT_CONFIGS["xxs"]) if name == "MobileViT" else {}
    return dict(model_name=name, num_classes=13, **kw)


@pytest.mark.parametrize("name", PORTED)
def test_param_table_equals_the_jax_table(name):
    cfg = _config(name)
    got = S.param_table(initialize_model(Config(**cfg)), name)
    want = jax_summary.param_table(jax_model(JaxConfig(**cfg)))
    assert got == want


@pytest.mark.parametrize("name,total", [("MobileNetLarge3D", 4_205_675),
                                        ("MobileNetSmall3D", 1_684_091)])
def test_param_totals_are_the_reference_counts(name, total):
    model = initialize_model(Config(model_name=name, num_classes=13))
    rows = S.param_table(model, name)
    assert rows[-1] == ("total", total, 1.0)
    assert S.count_params(model) == total
    assert sum(n for _, n, _ in rows[:-1]) == total


def _flops_from_module_shapes(model, x):
    """2 x the MACs of every conv, dense and linear layer (output
    elements x input channels per group x kernel taps) and of attention's
    two products (2 B H N^2 D), read from each module's weight and the
    activations a forward hook sees."""
    macs = []

    def hook(module, args, out):
        if isinstance(module, MultiHeadAttention):
            n = args[0].shape[-2]
            batch = math.prod(args[0].shape[:-2])
            macs.append(2 * batch * module.heads * n * n * module.dim_head)
        else:
            macs.append(out.numel() * math.prod(module.weight.shape[1:]))
    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (Conv3d, Conv2d, Dense, Linear,
                                 MultiHeadAttention))]
    try:
        with torch.no_grad():
            model(x, kernels=False)
    finally:
        for h in handles:
            h.remove()
    return 2 * sum(macs)


@pytest.mark.parametrize("name,shape", [
    ("MobileNetLarge3D", (2, 4, 32, 32, 3)),
    ("MobileViT", (1, 4, 64, 64, 3))])
def test_flops_equal_the_module_count_and_lie_near_xla(name, shape):
    cfg = _config(name)
    model = initialize_model(Config(**cfg)).eval()
    got = S.cost_summary(model, shape)["flops"]
    x = torch.rand(shape)
    assert got == _flops_from_module_shapes(model, x)
    jax_flops = jax_summary.cost_summary(
        jax_model(JaxConfig(**cfg)), shape, policy=JaxPolicy.f32(),
        model_name=name)["flops"]
    assert JAX_SHARE[0] * jax_flops <= got <= JAX_SHARE[1] * jax_flops, \
        got / jax_flops


def test_train_mode_counts_on_the_cpu_and_leaves_the_model():
    model = initialize_model(Config(model_name="MobileNetSmall3D",
                                    num_classes=13)).eval()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    shape = (2, 4, 32, 32, 3)
    train = S.cost_summary(model, shape, train=True)["flops"]
    assert train == S.cost_summary(model, shape)["flops"] > 1e6
    assert not model.training
    for k, v in model.state_dict().items():
        assert v.device.type == "cpu" and torch.equal(v, before[k]), k


def test_cost_summary_streaming_model():
    """MoViNetA2Stream builds its carry when given none; its per-chunk
    FLOPs are the offline model's plus the causal buffers' frames."""
    stream = initialize_model(Config(model_name="MoViNetA2Stream",
                                     num_classes=13))
    offline = initialize_model(Config(model_name="MoViNetA2",
                                      num_classes=13))
    shape = (1, 4, 32, 32, 3)
    got = S.cost_summary(stream, shape)["flops"]
    assert got >= S.cost_summary(offline, shape)["flops"] > 1e6
    rows = S.param_table(stream, "MoViNetA2Stream")
    assert rows == [("net", 3_992_289, 1.0), ("total", 3_992_289, 1.0)]


def test_summary_cli(tmp_path, capsys):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({
        "model_name": "MobileNetSmall3D", "num_classes": 13,
        "criterion": "CE", "use_autocast": False,
        "batch_size": 1, "effective_batch_size": 1,
        "train_annotations_file": "", "val_annotations_file": "",
        "video_paths": "", "data_backend": "synthetic"}))
    assert S.main([str(cfg), "--frames", "4", "--size", "32",
                   "--batch", "2"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("# MobileNetSmall3D input (2, 4, 32, 32, 3)")
    assert "total" in out and "1,684,091" in out and "GFLOP" in out
    assert S.NO_BYTES in out
    flops = S.cost_summary(initialize_model(Config(
        model_name="MobileNetSmall3D", num_classes=13)),
        (2, 4, 32, 32, 3))["flops"]
    assert f"{flops / 1e9:,.2f} GFLOP ({flops / 2e9:,.2f}/sample" in out


def test_summary_cli_image_model(tmp_path, capsys):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"model_name": "MobileViTV2",
                               "num_classes": 13}))
    assert S.main([str(cfg), "--size", "64"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("# MobileViTV2 input (1, 64, 64, 3)")
