"""Port: MobileNetLarge3D and its Bottleneck3D against the JAX package.

Weights move from the JAX package's ``init`` to the port through
``state_dict_from_jax``; inputs are numpy arrays handed to both. Both run
in eval mode on the CPU (the port's bottlenecks take their plain chain
there).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from picklebot_tpu.core.module import DtypePolicy, flatten_dict
from picklebot_tpu.models.mobilenet3d import MobileNetLarge3D as JaxLarge3D
from picklebot_tpu.ops.bottleneck import Bottleneck3D as JaxBottleneck3D
from picklebot_tpu.train.checkpoint import (build_reverse_map,
                                            export_torch_state_dict)
from picklebot_tpu.train.key_maps import export_rank_for, key_map_for
from picklebot_tpu_torch.convert import state_dict_from_jax
from picklebot_tpu_torch.core.policy import DtypePolicy as TorchPolicy
from picklebot_tpu_torch.models.mobilenet3d import MobileNetLarge3D
from picklebot_tpu_torch.ops import activations as act
from picklebot_tpu_torch.ops.bottleneck import Bottleneck3D
from picklebot_tpu_torch.ops.linear import dropout_rng
from picklebot_tpu_torch.ops.norm import BatchNorm
from picklebot_tpu_torch.train.loop import check_ported
from picklebot_tpu_torch.utils.config import Config

NAME = "MobileNetLarge3D"
# f32: the same chain of f32 convs and matmuls, summed in another order
# by XLA and by torch; the bound the JAX package's export test uses.
F32_TOL = dict(rtol=5e-4, atol=5e-4)


def _perturb_batchnorm(v, rng):
    """Non-trivial BN statistics and affine terms, so that eval-mode BN
    folding is exercised (init leaves them at the identity)."""
    for path, leaf in flatten_dict(v["state"]).items():
        node = v["state"]
        for part in path.split(".")[:-1]:
            node = node[part]
        key = path.rsplit(".", 1)[-1]
        n = leaf.shape[0]
        node[key] = (rng.uniform(0.5, 1.5, n) if key == "var"
                     else rng.normal(0, 0.1, n)).astype(np.float32)
    return v


def _port_from_jax(v, model):
    sd = state_dict_from_jax(flatten_dict(v["params"]),
                             flatten_dict(v["state"]), NAME)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def test_parameter_count():
    m = MobileNetLarge3D(num_classes=13)
    assert sum(p.numel() for p in m.parameters()) == 4_205_675


def test_state_dict_from_jax_equals_jax_export():
    v = JaxLarge3D(13).init(0)
    port_keys = MobileNetLarge3D(13).state_dict().keys()
    want = export_torch_state_dict(
        v, build_reverse_map(port_keys, key_map_for(NAME)),
        rank_map=export_rank_for(NAME))
    got = state_dict_from_jax(flatten_dict(v["params"]),
                              flatten_dict(v["state"]), NAME)
    assert set(got) == set(want) == set(port_keys)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


def test_state_dict_from_jax_copies_buffers():
    v = JaxLarge3D(13).init(0)
    flat = flatten_dict(v["params"])
    sd = state_dict_from_jax(flat, flatten_dict(v["state"]), NAME)
    before = flat["fc2.b"].copy()
    sd["classifier.3.bias"].add_(1.0)
    np.testing.assert_array_equal(flat["fc2.b"], before)


def _jax_and_port(rng):
    v = _perturb_batchnorm(JaxLarge3D(13).init(0), rng)
    return JaxLarge3D(13), v, _port_from_jax(v, MobileNetLarge3D(13))


def test_eval_logits_match_jax_f32(rng):
    jm, v, port = _jax_and_port(rng)
    x = rng.rand(2, 8, 64, 64, 3).astype(np.float32)
    want, _ = jm.apply(v, jnp.asarray(x), train=False,
                       policy=DtypePolicy.f32())
    with torch.inference_mode(), TorchPolicy.f32().precision():
        got = port(torch.from_numpy(x.copy()))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_eval_logits_match_jax_bf16(rng):
    """bf16 policy: both frameworks round activations to bf16 at each op,
    in places that differ (XLA fuses elementwise chains in f32), so the
    bound is loose: 5% of the logits' range, absolute."""
    jm, v, port = _jax_and_port(rng)
    x = rng.rand(2, 8, 64, 64, 3).astype(np.float32)
    want, _ = jm.apply(v, jnp.asarray(x, jnp.bfloat16), train=False,
                       policy=DtypePolicy.bf16())
    want = np.asarray(want, np.float32)
    with torch.inference_mode():
        got = port(torch.from_numpy(x.copy()).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=0.05 * np.abs(want).max())


@pytest.mark.parametrize("k,s,use_se", [(3, 1, False), (3, 2, False),
                                        (5, 1, True), (5, 2, True)])
def test_bottleneck_matches_jax(rng, k, s, use_se):
    """The module that holds the kernel, BN and activation included, on
    its CPU path (the plain chain of modules)."""
    jm = JaxBottleneck3D(8, 16, 24, stride=s, use_se=use_se, kernel_size=k)
    v = _perturb_batchnorm(jm.init(0), rng)
    port = Bottleneck3D(8, 16, 24, stride=s, use_se=use_se, kernel_size=k,
                        nonlinearity=act.hardswish)
    port = _port_from_jax(v, port)
    x = rng.rand(2, 5, 16, 16, 8).astype(np.float32)
    want, _ = jm.apply(v, jnp.asarray(x), train=False,
                       policy=DtypePolicy.f32())
    with torch.inference_mode():
        got = port(torch.from_numpy(x.copy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_train_mode_is_refused():
    """Train mode runs: with a dropout generator the forward advances
    every BatchNorm's statistics and keeps a graph that reaches every
    parameter; without one the channel dropout refuses. A trainer option
    not ported yet names ROADMAP.md."""
    m = MobileNetLarge3D(13).train()
    x = torch.rand(1, 2, 32, 32, 3)
    with pytest.raises(ValueError, match="dropout_rng"):
        m(x)
    for b in m.modules():
        if isinstance(b, BatchNorm):
            b.num_batches_tracked.zero_()
    with dropout_rng(torch.Generator().manual_seed(0)):
        out = m(x)
    assert out.grad_fn is not None
    assert all(int(b.num_batches_tracked) == 1 for b in m.modules()
               if isinstance(b, BatchNorm))
    out.pow(2).sum().backward()
    assert all(p.grad is not None for p in m.parameters())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        check_ported(Config(checkpoint="an/orbax/step_3"))
