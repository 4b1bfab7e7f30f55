"""Port: MobileViT against the JAX package.

Weights move from the JAX package's ``init`` (with perturbed BatchNorm
statistics) to the port through ``state_dict_from_jax``; inputs are numpy
arrays handed to both. Both run in eval mode on the CPU at xxs widths on a
(2, 8, 64, 64, 3) clip, where the three stages see 48, 8 and 2 tokens. The
port's kernels take their plain versions there; with the 'packed' backend
the JAX side runs its Pallas kernel (interpret mode) in every layer.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from picklebot_tpu.core.module import DtypePolicy, flatten_dict
from picklebot_tpu.models.mobilevit import MobileViT as JaxMobileViT
from picklebot_tpu.train.checkpoint import (build_reverse_map,
                                            export_torch_state_dict)
from picklebot_tpu.train.key_maps import export_rank_for, key_map_for
from picklebot_tpu_torch.convert import state_dict_from_jax
from picklebot_tpu_torch.core.policy import DtypePolicy as TorchPolicy
from picklebot_tpu_torch.models.mobilevit import MOBILEVIT_CONFIGS, MobileViT
from picklebot_tpu_torch.ops import flash_attention as fa
from test_torch_mobilenet3d import _perturb_batchnorm

NAME = "MobileViT"
XXS = MOBILEVIT_CONFIGS["xxs"]
# f32: the same chain of f32 convs, matmuls and softmaxes, summed in
# another order by XLA and by torch; the bound the JAX package's export
# test uses for this model.
F32_TOL = dict(rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("size,nparams", [
    ("xxs", 2_030_368), ("xs", 3_483_984), ("s", 8_453_136)])
def test_parameter_count(size, nparams):
    m = MobileViT(num_classes=13, **MOBILEVIT_CONFIGS[size])
    assert sum(p.numel() for p in m.parameters()) == nparams


def test_state_dict_from_jax_equals_jax_export():
    v = JaxMobileViT(num_classes=13, **XXS).init(0)
    port_keys = MobileViT(num_classes=13, **XXS).state_dict().keys()
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


def test_init_is_normal_002_with_zero_biases():
    m = MobileViT(num_classes=13, **XXS)
    w = torch.cat([p.flatten() for n, p in m.named_parameters()
                   if n.endswith("weight") and p.dim() >= 2])
    assert abs(w.std().item() - 0.02) < 1e-3
    assert abs(w.mean().item()) < 1e-3
    again = MobileViT(num_classes=13, **XXS)
    assert all(torch.equal(a, b) for a, b in
               zip(m.state_dict().values(), again.state_dict().values()))


def _jax_and_port(rng, backend):
    jm = JaxMobileViT(num_classes=13, attention_backend=backend, **XXS)
    v = _perturb_batchnorm(jm.init(0), rng)
    port = MobileViT(num_classes=13, attention_backend=backend, **XXS)
    port.load_state_dict(state_dict_from_jax(
        flatten_dict(v["params"]), flatten_dict(v["state"]), NAME),
        strict=True)
    return jm, v, port.eval()


@pytest.mark.parametrize("backend", ["auto", "packed"])
def test_eval_logits_match_jax_f32(rng, backend):
    jm, v, port = _jax_and_port(rng, backend)
    x = rng.rand(2, 8, 64, 64, 3).astype(np.float32)
    want, _ = jm.apply(v, jnp.asarray(x), train=False,
                       policy=DtypePolicy.f32())
    before = dict(fa.LAUNCHES)
    with torch.inference_mode(), TorchPolicy.f32().precision():
        got = port(torch.from_numpy(x.copy()))
    assert fa.LAUNCHES == before          # CPU tensors launch no kernel
    assert got.shape == (2, 13) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_eval_logits_match_jax_bf16(rng):
    """bf16 policy: both frameworks round activations to bf16 at each op,
    in places that differ, so the bound is loose: 5% of the logits'
    range, absolute."""
    jm, v, port = _jax_and_port(rng, "xla")
    x = rng.rand(2, 8, 64, 64, 3).astype(np.float32)
    want, _ = jm.apply(v, jnp.asarray(x, jnp.bfloat16), train=False,
                       policy=DtypePolicy.bf16())
    want = np.asarray(want, np.float32)
    with torch.inference_mode():
        got = port(torch.from_numpy(x.copy()).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=0.05 * np.abs(want).max())


def test_train_mode_is_refused():
    m = MobileViT(num_classes=13, **XXS).train()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        m(torch.zeros(1, 4, 32, 32, 3))
