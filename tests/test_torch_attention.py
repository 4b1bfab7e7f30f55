"""Port: LayerNorm and MultiHeadAttention against the JAX package.

Weights move from the JAX package's ``init`` into the port's modules
((I, O) matrices become nn.Linear's (O, I)); inputs are numpy arrays
handed to both, f32. On the CPU the port's kernel backends run their
plain versions, and the JAX side runs its Pallas kernels in interpret
mode. Tolerance 2e-4 (rtol and atol), the bound of the JAX package's own
backend tests (tests/test_mha_packed.py): the same f32 attention summed
in another order.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from picklebot_tpu.core.module import DtypePolicy
from picklebot_tpu.ops import attention as jax_attention
from picklebot_tpu.ops.norm import LayerNorm as JaxLayerNorm
from picklebot_tpu_torch.ops import attention as port_attention
from picklebot_tpu_torch.ops import flash_attention as fa
from picklebot_tpu_torch.ops.linear import dropout_rng
from picklebot_tpu_torch.ops.norm import LayerNorm

TOL = dict(rtol=2e-4, atol=2e-4)


def _jax(module, v, x):
    out, _ = module.apply(v, jnp.asarray(x), policy=DtypePolicy.f32())
    return np.asarray(out)


@pytest.mark.parametrize("affine", [False, True])
def test_layernorm_matches_jax(rng, affine):
    jm = JaxLayerNorm(24, affine=affine)
    v = jm.init(0)
    port = LayerNorm(24, affine=affine)
    if affine:
        scale = rng.uniform(0.5, 1.5, 24).astype(np.float32)
        bias = rng.normal(0, 0.1, 24).astype(np.float32)
        v["params"] = {"scale": jnp.asarray(scale),
                       "bias": jnp.asarray(bias)}
        port.load_state_dict({"weight": torch.from_numpy(scale),
                              "bias": torch.from_numpy(bias)})
    else:
        assert list(port.state_dict()) == []
    x = (rng.randn(3, 5, 24) * 2 + 1).astype(np.float32)
    with torch.inference_mode():
        got = port(torch.from_numpy(x.copy()))
    np.testing.assert_allclose(got.numpy(), _jax(jm, v, x), **TOL)


def _mha_pair(backend, embed=32):
    jm = jax_attention.MultiHeadAttention(embed, heads=8, dim_head=16,
                                          backend=backend)
    v = jm.init(0)
    port = port_attention.MultiHeadAttention(embed, heads=8, dim_head=16,
                                             backend=backend)
    p = v["params"]

    def linear(name):               # JAX (I, O) -> nn.Linear's (O, I)
        return torch.from_numpy(np.array(p[name]["w"]).T.copy())

    port.load_state_dict({"to_qkv.weight": linear("to_qkv"),
                          "to_out.0.weight": linear("to_out")}, strict=True)
    return jm, v, port.eval()


@pytest.mark.parametrize("backend", ["xla", "packed", "pallas",
                                     "pallas_packed"])
def test_mha_matches_jax(rng, backend):
    jm, v, port = _mha_pair(backend)
    x = rng.randn(2, 3, 40, 32).astype(np.float32)
    before = dict(fa.LAUNCHES)
    with torch.inference_mode():
        got = port(torch.from_numpy(x.copy()))
        plain = port(torch.from_numpy(x.copy()), kernels=False)
    assert fa.LAUNCHES == before          # CPU tensors launch no kernel
    np.testing.assert_allclose(got.numpy(), _jax(jm, v, x), **TOL)
    np.testing.assert_allclose(plain.numpy(), got.numpy(), **TOL)


def test_mha_auto_on_both_sides_of_the_threshold(rng, monkeypatch):
    """'auto' takes the head-packed path from _PACKED_MIN_SEQ tokens on,
    in both packages (the threshold patched down in both)."""
    monkeypatch.setattr(jax_attention, "_PACKED_MIN_SEQ", 64)
    monkeypatch.setattr(port_attention, "_PACKED_MIN_SEQ", 64)
    jm, v, port = _mha_pair("auto")
    for n, packed in ((40, False), (96, True)):
        assert port.uses_head_packed(n) == packed
        x = rng.randn(1, 2, n, 32).astype(np.float32)
        with torch.inference_mode():
            got = port(torch.from_numpy(x.copy()))
        np.testing.assert_allclose(got.numpy(), _jax(jm, v, x),
                                   err_msg=f"n={n}", **TOL)


def test_mha_refuses_what_is_not_ported(monkeypatch):
    """An unknown backend is an error; sequence parallelism, ported since,
    builds (the token-sharded path runs only inside a stack that
    scattered the tokens: tests/test_torch_sp.py). Train-mode attention
    dropout runs: on the plain path whatever the backend (the kernels
    have no dropout path), with a graph, and only with a dropout
    generator."""
    assert port_attention.MultiHeadAttention(
        32, sequence_axis="seq").sequence_axis == "seq"
    with pytest.raises(ValueError, match="backend"):
        port_attention.MultiHeadAttention(32, backend="flash")
    m = port_attention.MultiHeadAttention(32, dropout=0.1, backend="packed")
    for mod in m.modules():
        if hasattr(mod, "reset_parameters"):
            mod.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(1, 2, 8, 32)
    with pytest.raises(ValueError, match="dropout_rng"):
        m.train()(x)
    monkeypatch.setattr(port_attention, "flash_attention_packed", None)
    with dropout_rng(torch.Generator().manual_seed(0)):
        out = m(x)
    assert out.grad_fn is not None and torch.isfinite(out).all()
