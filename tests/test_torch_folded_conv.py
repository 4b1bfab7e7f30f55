"""Port: the stride-1 dense conv of ``ops/folded_conv.py`` against the JAX
package's ``folded_conv_s1`` (its Pallas kernel in interpret mode, as its
own tests run it on the CPU, with ``wb == W``: no fold) and ``_ref_conv``.

On the CPU the port's wrapper runs its plain version and, under autograd,
``FoldedConvS1Fn`` with the plain version on the flipped weight for dx and
the library's weight gradient for dw: the same route as on the card with
the kernel swapped for its plain version. Inputs come from a numpy seed
and go to both packages. Tolerances are the JAX test's own: f32 2e-4
(sums in another order), bf16 3e-2, gradients 5e-4.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from picklebot_tpu.ops.pallas import folded_conv as jax_fc
from picklebot_tpu_torch.models.mobilevit import MobileViTBlock
from picklebot_tpu_torch.ops import folded_conv as fc
from picklebot_tpu_torch.ops.conv import Conv3d

# the four geometries of tests/test_folded_conv_kernel.py, then widths that
# are no multiple of the kernel's tile (MobileViT-xxs's 48 and 80) and a
# conv4-like Ci = 2 * Co
GEOMETRIES = [
    ((1, 4, 6, 5, 32), 48, (3, 3, 3)),
    ((2, 3, 4, 4, 64), 32, (1, 3, 3)),
    ((1, 5, 4, 3, 32), 32, (3, 3, 1)),
    ((1, 3, 5, 4, 32), 32, (1, 5, 3)),
    ((1, 3, 5, 5, 48), 80, (3, 3, 3)),
    ((1, 2, 4, 4, 96), 48, (3, 3, 3)),
]


def _pads(k):
    return tuple(((n - 1) // 2,) * 2 for n in k)


def _case(rng, shape, co, k):
    x = rng.randn(*shape).astype(np.float32)
    w = (rng.randn(*k, shape[-1], co) * 0.1).astype(np.float32)
    return x, w, _pads(k)


@pytest.mark.parametrize("shape,co,k", GEOMETRIES)
def test_folded_conv_s1_matches_jax_f32(rng, shape, co, k):
    x, w, pads = _case(rng, shape, co, k)
    assert fc.folded_conv_s1_eligible(x.shape, w.shape, (1, 1, 1), pads)
    got = fc.folded_conv_s1(torch.from_numpy(x.copy()),
                            torch.from_numpy(w.copy()), pads).numpy()
    kernel = jax_fc.folded_conv_s1(jnp.asarray(x), jnp.asarray(w), pads,
                                   shape[3])
    ref = jax_fc._ref_conv(jnp.asarray(x), jnp.asarray(w), pads)
    assert got.shape == shape[:-1] + (co,)
    np.testing.assert_allclose(got, np.asarray(kernel), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("shape,co,k", [GEOMETRIES[0], GEOMETRIES[4]])
def test_folded_conv_s1_matches_jax_bf16(rng, shape, co, k):
    x, w, pads = _case(rng, shape, co, k)
    got = fc.folded_conv_s1(torch.from_numpy(x.copy()).bfloat16(),
                            torch.from_numpy(w.copy()).bfloat16(), pads)
    assert got.dtype == torch.bfloat16
    want = jax_fc.folded_conv_s1(jnp.asarray(x, jnp.bfloat16),
                                 jnp.asarray(w, jnp.bfloat16), pads, shape[3])
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=3e-2,
                               atol=3e-2)


@pytest.mark.parametrize("shape,co,k", [GEOMETRIES[0], GEOMETRIES[3],
                                        GEOMETRIES[5]])
def test_function_gradients_match_jax_grad(rng, shape, co, k):
    """dx (the conv on the flipped, swapped weight) and dw (the library's
    weight gradient) of ``FoldedConvS1Fn`` against ``jax.grad`` through
    the JAX ``folded_conv_s1`` (dx: its kernel; dw: XLA's conv VJP)."""
    x, w, pads = _case(rng, shape, co, k)
    xt = torch.from_numpy(x.copy()).requires_grad_()
    wt = torch.from_numpy(w.copy()).requires_grad_()
    calls = []
    apply = fc.FoldedConvS1Fn.apply
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fc.FoldedConvS1Fn, "apply",
                   lambda *a: calls.append(1) or apply(*a))
        fc.folded_conv_s1(xt, wt, pads).pow(2).sum().backward()
    assert calls == [1]

    def loss(x, w):
        return jnp.sum(jax_fc.folded_conv_s1(x, w, pads, shape[3]) ** 2)

    dx, dw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx), rtol=5e-4,
                               atol=5e-4)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(dw), rtol=5e-4,
                               atol=5e-4)


def test_function_takes_a_non_contiguous_cotangent_and_skips_unneeded(rng):
    x, w, pads = _case(rng, *GEOMETRIES[1])
    xt = torch.from_numpy(x.copy()).requires_grad_()
    wt = torch.from_numpy(w.copy())
    out = fc.folded_conv_s1(xt, wt, pads)
    g = torch.from_numpy(rng.randn(*out.shape[::-1]).astype(np.float32)
                         ).permute(4, 3, 2, 1, 0)
    assert not g.is_contiguous()
    dx, = torch.autograd.grad(out, xt, g)
    ref = torch.from_numpy(x.copy()).requires_grad_()
    want, = torch.autograd.grad(fc.folded_conv_reference(ref, wt, pads), ref,
                                g)
    np.testing.assert_allclose(dx.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert wt.grad is None


_W = (3, 3, 3, 64, 160)
PREDICATE_CASES = [
    ((1, 2, 4, 4, 64), _W, (1, 1, 1), _pads((3, 3, 3))),
    ((1, 2, 4, 4, 64), _W, (1, 2, 1), _pads((3, 3, 3))),           # strided
    ((1, 2, 4, 4, 64), _W, (1, 1, 1), ((2, 0), (1, 1), (1, 1))),  # causal
    ((1, 2, 4, 4, 64), _W, (1, 1, 1), ((1, 1), (0, 0), (1, 1))),  # valid H
    ((1, 2, 4, 4, 16), (3, 3, 3, 16, 160), (1, 1, 1), _pads((3, 3, 3))),
    ((1, 2, 4, 4, 64), (3, 3, 3, 64, 16), (1, 1, 1), _pads((3, 3, 3))),
    ((1, 2, 4, 4, 32), (1, 3, 3, 32, 32), (1, 1, 1), _pads((1, 3, 3))),
    ((1, 2, 4, 4, 32), (1, 3, 3, 32, 32), (1, 1, 1),
     ((1, 1), (1, 1), (1, 1))),                                # kt=1, padded
    ((1, 2, 4, 4, 32), (1, 5, 3, 32, 32), (1, 1, 1), _pads((1, 5, 3))),
    ((1, 2, 4, 4, 32), (1, 1, 1, 32, 32), (1, 1, 1), _pads((1, 1, 1))),
]


@pytest.mark.parametrize("x_shape,w_shape,strides,pads", PREDICATE_CASES)
def test_predicate_matches_jax(x_shape, w_shape, strides, pads):
    assert fc.folded_conv_s1_eligible(x_shape, w_shape, strides, pads) == \
        jax_fc.folded_conv_s1_eligible(x_shape, w_shape, strides, pads)


def test_predicate_refuses_the_even_kernel_the_jax_one_admits(rng):
    """An even kernel size with pads ((k-1)//2,)*2: the JAX predicate says
    yes, its kernel then keeps the input's dims while a conv with those
    pads (``_ref_conv``) loses one. The port's predicate says no."""
    x_shape, w_shape = (1, 3, 4, 4, 32), (1, 2, 3, 32, 32)
    pads = _pads((1, 2, 3))
    assert jax_fc.folded_conv_s1_eligible(x_shape, w_shape, (1, 1, 1), pads)
    assert not fc.folded_conv_s1_eligible(x_shape, w_shape, (1, 1, 1), pads)
    x = jnp.asarray(rng.randn(*x_shape).astype(np.float32))
    w = jnp.asarray(rng.randn(*w_shape).astype(np.float32))
    assert jax_fc.folded_conv_s1(x, w, pads, 4).shape == (1, 3, 4, 4, 32)
    assert jax_fc._ref_conv(x, w, pads).shape == (1, 3, 3, 4, 32)
    with pytest.raises(ValueError, match="do not keep the dims"):
        fc.folded_conv_s1(torch.zeros(x_shape), torch.zeros(w_shape), pads)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x, w = torch.zeros(1, 2, 4, 4, 32), torch.zeros(3, 3, 3, 32, 32)
    pads = _pads((3, 3, 3))
    with pytest.raises(TypeError, match="w is"):
        fc.folded_conv_s1(x, w.bfloat16(), pads)
    with pytest.raises(ValueError, match="input channels"):
        fc.folded_conv_s1(x[..., :16], w, pads)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fc.folded_conv_s1(x.to("meta"), w.to("meta"), pads)


def test_cuda_route_is_not_reached_quietly():
    """On a CUDA tensor the wrapper launches the kernel or raises: with no
    card the tensor cannot exist, and the count of launches stays 0 through
    every CPU call above."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the check is for one without")
    with pytest.raises((RuntimeError, AssertionError)):
        torch.zeros(1, 2, 4, 4, 32, device="cuda")
    x, w = torch.zeros(1, 2, 4, 4, 32), torch.zeros(3, 3, 3, 32, 32)
    before = dict(fc.LAUNCHES)
    fc.folded_conv_s1(x, w, _pads((3, 3, 3)))
    assert fc.LAUNCHES == before == {"fwd": 0, "dx": 0}


def test_conv3d_dispatch_and_plain_path(rng):
    """``Conv3d`` marks MobileViT's dense stride-1 3x3x3 convs for the
    kernel and no other conv; on the CPU both values of ``kernels`` run
    ``F.conv3d`` and agree with the wrapper's plain version."""
    x = torch.from_numpy(rng.randn(1, 3, 5, 5, 32).astype(np.float32))
    dense = Conv3d(32, 48, 3, padding=1, bias=False)
    dense.reset_parameters(torch.Generator().manual_seed(0))
    assert dense.takes_folded_kernel(x)
    for other in (Conv3d(32, 48, 3, stride=2, padding=1),
                  Conv3d(32, 32, 3, padding=1, groups=32),
                  Conv3d(32, 48, 1), Conv3d(32, 48, 3, padding=0),
                  Conv3d(32, 16, 3, padding=1),
                  Conv3d(32, 48, (2, 3, 3), padding=(0, 1, 1))):
        assert not other.takes_folded_kernel(x)
    assert not Conv3d(3, 48, 3, padding=1).takes_folded_kernel(x[..., :3])
    with torch.no_grad():
        a, b = dense(x, kernels=True), dense(x, kernels=False)
        want = fc.folded_conv_reference(
            x, dense.weight.permute(2, 3, 4, 1, 0).contiguous(),
            _pads((3, 3, 3)))
    assert torch.equal(a, b)
    np.testing.assert_allclose(a.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


def test_mobilevit_block_keeps_its_keys_and_marks_conv1_conv4():
    block = MobileViTBlock(64, 2, 48, ffw_dim=128)
    keys = set(block.state_dict())
    assert {"conv1.0.weight", "conv1.1.running_mean", "conv1.1.running_var",
            "conv4.0.weight", "conv4.1.num_batches_tracked",
            "conv2.0.weight", "conv3.0.weight"} <= keys
    x = torch.zeros(1, 2, 4, 4, 48)
    assert block.conv1[0].takes_folded_kernel(x)
    assert block.conv4[0].takes_folded_kernel(torch.zeros(1, 2, 4, 4, 96))
    assert not block.conv2[0].takes_folded_kernel(x)
