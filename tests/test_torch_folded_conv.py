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


# MobileViT-s's conv1/conv4 at bs 8 and 32x224x224 (chip_smoke.py
# VIT_CONV_STAGES): (M = B*T*H*W, Ci, Co) of the forward; dx swaps Ci, Co
VIT_S_CONVS = [(8 * 8 * 28 * 28, 96, 96), (8 * 8 * 28 * 28, 192, 96),
               (8 * 5 * 14 * 14, 128, 128), (8 * 5 * 14 * 14, 256, 128),
               (8 * 4 * 7 * 7, 160, 160), (8 * 4 * 7 * 7, 320, 160)]


@pytest.mark.parametrize("which", ["fwd", "dx"])
@pytest.mark.parametrize("m,ci,co", VIT_S_CONVS)
def test_plan_fills_the_card_at_mobilevit_s_shapes(m, ci, co, which):
    """At each of the 12 launches of a MobileViT-s train microbatch the
    plan gives at least one block per SM (132), or splits as far as it may
    (one range per tap); it splits only a grid under two blocks per SM;
    its workspace holds the f32 partials of its splits."""
    n, taps = (co if which == "fwd" else ci), 27
    plan = fc._plan(m, n, taps)
    assert plan.tile_n in (64, 96)
    # the N tile that computes the fewest columns past Co, the wider on a
    # tie (Co 192: two tiles of 96, not three of 64)
    padded = {t: -(-n // t) * t for t in (64, 96)}
    assert padded[plan.tile_n] == min(padded.values())
    assert plan.tile_n == 96 or padded[64] < padded[96]
    base = -(-m // 128) * -(-n // plan.tile_n)
    assert plan.blocks == base * plan.splits
    assert plan.blocks >= 132 or plan.splits == taps
    assert 1 <= plan.splits <= taps
    assert (plan.splits == 1) == (base >= 2 * 132)
    assert plan.workspace == (plan.splits * m * n if plan.splits > 1 else 0)
    # stage 1 runs unsplit, stages 2 and 3 split (chip_smoke.py checks both
    # kinds on the card)
    assert (plan.splits == 1) == (m == 8 * 8 * 28 * 28)


@pytest.mark.parametrize("taps,splits", [(27, 1), (27, 3), (27, 7), (9, 4),
                                         (15, 15), (1, 1)])
def test_tap_ranges_cover_the_taps_in_order(taps, splits):
    ranges = fc.tap_ranges(taps, splits)
    assert len(ranges) == splits and ranges[0][0] == 0
    assert ranges[-1][1] == taps
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("shape,co,k,splits", [
    (GEOMETRIES[0][0], GEOMETRIES[0][1], GEOMETRIES[0][2], 3),
    (GEOMETRIES[4][0], GEOMETRIES[4][1], GEOMETRIES[4][2], 7),
    (GEOMETRIES[5][0], GEOMETRIES[5][1], GEOMETRIES[5][2], 27),
    (GEOMETRIES[1][0], GEOMETRIES[1][1], GEOMETRIES[1][2], 4),
    (GEOMETRIES[3][0], GEOMETRIES[3][1], GEOMETRIES[3][2], 15)])
def test_split_plain_model_matches_jax_ref_conv(rng, shape, co, k, splits):
    """The split path's order in plain PyTorch (partial convs over tap
    ranges, summed in f32 in range order, rounded once) against the JAX
    ``_ref_conv``: f32 within 1e-5 of max|ref|; bf16 operands within one
    bf16 ulp of the output's range of ``_ref_conv`` on the same rounded
    operands in f32 (the split rounds once, at most half an ulp)."""
    x, w, pads = _case(rng, shape, co, k)
    ref = np.asarray(jax_fc._ref_conv(jnp.asarray(x), jnp.asarray(w), pads))
    got = fc.folded_conv_split_reference(torch.from_numpy(x.copy()),
                                         torch.from_numpy(w.copy()), pads,
                                         splits)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())

    xb = torch.from_numpy(x.copy()).bfloat16()
    wb = torch.from_numpy(w.copy()).bfloat16()
    ref = np.asarray(jax_fc._ref_conv(jnp.asarray(xb.float().numpy()),
                                      jnp.asarray(wb.float().numpy()), pads))
    got = fc.folded_conv_split_reference(xb, wb, pads, splits)
    assert got.dtype == torch.bfloat16
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=ulp)
