"""Port: the fused bottleneck's plain version against the JAX kernel.

The JAX side runs the Pallas kernel in interpret mode on the CPU, as
tests/test_fused_bottleneck.py does; the port's wrappers take their plain
PyTorch version for CPU tensors. Same numpy inputs into both, f32.
Tolerance 2e-4 (rtol and atol): the same f32 chain summed in another
order (XLA's interpreted kernel vs. torch's matmul and conv), the bound
the JAX package's own kernel-vs-module test uses. Also the kernels' plans
(``_pool_plan``, ``_main_plan``) at every geometry of the three models
that run them, the plain versions of the split kernels' order
(``pool_split_reference``, ``main_split_reference``) against the Pallas
kernel in f32 and bf16, and the bf16 plain version against it.
"""

import os
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from picklebot_tpu.ops.pallas.fused_bottleneck import fused_bottleneck
from picklebot_tpu_torch.ops import fused_bottleneck as fb

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402  (its geometry lists; imports no torch)

TOL = dict(rtol=2e-4, atol=2e-4)


def _inputs(rng, c=8, e=24, co=16, k=3, shape=(2, 5, 16, 16)):
    x = rng.rand(*shape, c).astype(np.float32)
    r = e // 4
    w = dict(w1=rng.randn(c, e), wd=rng.randn(k, k, e), w2=rng.randn(e, co),
             se_w1=rng.randn(e, r), se_b1=rng.randn(r),
             se_w2=rng.randn(r, e), se_b2=rng.randn(e))
    return x, {n: (v * 0.1).astype(np.float32) for n, v in w.items()}


def _jax(x, w, k, s, use_se):
    c, e = w["w1"].shape
    out = fused_bottleneck(
        jnp.asarray(x), jnp.asarray(w["w1"].reshape(1, 1, 1, c, e)),
        jnp.asarray(w["wd"].reshape(1, k, k, 1, e)),
        jnp.asarray(w["w2"].reshape(1, 1, 1, e, -1)),
        *(jnp.asarray(w[n]) for n in ("se_w1", "se_b1", "se_w2", "se_b2")),
        k, s, use_se, 8)
    return np.asarray(out)


def _torch(w):
    return {n: torch.from_numpy(v.copy()) for n, v in w.items()}


@pytest.mark.parametrize("k,s,use_se", [
    (3, 1, False), (3, 2, False), (5, 2, False),
    (3, 1, True), (5, 1, True), (5, 2, True),
])
def test_plain_version_matches_jax_kernel(rng, k, s, use_se):
    x, w = _inputs(rng, k=k)
    want = _jax(x, w, k, s, use_se)
    before = dict(fb.LAUNCHES)
    t = _torch(w)
    got = fb.fused_bottleneck(torch.from_numpy(x.copy()), t["w1"], t["wd"],
                              t["w2"], t["se_w1"], t["se_b1"], t["se_w2"],
                              t["se_b2"], k, s, use_se)
    assert fb.LAUNCHES == before      # a CPU tensor launches no kernel
    assert tuple(got.shape) == want.shape
    assert tuple(got.shape[1:4]) == fb.out_shape(5, 16, 16, k, s)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("k,s", [(3, 1), (5, 2)])
def test_pool_and_main_passes_compose(rng, k, s):
    """The two wrappers the kernels replace, composed by hand with the SE
    MLP, equal the whole plain chain (the CUDA path's structure)."""
    x, w = _inputs(rng, k=k)
    t = _torch(w)
    xt = torch.from_numpy(x)
    to, ho, wo = fb.out_shape(5, 16, 16, k, s)
    pooled = fb.fused_pool(xt, t["w1"], t["wd"], k, s)
    scale = fb.se_scale(pooled / (to * ho * wo), t["se_w1"], t["se_b1"],
                        t["se_w2"], t["se_b2"], torch.float32)
    got = fb.fused_main(xt, t["w1"], t["wd"], t["w2"], scale, k, s)
    want = fb.fused_bottleneck_reference(
        xt, t["w1"], t["wd"], t["w2"], t["se_w1"], t["se_b1"], t["se_w2"],
        t["se_b2"], k, s, True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_kernel_wrappers_refuse_bad_inputs(rng):
    """A tensor that is neither on the CPU nor on CUDA raises before any
    build or launch: no quiet fallback to the plain version."""
    x, w = _inputs(rng)
    t = _torch(w)
    meta = torch.empty((2, 5, 16, 16, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fb._check(meta, t["w1"], t["wd"], 3)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fb.fused_main(meta, t["w1"], t["wd"], t["w2"],
                      torch.ones(2, 24), 3, 1)


# --------------------------------------------------------------------------
# the kernels' plans
# --------------------------------------------------------------------------

# (name, (B, T, H, W, C), k, s, SE, E, Co): the 33 bottleneck geometries of
# MobileNetLarge3D, MobileViT-s and MobileNetSmall3D at bs 8 and a
# 32x224x224 clip, as chip_smoke.py runs them on the card
GEOMETRIES = [(f"{m} {i}", *g) for m, gl in (
    ("Large3D", chip_smoke.GEOMETRIES), ("MobileViT-s",
                                         chip_smoke.VIT_GEOMETRIES),
    ("Small3D", chip_smoke.SMALL_GEOMETRIES)) for i, g in enumerate(gl)]
SMS, SMEM, GRID = 132, 227 * 1024, 2 ** 31 - 1


def _tiles_of(plan, shape, k, s):
    _, ho, wo = fb.out_shape(*shape[1:4], k, s)
    assert 1 <= plan.th <= ho and 1 <= plan.tw <= wo
    return -(-ho // plan.th) * -(-wo // plan.tw)


def _holds(plan, base, most):
    """A plan's split rule: no split where the unsplit grid gives every SM
    two blocks; else two blocks per SM, or as many ranges as allowed."""
    assert plan.smem <= SMEM and plan.chunk == 32
    assert plan.blocks == base * plan.splits < GRID
    assert 1 <= plan.splits <= max(1, most)
    if base >= 2 * SMS:
        assert plan.splits == 1
    else:
        assert plan.blocks >= 2 * SMS or plan.splits == most


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name,shape,k,s,se,e,co", GEOMETRIES,
                         ids=[g[0] for g in GEOMETRIES])
def test_plans_fill_the_card_and_fit(name, shape, k, s, se, e, co, dtype):
    b, t = shape[:2]
    to = fb.out_shape(*shape[1:4], k, s)[0]
    chunks = -(-e // 32)
    main = fb._main_plan(shape, k, s, e, co, dtype)
    tiles = _tiles_of(main, shape, k, s)
    if dtype == torch.bfloat16:
        _holds(main, b * to * tiles, chunks)
        # the bf16 output tile fits the 8 warps' 10 m16n8 accumulators each
        assert (-(-main.th * main.tw // 16)) * (-(-co // 16) * 2) <= 80
    else:                            # f32 stays unsplit (FMA, no partials)
        assert main.splits == 1 and main.smem <= SMEM
        assert main.th * main.tw * co <= 256 * 40
    to, ho, wo = fb.out_shape(*shape[1:4], k, s)
    assert main.workspace == (main.splits * b * to * ho * wo * co
                              if main.splits > 1 else 0)
    if se:
        pool = fb._pool_plan(shape, k, s, e, dtype)
        items = fb.valid_frames(t, k, s)[1] * _tiles_of(pool, shape, k, s)
        _holds(pool, b * chunks, items)
        assert pool.workspace == (b * pool.splits * e if pool.splits > 1
                                  else 0)


def test_plans_split_the_short_grids():
    """At bs 8 the main pass splits where its frames are small (7x7 and
    14x14 outputs with few tiles) and nowhere at 56x56 or more; every SE
    geometry's pool pass splits (B x E-chunks is at most 240 blocks)."""
    for name, shape, k, s, se, e, co in GEOMETRIES:
        main = fb._main_plan(shape, k, s, e, co, torch.bfloat16)
        _, ho, _ = fb.out_shape(*shape[1:4], k, s)
        if ho >= 56:
            assert main.splits == 1, name
        if se:
            assert fb._pool_plan(shape, k, s, e,
                                 torch.bfloat16).splits > 1, name
    split = {g[0] for g in GEOMETRIES if fb._main_plan(
        *g[1:4], g[5], g[6], torch.bfloat16).splits > 1}
    assert {"Large3D 13", "MobileViT-s 6", "Small3D 9",
            "Small3D 10"} <= split


@pytest.mark.parametrize("shape,main", [((2100, 30, 4, 4, 16), True),
                                        ((65600, 1, 4, 4, 16), False)])
def test_plans_take_batches_past_a_grid_y_axis(shape, main):
    """chip_smoke.py's large-batch cases: B*T' = 67,200 frames (main) and
    B = 65,600 samples (pool) on one-dimensional grids, unsplit."""
    for dtype in (torch.bfloat16, torch.float32):
        plan = (fb._main_plan(shape, 3, 1, 32, 16, dtype) if main
                else fb._pool_plan(shape, 3, 1, 32, dtype))
        assert plan.splits == 1 and 65535 < plan.blocks < GRID


# --------------------------------------------------------------------------
# the split kernels' order against the Pallas kernel
# --------------------------------------------------------------------------

def _split_chain(xt, t, k, s, use_se, pool_splits, main_splits, dtype):
    """The kernels' path with their numerics and split order: pool pass
    (``pool_split_reference``), the SE MLP, main pass
    (``main_split_reference``)."""
    b, tt, h, w, _ = xt.shape
    e = t["w1"].shape[1]
    if use_se:
        plan = fb._pool_plan(tuple(xt.shape), k, s, e, dtype)
        plan = plan._replace(splits=pool_splits)
        pooled = fb.pool_split_reference(xt, t["w1"], t["wd"], k, s, plan)
        to, ho, wo = fb.out_shape(tt, h, w, k, s)
        scale = fb.se_scale(pooled / (to * ho * wo), t["se_w1"],
                            t["se_b1"], t["se_w2"], t["se_b2"], dtype)
    else:
        scale = torch.ones(b, e)
    return fb.main_split_reference(xt, t["w1"], t["wd"], t["w2"], scale, k,
                                   s, main_splits)


# (C, E): a C that is no multiple of 16 and an E that is no multiple of
# the 32-channel chunk
WIDTHS = [(24, 72), (40, 88)]
CASES = [(3, 1, False), (3, 2, False), (5, 2, False), (3, 1, True),
         (5, 1, True), (5, 2, True)]


@pytest.mark.parametrize("c,e", WIDTHS)
@pytest.mark.parametrize("k,s,use_se", CASES)
def test_split_order_matches_jax_kernel_f32(rng, k, s, use_se, c, e):
    x, w = _inputs(rng, c=c, e=e, k=k, shape=(2, 4, 12, 12))
    want = _jax(x, w, k, s, use_se)
    t = _torch(w)
    xt = torch.from_numpy(x.copy())
    for pool_splits, main_splits in ((1, 1), (5, 3), (2, 2)):
        got = _split_chain(xt, t, k, s, use_se, pool_splits, main_splits,
                           torch.float32)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_pool_split_reference_sums_every_pixel_once(rng):
    """Any split of the items gives the plain pool sums (f32 2e-4): each
    valid output pixel lies in exactly one range."""
    x, w = _inputs(rng, c=24, e=72, k=5, shape=(2, 7, 13, 11))
    t = _torch(w)
    xt = torch.from_numpy(x)
    want = fb.pool_reference(xt, t["w1"], t["wd"], 5, 2).numpy()
    plan = fb._pool_plan(tuple(xt.shape), 5, 2, 72, torch.float32)
    for splits in (1, 2, 7, 13):
        got = fb.pool_split_reference(xt, t["w1"], t["wd"], 5, 2,
                                      plan._replace(th=3, tw=4,
                                                    splits=splits))
        np.testing.assert_allclose(got.numpy(), want, **TOL)


# bf16 against the Pallas kernel run in bf16 (interpret mode). The split
# chain has the kernels' numerics (expand, stencil and scale in f32, one
# rounding to bf16 as the projection's operand, f32 accumulation, one
# rounding of the output), the Pallas kernel's own: outputs differ where a
# rounding falls the other way on an f32 sum taken in another order (a
# bf16 ulp, 2^-8 relative, of a few outputs). With SE the MLP runs bf16
# matmuls in both frameworks and rounds the scale to bf16: one ulp flipped
# in a channel's scale moves that channel's whole contribution by 0.4%,
# so the rms error reaches 0.45% at these shapes (0.01% without SE): 2% of
# max|ref| and 1% rms. The plain version rounds the expanded and depthwise
# tensors to bf16 where the kernel keeps them f32 (2^-9 relative each,
# through C- and k*k-term sums): chip_smoke.py's bound for it on the
# card, 3% of max|ref|, and 1% rms.
BF16_SPLIT = dict(max_rel=2e-2, rms_rel=1e-2)
BF16_PLAIN = dict(max_rel=3e-2, rms_rel=1e-2)


def _close_bf16(got, want, max_rel, rms_rel):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    err = np.abs(got - want)
    assert err.max() <= max_rel * np.abs(want).max()
    assert np.sqrt((err ** 2).mean()) <= rms_rel * np.sqrt((want ** 2).mean())


def _jax_bf16(x, w, k, s, use_se):
    c, e = w["w1"].shape
    b = lambda v: jnp.asarray(v).astype(jnp.bfloat16)  # noqa: E731
    out = fused_bottleneck(
        b(x), b(w["w1"].reshape(1, 1, 1, c, e)),
        b(w["wd"].reshape(1, k, k, 1, e)), b(w["w2"].reshape(1, 1, 1, e, -1)),
        *(b(w[n]) for n in ("se_w1", "se_b1", "se_w2", "se_b2")),
        k, s, use_se, 8)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("c,e", WIDTHS)
@pytest.mark.parametrize("k,s,use_se", CASES)
def test_bf16_plain_versions_match_jax_kernel(rng, k, s, use_se, c, e):
    x, w = _inputs(rng, c=c, e=e, k=k, shape=(2, 4, 12, 12))
    # bf16 values on both sides: round the inputs once, in numpy
    x, w = _bf16_exact(x), {n: _bf16_exact(v) for n, v in w.items()}
    want = _jax_bf16(x, w, k, s, use_se)
    t = {n: v.to(torch.bfloat16) for n, v in _torch(w).items()}
    xt = torch.from_numpy(x.copy()).to(torch.bfloat16)
    for pool_splits, main_splits in ((1, 1), (5, 3)):
        got = _split_chain(xt, t, k, s, use_se, pool_splits, main_splits,
                           torch.bfloat16)
        assert got.dtype == torch.bfloat16
        _close_bf16(got, want, **BF16_SPLIT)
    plain = fb.fused_bottleneck(xt, t["w1"], t["wd"], t["w2"], t["se_w1"],
                                t["se_b1"], t["se_w2"], t["se_b2"], k, s,
                                use_se)
    assert plain.dtype == torch.bfloat16
    _close_bf16(plain, want, **BF16_PLAIN)


def _bf16_exact(v):
    return torch.from_numpy(np.ascontiguousarray(v)).to(
        torch.bfloat16).float().numpy()
