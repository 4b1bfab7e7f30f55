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
kernel in f32 and bf16, and the bf16 plain version against it. Last, the
backward's depthwise stencil kernels: their plain versions
(``dw_stencil_reference``, ``dw_dgrad_reference``, ``dw_wgrad_reference``
in the plan's range order) and ``DepthwiseStencilFn`` against
``F.conv3d``'s autograd at every geometry, their zero frames, and their
plans (``_dw_plan``).
"""

import os
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from picklebot_tpu.ops.pallas.fused_bottleneck import fused_bottleneck
from picklebot_tpu_torch.ops import fused_bottleneck as fb
from picklebot_tpu_torch.ops.conv import depthwise_conv

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


# --------------------------------------------------------------------------
# the depthwise stencil's backward kernels (the recompute's depthwise conv
# on the card): their plain versions and plans
# --------------------------------------------------------------------------

DW_TOL = 1e-5        # of max|ref|: f32 sums of the same products


def _dw_shape(shape, e):
    """A geometry's stencil input (B, T, H, W, E) cut to a CPU test's
    size: its T (the quirk's frames), E (the chunk plan), k and s kept;
    two samples; frames of at most 10x12 (odd sizes stay odd)."""
    _, t, h, w, _ = shape
    return (2, t, min(h, 9 + h % 2), min(w, 11 + w % 2), e)


def _dw_inputs(shape, k, s, seed, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    a = torch.randn(shape, generator=gen, dtype=torch.float64).to(dtype)
    wd = (torch.rand((k, k, shape[-1]), generator=gen) * 2 - 1).to(dtype)
    g = torch.randn((shape[0], *fb.out_shape(*shape[1:4], k, s), shape[-1]),
                    generator=gen).to(dtype)
    return a, wd, g


def _conv3d_grads(a, wd, g, s):
    ar, wr = a.clone().requires_grad_(), wd.clone().requires_grad_()
    d = depthwise_conv(ar, wr, s)
    return (d.detach(), *torch.autograd.grad(d, (ar, wr), g))


def _rel_close(got, want, tol=DW_TOL):
    err = (got.double() - want.double()).abs().max().item()
    assert err <= tol * want.double().abs().max().item(), err


@pytest.mark.parametrize("name,shape,k,s,se,e,co", GEOMETRIES,
                         ids=[g[0] for g in GEOMETRIES])
def test_dw_plain_versions_match_conv3d_autograd(name, shape, k, s, se, e,
                                                 co):
    """At each bottleneck geometry of the three models (cut to CPU size):
    the plain versions of the stencil, its input gradient and its weight
    gradient in the plan's range order equal F.conv3d's (groups=E) output
    and autograd gradients, f32 within 1e-5 of max|ref|; so does the
    autograd Function the recompute takes."""
    shape = _dw_shape(shape, e)
    a, wd, g = _dw_inputs(shape, k, s, seed=len(name) * 7 + k)
    d, da, dwd = _conv3d_grads(a, wd, g, s)
    _rel_close(fb.dw_stencil_reference(a, wd, s), d)
    _rel_close(fb.dw_dgrad_reference(g, wd, s, shape), da)
    plan = fb._dw_plan(shape, k, s, torch.float32, "wgrad")
    _rel_close(fb.dw_wgrad_reference(a, g, k, s, plan), dwd)
    before = dict(fb.LAUNCHES)
    ar, wr = a.clone().requires_grad_(), wd.clone().requires_grad_()
    out = fb.depthwise_stencil(ar, wr, s)
    got = torch.autograd.grad(out, (ar, wr), g)
    assert fb.LAUNCHES == before      # a CPU tensor launches no kernel
    _rel_close(out.detach(), d)
    _rel_close(got[0], da)
    _rel_close(got[1], dwd)


@pytest.mark.parametrize("k,s,use_se", CASES)
def test_dw_chain_gradients_equal_the_plain_chain(rng, k, s, use_se):
    """The recompute's chain with its depthwise conv on the stencil's
    Function (``_chain(depthwise_stencil, ...)``, the card's path, here on
    its plain versions) has the plain chain's gradients in every input,
    f32 within 1e-5 of max|ref|, with and without SE."""
    x, w = _inputs(rng, c=24, e=72, k=k, shape=(2, 5, 11, 9))
    names = ("w1", "wd", "w2", "se_w1", "se_b1", "se_w2", "se_b2")
    args = [torch.from_numpy(x)] + [torch.from_numpy(w[n]) for n in names]
    g = None
    grads = {}
    for depthwise in (depthwise_conv, fb.depthwise_stencil):
        ins = [t.clone().requires_grad_() for t in args]
        out = fb._chain(depthwise, *ins, k, s, use_se)
        if g is None:
            g = torch.randn(out.shape, generator=torch.Generator()
                            .manual_seed(3))
        live = ins if use_se else ins[:4]
        grads[depthwise] = torch.autograd.grad(out, live, g)
    for got, want in zip(grads[fb.depthwise_stencil],
                         grads[depthwise_conv]):
        _rel_close(got, want)


@pytest.mark.parametrize("k,s,t", [(3, 1, 5), (5, 1, 4), (3, 2, 7),
                                   (5, 2, 6), (3, 2, 2)])
def test_dw_wgrad_reference_sums_every_position_once(k, s, t):
    """Any cut of the (sample, valid frame, tile) items into ranges, with
    tiles that do not divide the frame, gives conv3d's weight gradient
    (f32 1e-5): each valid output position lies in exactly one range.
    Ones in, ones back: each tap's sum is the count of the positions
    that read inside the frame, an integer, exact."""
    shape = (3, t, 13, 11, 40)
    a, wd, g = _dw_inputs(shape, k, s, seed=11)
    want = _conv3d_grads(a, wd, g, s)[2]
    ones_a, ones_g = torch.ones_like(a), torch.ones_like(g)
    count = _conv3d_grads(ones_a, wd, ones_g, s)[2]
    plan = fb._dw_plan(shape, k, s, torch.float32, "wgrad")
    items = shape[0] * fb.valid_frames(t, k, s)[1] * 4 * 3
    for splits in (1, 2, 7, 13, items):
        cut = plan._replace(th=4, tw=4, splits=splits)
        _rel_close(fb.dw_wgrad_reference(a, g, k, s, cut), want)
        assert torch.equal(fb.dw_wgrad_reference(ones_a, ones_g, k, s, cut),
                           count)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,s,t", [(3, 1, 4), (5, 1, 3), (3, 2, 8),
                                   (5, 2, 7)])
def test_dw_zero_frames_and_unread_frames_are_exact_zeros(k, s, t, dtype):
    """The stencil's output frames whose input frame lies outside [0, T)
    (T' = T + 2*(k//2) at stride 1) and the input gradient's frames that
    no output frame reads (t + k//2 no multiple of s) come out exactly 0;
    every other frame is read."""
    shape = (2, t, 7, 9, 24)
    a, wd, g = _dw_inputs(shape, k, s, seed=5, dtype=dtype)
    first, n = fb.valid_frames(t, k, s)
    d = fb.dw_stencil_reference(a, wd, s)
    da = fb.dw_dgrad_reference(g, wd, s, shape)
    assert d.dtype == da.dtype == dtype
    for f in range(d.shape[1]):
        assert bool(d[:, f].any()) == (first <= f < first + n), f
    read = {f * s - k // 2 for f in range(first, first + n)}
    for f in range(t):
        assert bool(da[:, f].any()) == (f in read), f
    if s == 2:
        assert 0 < len(read) < t


# the stencil's input a at every geometry of the three models, at bs 8
# and (MobileNetLarge3D's) at the benchmark cell's bs 16
DW_GEOMETRIES = [(name, (b, *shape[1:4], e), k, s)
                 for name, shape, k, s, _, e, _ in GEOMETRIES
                 for b in ((8, 16) if name.startswith("Large3D") else (8,))]


@pytest.mark.parametrize("kind", ["stencil", "dgrad", "wgrad"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name,shape,k,s", DW_GEOMETRIES,
                         ids=[f"{g[0]} bs{g[1][0]}" for g in DW_GEOMETRIES])
def test_dw_plans_fill_the_card_and_fit(name, shape, k, s, dtype, kind):
    """Each kernel's plan at each geometry: a chunk of 16..64 channels
    with at most 15 idle, a tile inside the frame whose shared memory fits
    one block (and lets four blocks share an SM), a one-dimensional grid
    of at least two blocks per SM; wgrad cut into ranges for that (no more
    ranges than items) with its workspace."""
    b, t, h, w, e = shape
    plan = fb._dw_plan(shape, k, s, dtype, kind)
    to, ho, wo = fb.out_shape(t, h, w, k, s)
    fh, fw = (h, w) if kind == "dgrad" else (ho, wo)
    chunks = -(-e // plan.chunk)
    assert plan.chunk % 16 == 0 and 16 <= plan.chunk <= 64
    assert chunks * plan.chunk - e < 16 * chunks
    assert 1 <= plan.th <= fh and 1 <= plan.tw <= fw
    assert plan.smem <= 48 * 1024 < SMEM
    elem = 2 if dtype == torch.bfloat16 else 4
    assert plan.smem == fb._dw_smem(kind, plan.th, plan.tw, plan.chunk, k,
                                    s, elem)
    tiles = -(-fh // plan.th) * -(-fw // plan.tw)
    assert 2 * SMS <= plan.blocks < GRID
    if kind == "wgrad":
        items = b * fb.valid_frames(t, k, s)[1] * tiles
        assert plan.blocks == chunks * plan.splits
        assert 1 <= plan.splits <= items
        assert plan.workspace == (plan.splits * k * k * e
                                  if plan.splits > 1 else 0)
    else:
        assert plan.splits == 1 and plan.workspace == 0
        assert plan.blocks == chunks * b * (t if kind == "dgrad" else to) \
            * tiles


def test_dw_plans_take_any_kernel_size_and_refuse_what_they_cannot():
    """k = 7 plans (its wgrad keeps its sums in shared memory); an
    unknown kind, and a k whose wgrad sums no shared memory holds, are
    refused."""
    plan = fb._dw_plan((2, 4, 9, 9, 40), 7, 1, torch.bfloat16, "wgrad")
    assert plan.smem == fb._dw_smem("wgrad", plan.th, plan.tw, plan.chunk,
                                    7, 1, 2) > 7 * 7 * 256 * 8
    with pytest.raises(ValueError, match="kind"):
        fb._dw_plan((2, 4, 9, 9, 40), 3, 1, torch.float32, "dx")
    with pytest.raises(ValueError, match="no tile fits"):
        fb._dw_plan((2, 4, 9, 9, 40), 11, 1, torch.float32, "wgrad")
    assert fb._dw_plan((2, 4, 9, 9, 40), 11, 1, torch.float32, "stencil")


def test_dw_kernel_wrappers_refuse_bad_inputs():
    """Shapes, dtypes, devices and contiguity are refused before any
    build or launch; a tensor that is neither on the CPU nor on CUDA is
    no quiet way to the plain version."""
    meta = dict(device="meta")
    a = torch.empty((2, 5, 8, 8, 24), **meta)
    wd = torch.empty((3, 3, 24), **meta)
    g = torch.empty((2, 7, 8, 8, 24), **meta)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fb._launch_dw_stencil(a, wd, 1)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fb.dw_dgrad(g, wd, 1, a.shape)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fb.dw_wgrad(a, g, 3, 1)
    with pytest.raises(ValueError, match="shape"):
        fb._launch_dw_stencil(a, torch.empty((3, 3, 16), **meta), 1)
    with pytest.raises(ValueError, match="shape"):
        fb._launch_dw_dgrad(g[:, :6], wd, 1, a.shape)
    with pytest.raises(ValueError, match="shape"):
        fb._launch_dw_wgrad(a, g, 5, 1)
    with pytest.raises(ValueError, match="float32 on meta"):
        fb._launch_dw_wgrad(a, g.to(torch.float64), 3, 1)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fb._launch_dw_stencil(a.half(), wd.half(), 1)
    with pytest.raises(ValueError, match="contiguous"):
        fb._launch_dw_dgrad(g.transpose(2, 3), wd, 1, a.shape)
    with pytest.raises(ValueError, match=r"\(B, T, H, W, E\)"):
        fb._launch_dw_stencil(a[0], wd, 1)
