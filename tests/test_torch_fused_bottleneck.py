"""Port: the fused bottleneck's plain version against the JAX kernel.

The JAX side runs the Pallas kernel in interpret mode on the CPU, as
tests/test_fused_bottleneck.py does; the port's wrappers take their plain
PyTorch version for CPU tensors. Same numpy inputs into both, f32.
Tolerance 2e-4 (rtol and atol): the same f32 chain summed in another
order (XLA's interpreted kernel vs. torch's matmul and conv), the bound
the JAX package's own kernel-vs-module test uses.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from picklebot_tpu.ops.pallas.fused_bottleneck import fused_bottleneck
from picklebot_tpu_torch.ops import fused_bottleneck as fb

TOL = dict(rtol=2e-4, atol=2e-4)


def _inputs(rng, c=8, e=24, co=16, k=3):
    x = rng.rand(2, 5, 16, 16, c).astype(np.float32)
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
