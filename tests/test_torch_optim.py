"""Port: the optimizers and the LR schedule against the JAX package's.

  * The 8-bit codec is bit-identical to the JAX side's numpy path
    (``_quantize_signed``/``_quantize_unsigned`` with ``xp=np``): codes,
    scales and decoded values.
  * AdamW and AdamW8bit after N steps from the same parameters and
    gradients agree within N * lr: Adam's 1/(sqrt(v) + eps) turns float
    noise on near-zero gradients into lr-sized updates (CLAUDE.md).
  * The cosine schedule, with and without warmup, is equal to f32
    rounding.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from picklebot_tpu.train import optim as jax_optim
from picklebot_tpu_torch.train import optim


def _arrays(rng):
    """Sizes that are and are not multiples of the 256-block, zeros, a
    block whose values span many octaves, and exact block maxima."""
    spread = (rng.randn(700) * np.exp2(rng.randint(-30, 1, 700)))
    exact = np.full(300, 0.25)
    exact[::7] = -1.0
    return [a.astype(np.float32) for a in (
        rng.randn(1000), np.zeros(256), spread, exact,
        rng.randn(4, 33, 5) * 1e-6)]


@pytest.mark.parametrize("signed", [True, False])
def test_codec_is_bit_identical_to_jax_numpy_path(rng, signed):
    for a in _arrays(rng):
        if not signed:
            a = np.abs(a) ** 2
        quant = jax_optim._quantize_signed if signed \
            else jax_optim._quantize_unsigned
        dequant = jax_optim._dequantize_signed if signed \
            else jax_optim._dequantize_unsigned
        codes_j, scale_j = quant(a, xp=np)
        codes, scale = (optim.quantize_signed if signed
                        else optim.quantize_unsigned)(torch.from_numpy(a))
        assert codes.dtype == torch.uint8
        np.testing.assert_array_equal(codes.numpy(), codes_j)
        np.testing.assert_array_equal(scale.numpy(), scale_j)
        back = (optim.dequantize_signed if signed
                else optim.dequantize_unsigned)(codes, scale, a.shape)
        np.testing.assert_array_equal(
            back.numpy(), dequant(codes_j, scale_j, a.shape, xp=np))


def test_codec_keeps_each_block_max_exact(rng):
    a = torch.from_numpy(rng.randn(3, 256).astype(np.float32))
    back = optim.dequantize_signed(*optim.quantize_signed(a), a.shape)
    rows = a.abs().argmax(1)
    torch.testing.assert_close(back[range(3), rows], a[range(3), rows],
                               rtol=0, atol=0)


@pytest.mark.parametrize("name", ["adamw", "adamw8bit"])
def test_n_steps_match_jax(rng, name):
    """Five steps on a tensor large enough for 8-bit moments and a small
    one that keeps f32 moments, lr 1e-3, weight decay 5e-4."""
    steps, lr, wd = 5, 1e-3, 5e-4
    params = {"big": rng.randn(64, 80).astype(np.float32),
              "small": rng.randn(7).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(steps)]
    jopt = jax_optim.OPTIMIZERS[name](weight_decay=wd)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    topt = optim.OPTIMIZERS[name](tp.values(), weight_decay=wd)
    assert isinstance(topt.m[0], tuple) == (name == "adamw8bit")
    assert not isinstance(topt.m[1], tuple)
    for g in grads:
        jp, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                 jstate, jp, jnp.float32(lr))
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        topt.step(lr)
    for k, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=steps * lr, err_msg=k)
    if name == "adamw8bit":         # the stored codes track the JAX ones
        codes_j = np.asarray(jstate["m"]["big"]["q"]).astype(int)
        assert np.abs(topt.m[0][0].numpy().astype(int) - codes_j).max() <= 1


@pytest.mark.parametrize("warmup", [0, 3])
def test_cosine_schedule_matches_jax(warmup):
    want = jax_optim.cosine_annealing_lr(3e-4, 10, warmup=warmup)
    got = optim.cosine_annealing_lr(3e-4, 10, warmup=warmup)
    for epoch in range(12):
        np.testing.assert_allclose(got(epoch), float(want(epoch)),
                                   rtol=1e-6, err_msg=f"epoch {epoch}")
    assert got(0) == pytest.approx(3e-4 / warmup if warmup else 3e-4)
    assert got(9) == pytest.approx(3e-5 + 2.7e-4 * 0.5 * (
        1 + np.cos(np.pi * (9 - warmup) / (10 - warmup))), rel=1e-6)
