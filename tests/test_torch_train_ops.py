"""Port: the training pieces of the ops and the losses against the JAX
package, on the CPU, f32.

  * ``FusedBottleneckFn``: input and weight grads against ``jax.vjp`` of
    the JAX ``fused_bottleneck`` (its ``custom_vjp``: the Pallas forward in
    interpret mode, an XLA recompute backward). 2e-4, the bound of the
    forward test: the same f32 chain summed in another order.
  * BatchNorm in train mode: output, input and affine grads, running
    statistics against the JAX BatchNorm. 1e-5: one f32 mean and variance
    over 360 values.
  * Dropout and ChannelDropout: mask shape, scaling and keep rate by
    distribution (Philox and threefry never give the same bits).
  * Losses and accuracies, label smoothing included. 1e-6.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from picklebot_tpu.ops import linear as jax_linear
from picklebot_tpu.ops.norm import BatchNorm as JaxBatchNorm
from picklebot_tpu.ops.pallas.fused_bottleneck import fused_bottleneck
from picklebot_tpu.train import losses as jax_losses
from picklebot_tpu_torch.ops import flash_attention as fa
from picklebot_tpu_torch.ops import fused_bottleneck as fb
from picklebot_tpu_torch.ops.linear import ChannelDropout, Dropout, dropout_rng
from picklebot_tpu_torch.ops.norm import BatchNorm
from picklebot_tpu_torch.train import losses
from test_torch_fused_bottleneck import _inputs

TOL = dict(rtol=2e-4, atol=2e-4)
NAMES = ("w1", "wd", "w2", "se_w1", "se_b1", "se_w2", "se_b2")


@pytest.mark.parametrize("k,s,use_se", [(3, 1, False), (3, 2, False),
                                        (5, 1, True), (5, 2, True)])
def test_fused_function_grads_match_jax_vjp(rng, k, s, use_se):
    x, w = _inputs(rng, k=k)
    c, e = w["w1"].shape
    jax_shapes = {"w1": (1, 1, 1, c, e), "wd": (1, k, k, 1, e),
                  "w2": (1, 1, 1, e, -1)}
    jw = [jnp.asarray(w[n].reshape(jax_shapes.get(n, w[n].shape)))
          for n in NAMES]
    out_j, vjp = jax.vjp(lambda x_, *ws: fused_bottleneck(
        x_, *ws, k, s, use_se, 8), jnp.asarray(x), *jw)
    g = rng.randn(*out_j.shape).astype(np.float32)
    want = vjp(jnp.asarray(g))

    ts = [torch.from_numpy(a.copy()).requires_grad_()
          for a in [x] + [w[n] for n in NAMES]]
    before = dict(fb.LAUNCHES)
    out = fb.fused_bottleneck(*ts, k, s, use_se)
    assert type(out.grad_fn).__name__ == "FusedBottleneckFnBackward"
    out.backward(torch.from_numpy(g))
    assert fb.LAUNCHES == before
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               **TOL)
    for name, t, gj in zip(("x",) + NAMES, ts, want):
        gj = np.asarray(gj).reshape(t.shape)
        if t.grad is None:           # SE weights of a block without SE
            assert not use_se and not gj.any(), name
            continue
        np.testing.assert_allclose(t.grad.numpy(), gj, err_msg=name, **TOL)


def test_fused_passes_alone_refuse_autograd(rng):
    """The pool and main wrappers have no backward of their own: under
    autograd they raise rather than return a result without a graph."""
    x, w = _inputs(rng)
    xt = torch.from_numpy(x).requires_grad_()
    t = {n: torch.from_numpy(v) for n, v in w.items()}
    with pytest.raises(NotImplementedError, match="FusedBottleneckFn"):
        fb.fused_pool(xt, t["w1"], t["wd"], 3, 1)
    with pytest.raises(NotImplementedError, match="FusedBottleneckFn"):
        fb.fused_main(xt, t["w1"], t["wd"], t["w2"], torch.ones(2, 24), 3, 1)
    with torch.no_grad():
        assert fb.fused_pool(xt, t["w1"], t["wd"], 3, 1).shape == (2, 24)


@pytest.mark.parametrize("affine", [True, False])
def test_batchnorm_train_matches_jax(rng, affine):
    c = 6
    jm = JaxBatchNorm(c, affine=affine)
    state = {"mean": rng.normal(0, 0.1, c).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
    params = ({"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
               "bias": rng.normal(0, 0.1, c).astype(np.float32)}
              if affine else {})
    x = (rng.randn(4, 3, 5, c) * 2 + 1).astype(np.float32)
    g = rng.randn(*x.shape).astype(np.float32)

    def fwd(x_, p):
        return jm.apply({"params": p, "state": state}, x_, train=True)
    (out_j, new_state), vjp = jax.vjp(fwd, jnp.asarray(x), params)
    gx_j, gp_j = vjp((jnp.asarray(g), jax.tree_util.tree_map(
        jnp.zeros_like, new_state)))

    bn = BatchNorm(c, affine=affine).train()
    bn.running_mean.copy_(torch.from_numpy(state["mean"]))
    bn.running_var.copy_(torch.from_numpy(state["var"]))
    if affine:
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(params["scale"]))
            bn.bias.copy_(torch.from_numpy(params["bias"]))
    xt = torch.from_numpy(x.copy()).requires_grad_()
    out = bn(xt)
    out.backward(torch.from_numpy(g))
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **tol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), **tol)
    if affine:
        np.testing.assert_allclose(bn.weight.grad.numpy(),
                                   np.asarray(gp_j["scale"]), **tol)
        np.testing.assert_allclose(bn.bias.grad.numpy(),
                                   np.asarray(gp_j["bias"]), **tol)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(new_state["mean"]), **tol)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(new_state["var"]), **tol)
    assert int(bn.num_batches_tracked) == 1
    assert bn.running_mean.grad_fn is None


def _jax_drop(module, x, seed):
    out, _ = module.apply({}, jnp.asarray(x), train=True,
                          rng=jax.random.key(seed))
    return np.asarray(out)


@pytest.mark.parametrize("kind", ["channel", "elementwise"])
def test_dropout_masks_match_jax_in_distribution(kind):
    """Mask shape, inverted scaling and keep rate: both packages keep
    within 4 sigma of 1 - p, and every kept value is x / keep."""
    p = 0.2
    if kind == "channel":
        x = np.ones((64, 3, 4, 4, 32), np.float32)
        port, jm = ChannelDropout(p), jax_linear.ChannelDropout(p)
    else:
        x = np.ones((40_000,), np.float32)
        port, jm = Dropout(p), jax_linear.Dropout(p)
    g = torch.Generator().manual_seed(0)
    xt = torch.from_numpy(x.copy()).requires_grad_()
    with dropout_rng(g):
        out = port.train()(xt)
    assert out.grad_fn is not None
    for got in (out.detach().numpy(), _jax_drop(jm, x, 0)):
        assert set(np.unique(got)) <= {0.0, np.float32(1 / (1 - p))}
        if kind == "channel":       # whole channels: one value per (b, c)
            per = got.reshape(64, -1, 32)
            assert (per == per[:, :1]).all()
            kept = (per[:, 0] > 0).mean()
            n = 64 * 32
        else:
            kept, n = (got > 0).mean(), got.size
        assert abs(kept - (1 - p)) < 4 * np.sqrt(p * (1 - p) / n)
    g2 = torch.Generator().manual_seed(0)
    with dropout_rng(g2), torch.no_grad():
        again = port(torch.from_numpy(x.copy()))
    torch.testing.assert_close(again, out.detach())    # seeded: same mask


def test_dropout_is_the_identity_in_eval_and_needs_a_generator():
    x = torch.randn(2, 3, 8)
    assert torch.equal(Dropout(0.5).eval()(x), x)
    assert torch.equal(ChannelDropout(0.0).train()(x), x)
    with pytest.raises(ValueError, match="dropout_rng"):
        Dropout(0.5).train()(x)
    meta = torch.empty(2, 3, device="meta")
    with dropout_rng(torch.Generator()), \
            pytest.raises(ValueError, match="generator on"):
        Dropout(0.5).train()(meta)
    with dropout_rng(torch.Generator().manual_seed(1)):
        y = ChannelDropout(0.5).train()(x.bfloat16())
    assert y.dtype == torch.bfloat16


def test_sdpa_dropout_drops_probabilities(rng, monkeypatch):
    """Attention-probability dropout on the plain path, with an injected
    mask: softmax in f32, masked and scaled by 1/keep, then the PV
    product, as ``sdpa_xla`` computes it."""
    p, scale = 0.25, 0.25
    q, k, v = (rng.randn(2, 5, 7, 16).astype(np.float32) for _ in range(3))
    mask = rng.rand(2, 5, 7, 7) > p
    monkeypatch.setattr(fa, "dropout_mask",
                        lambda shape, keep, device: torch.from_numpy(mask))
    got = fa.sdpa(*(torch.from_numpy(a) for a in (q, k, v)), scale,
                  dropout_p=p)
    logits = q @ k.swapaxes(-1, -2) * scale
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    want = (probs * mask / (1 - p)) @ v
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_losses_and_accuracies_match_jax(rng, smoothing):
    tol = dict(rtol=1e-6, atol=1e-6)
    logits = rng.randn(6, 5).astype(np.float32)
    labels = rng.randint(0, 5, 6)
    blogits = rng.randn(6, 1).astype(np.float32)
    blabels = rng.randint(0, 2, 6)
    t = torch.from_numpy
    for crit, lg, lb in (("CE", logits, labels), ("BCE", blogits, blabels)):
        jl = jax_losses.prepare_labels(crit, jnp.asarray(lb))
        pl = losses.prepare_labels(crit, t(lb))
        np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
        assert pl.dtype == (torch.int64 if crit == "CE" else torch.float32)
        pairs = [(losses.LOSSES[crit][1], jax_losses.LOSSES[crit][1])]
        pairs += zip(losses.LOSSES_PER_SAMPLE[crit],
                     jax_losses.LOSSES_PER_SAMPLE[crit])
        if smoothing:
            pairs.append(
                ((losses.smoothed_cross_entropy if crit == "CE"
                  else losses.smoothed_bce)(smoothing),
                 (jax_losses.smoothed_cross_entropy if crit == "CE"
                  else jax_losses.smoothed_bce)(smoothing)))
        else:
            pairs.append((losses.LOSSES[crit][0], jax_losses.LOSSES[crit][0]))
        for port_fn, jax_fn in pairs:
            np.testing.assert_allclose(port_fn(t(lg), pl).numpy(),
                                       np.asarray(jax_fn(jnp.asarray(lg),
                                                         jl)), **tol)
