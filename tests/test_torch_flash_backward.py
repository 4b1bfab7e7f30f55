"""Port: the flash-attention autograd Functions against the JAX kernels'.

The JAX side differentiates its Pallas kernels with ``jax.vjp`` (their
``custom_vjp`` backward is the ``_dq_kernel``/``_dkv_kernel`` pair), in
interpret mode on the CPU at block_q = block_k = 32, so that N = 40 and
100 are ragged and span several blocks. On the port's side a CPU tensor
that requires grad takes the same ``autograd.Function`` as a CUDA one,
with the plain forward (lse included) and ``flash_backward_reference`` in
place of the kernels. Same numpy inputs and output gradient into both,
f32. Tolerance 2e-4 (rtol and atol): the same f32 algebra summed in
another order, the bound the forward tests use.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from picklebot_tpu.ops.pallas import flash_attention as jax_flash
from picklebot_tpu.ops.pallas import flash_packed as jax_packed
from picklebot_tpu_torch.ops import flash_attention as fa

TOL = dict(rtol=2e-4, atol=2e-4)
BLOCKS = dict(block_q=32, block_k=32)


def _jax_vjp(fn, inputs, g):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in inputs))
    return np.asarray(out), [np.asarray(t) for t in vjp(jnp.asarray(g))]


def _port_vjp(fn, inputs, g, function):
    """Output and input grads of ``fn``, which must run ``function``."""
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in inputs]
    before = dict(fa.LAUNCHES)
    out = fn(*ts)
    assert type(out.grad_fn).__name__ == f"{function.__name__}Backward"
    out.backward(torch.from_numpy(g.copy()))
    assert fa.LAUNCHES == before          # CPU tensors launch no kernel
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _check(got, want):
    np.testing.assert_allclose(got[0], want[0], **TOL)
    for name, a, b in zip(("dq", "dk", "dv"), got[1], want[1]):
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)


def _randn(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("lead", [(2,), (2, 3)])
@pytest.mark.parametrize("n", [40, 100])
def test_packed_backward_matches_jax(rng, n, lead):
    heads = 8
    shape = lead + (n, heads * 16)
    inputs = [_randn(rng, *shape) for _ in range(3)]
    g = _randn(rng, *shape)
    want = _jax_vjp(lambda q, k, v: jax_packed.flash_attention_packed(
        q, k, v, heads, **BLOCKS), inputs, g)
    got = _port_vjp(lambda q, k, v: fa.flash_attention_packed(q, k, v,
                                                              heads),
                    inputs, g, fa.FlashPackedFn)
    _check(got, want)


@pytest.mark.parametrize("lead", [(2,), (2, 3)])
@pytest.mark.parametrize("n", [40, 100])
def test_per_head_backward_matches_jax(rng, n, lead):
    shape = lead + (n, 16)
    inputs = [_randn(rng, *shape) for _ in range(3)]
    g = _randn(rng, *shape)
    want = _jax_vjp(lambda q, k, v: jax_flash.flash_attention(
        q, k, v, **BLOCKS), inputs, g)
    got = _port_vjp(fa.flash_attention, inputs, g, fa.FlashFn)
    _check(got, want)


@pytest.mark.parametrize("lead", [(2,), (2, 3)])
@pytest.mark.parametrize("n", [40, 100])
def test_qkvpacked_backward_matches_jax(rng, n, lead):
    qkv = _randn(rng, *lead, n, 3, 4, 16)
    g = _randn(rng, *lead, n, 4, 16)
    out_j, (dqkv_j,) = _jax_vjp(
        lambda t: jax_flash.flash_attention_qkvpacked(t, **BLOCKS), [qkv], g)
    out, (dqkv,) = _port_vjp(fa.flash_attention_qkvpacked, [qkv], g,
                             fa.FlashQKVPackedFn)
    assert dqkv.shape == qkv.shape
    np.testing.assert_allclose(out, out_j, **TOL)
    np.testing.assert_allclose(dqkv, dqkv_j, **TOL)


@pytest.mark.parametrize("n", [40, 100])
def test_functions_match_autograd_through_sdpa(rng, n):
    """The three Functions' grads equal autograd through the port's plain
    ``sdpa`` on the same (split) heads."""
    heads, d = 4, 16
    qkv = torch.from_numpy(_randn(rng, 2, n, 3 * heads * d))
    g = torch.from_numpy(_randn(rng, 2, n, heads * d))

    def grads(fn):
        t = qkv.clone().requires_grad_()
        fn(t).backward(g)
        return t.grad

    def via_sdpa(t):
        q, k, v = (fa.split_heads(x, heads) for x in t.chunk(3, dim=-1))
        return fa.merge_heads(fa.sdpa(q, k, v, d ** -0.5))

    def via_heads(t):
        q, k, v = (fa.split_heads(x, heads) for x in t.chunk(3, dim=-1))
        return fa.merge_heads(fa.flash_attention(q, k, v))

    want = grads(via_sdpa)
    torch.testing.assert_close(
        grads(lambda t: fa.flash_attention_packed(*t.chunk(3, dim=-1),
                                                  heads)), want, **TOL)
    torch.testing.assert_close(grads(via_heads), want, **TOL)
    torch.testing.assert_close(
        grads(lambda t: fa.flash_attention_qkvpacked(
            t.unflatten(-1, (3, heads, d))).flatten(-2)), want, **TOL)


def test_backward_reference_matches_jax_kernels(rng):
    """``flash_backward_reference`` alone against the JAX package's
    ``_flash_backward`` (the Pallas dQ/dKV pair, interpret mode), from the
    same forward residuals."""
    n, d = 100, 16
    q, k, v, g = (_randn(rng, 2, 3, n, d) for _ in range(4))
    out_j, lse_j = jax_flash._flash_forward(
        *(jnp.asarray(a) for a in (q, k, v)), d ** -0.5, 32, 32, True)
    want = jax_flash._flash_backward(
        *(jnp.asarray(a) for a in (q, k, v)), out_j, lse_j, jnp.asarray(g),
        d ** -0.5, 32, 32, True)
    lse = np.array(np.asarray(lse_j)[:, :n, 0].reshape(2, 3, n), copy=True)
    got = fa.flash_backward_reference(
        *(torch.from_numpy(a.copy()) for a in (q, k, v)),
        torch.from_numpy(np.array(out_j, copy=True)), torch.from_numpy(lse),
        torch.from_numpy(g.copy()), d ** -0.5)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)


def test_no_entry_returns_a_detached_result(rng):
    """Under autograd every entry returns a tensor with a graph, or
    raises: the lse (a backward residual) is refused, and a tensor off the
    CPU and off CUDA raises before any build or launch."""
    q, k, v = (torch.from_numpy(_randn(rng, 2, 40, 64)).requires_grad_()
               for _ in range(3))
    with pytest.raises(NotImplementedError, match="no_grad"):
        fa.flash_attention_packed(q, k, v, 4, with_lse=True)
    with torch.no_grad():
        out, lse = fa.flash_attention_packed(q, k, v, 4, with_lse=True)
        assert out.grad_fn is None and lse.shape == (2, 4, 40)
    meta = torch.empty((2, 64, 128), device="meta", requires_grad=True)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fa.flash_attention_packed(meta, meta, meta, 8)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fa.flash_attention(meta, meta, meta)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fa.flash_attention_qkvpacked(torch.empty(
            (2, 64, 3, 8, 16), device="meta", requires_grad=True))
