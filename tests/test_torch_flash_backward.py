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

The bf16 cases hold the rounding points that the bf16 kernels must keep
(P to dO's dtype before dV, dS to the inputs' dtype before dQ and dK, each
output cast once) on the same inputs, rounded to bf16 once and handed to
both sides, at head dims 16, 32 and 64. Bound: max abs err within two bf16
ulps at the top of the range, 2^-6 of max|ref| (the roundings of the two
sides differ where the forward outputs do: the port's plain forward
rounds normalized probabilities, the Pallas one unnormalized; measured at
most one ulp, 2^-7), and rms err within 1% of rms(ref) as ``chip_smoke.py``
holds the kernels (measured under 0.3%).
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
BF16_MAX_TOL, BF16_RMS_TOL = 2.0 ** -6, 1e-2
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


def _bf16(rng, *shape):
    """Seeded normal values rounded to bf16 once: the port's tensor and
    the f32 numpy array (exact) that JAX rounds to the same bf16."""
    t = torch.from_numpy(_randn(rng, *shape)).to(torch.bfloat16)
    return t, t.float().numpy()


def _check_bf16(got, want, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    err = np.abs(got - want)
    assert err.max() <= BF16_MAX_TOL * np.abs(want).max(), name
    assert np.sqrt((err ** 2).mean()) <= BF16_RMS_TOL * np.sqrt(
        (want ** 2).mean()), name


def _jax_bf16(a):
    return jnp.asarray(a, jnp.bfloat16)


@pytest.mark.parametrize("n", [40, 100])
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("layout", ["packed", "heads", "qkvpacked"])
def test_bf16_backward_matches_jax(rng, layout, d, n):
    """The three Functions' bf16 grads (CPU: plain forward with lse and
    ``flash_backward_reference``) against ``jax.vjp`` through the Pallas
    kernels in bf16 (interpret mode, block 32, ragged N)."""
    if layout == "packed":
        heads = 128 // d
        shape = (2, n, 128)
        jax_fn = lambda q, k, v: jax_packed.flash_attention_packed(  # noqa
            q, k, v, heads, **BLOCKS)
        port_fn = lambda q, k, v: fa.flash_attention_packed(  # noqa
            q, k, v, heads)
        ins = [_bf16(rng, *shape) for _ in range(3)]
        g = _bf16(rng, *shape)
    elif layout == "heads":
        shape = (2, 2, n, d)
        jax_fn = lambda q, k, v: jax_flash.flash_attention(  # noqa
            q, k, v, **BLOCKS)
        port_fn = fa.flash_attention
        ins = [_bf16(rng, *shape) for _ in range(3)]
        g = _bf16(rng, *shape)
    else:
        jax_fn = lambda t: jax_flash.flash_attention_qkvpacked(  # noqa
            t, **BLOCKS)
        port_fn = fa.flash_attention_qkvpacked
        ins = [_bf16(rng, 2, n, 3, 2, d)]
        g = _bf16(rng, 2, n, 2, d)
    _, vjp = jax.vjp(jax_fn, *(_jax_bf16(a) for _, a in ins))
    want = vjp(_jax_bf16(g[1]))
    ts = [t.clone().requires_grad_() for t, _ in ins]
    out = port_fn(*ts)
    assert out.dtype == torch.bfloat16
    out.backward(g[0])
    for i, (t, w) in enumerate(zip(ts, want)):
        assert t.grad.dtype == torch.bfloat16
        _check_bf16(t.grad.float().numpy(), w.astype(jnp.float32),
                    f"{layout} grad {i}")


@pytest.mark.parametrize("n", [40, 100])
@pytest.mark.parametrize("d", [16, 32, 64])
def test_bf16_backward_reference_matches_jax_kernels(rng, d, n):
    """``flash_backward_reference`` in bf16 against the JAX package's
    ``_flash_backward`` (the Pallas dQ/dKV pair, interpret mode) from the
    same bf16 forward residuals (the JAX forward's output and lse)."""
    (q, qn), (k, kn), (v, vn), (g, gn) = (_bf16(rng, 2, 3, n, d)
                                          for _ in range(4))
    jq, jk, jv, jg = (_jax_bf16(a) for a in (qn, kn, vn, gn))
    out_j, lse_j = jax_flash._flash_forward(jq, jk, jv, d ** -0.5, 32, 32,
                                            True)
    want = jax_flash._flash_backward(jq, jk, jv, out_j, lse_j, jg,
                                     d ** -0.5, 32, 32, True)
    lse = np.array(np.asarray(lse_j)[:, :n, 0].reshape(2, 3, n), copy=True)
    out = torch.from_numpy(np.array(out_j.astype(jnp.float32),
                                    copy=True)).to(torch.bfloat16)
    got = fa.flash_backward_reference(q, k, v, out, torch.from_numpy(lse), g,
                                      d ** -0.5)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16
        _check_bf16(a.float().numpy(), b.astype(jnp.float32), name)


# MobileViT-s's attention at bs 8: 64 sequences, 8 heads of 16, per stage N
_VIT = dict(s=64, h=8, d=16)


@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("n", [784, 147, 32])
def test_backward_plan(n, d):
    """The backward kernels' plan: bf16 on the tensor-core kernels (4
    warps), f32 on the FMA ones (one thread per row), one block per
    (sequence, head, 64-row tile) either way."""
    s, h = _VIT["s"], 128 // d
    tiles = -(-n // 64)
    assert fa._backward_plan((s, h, n, d), torch.bfloat16) == \
        fa.BackwardPlan("mma", 128, 64, s * h * tiles)
    assert fa._backward_plan((s, h, n, d), torch.float32) == \
        fa.BackwardPlan("fma", 64, 64, s * h * tiles)
    with pytest.raises(ValueError, match="head dim"):
        fa._backward_plan((s, h, n, 8), torch.bfloat16)


def _backward_views(layout, n, qkv):
    """The backward kernels' views, as each Function builds them, of a
    (S, N, 3*H*D) projection output (its chunks, heads or (3, H, D)
    view)."""
    s, h, d = qkv.shape[0], _VIT["h"], _VIT["d"]
    out = torch.zeros(s, n, h * d, dtype=qkv.dtype)
    lse = torch.zeros(s, h, n)
    if layout == "packed":
        q, k, v = qkv.chunk(3, dim=-1)
        return fa._packed_backward_views(q, k, v, out, lse, out, h)[1]
    if layout == "heads":
        q, k, v = (fa.split_heads(t, h) for t in qkv.chunk(3, dim=-1))
        o = fa.split_heads(out, h).contiguous()
        return fa._heads_backward_views(q, k, v, o, lse, o)[1]
    qkv5 = qkv.unflatten(-1, (3, h, d))
    o5 = out.unflatten(-1, (h, d))
    return fa._qkvpacked_backward_views(qkv5, o5, lse, o5)[1]


def _aligned(views):
    return fa._rows_aligned16([t.data_ptr() for t in views],
                              fa._strides(views), views[0].shape[:3])


@pytest.mark.parametrize("layout", ["packed", "heads", "qkvpacked"])
@pytest.mark.parametrize("n", [784, 147, 32])
def test_backward_views_are_16_byte_aligned(layout, n):
    """Every view the three Functions hand the bf16 kernels at MobileViT-s's
    shapes starts its rows on 16 bytes; the same views shifted by one
    element, or with a token stride that is no multiple of 8, do not, and
    the launch refuses them before any build or copy."""
    qkv = torch.zeros(2, n, 3 * 128, dtype=torch.bfloat16)
    views = _backward_views(layout, n, qkv)
    assert len(views) == 9 and views[5].dtype == torch.float32
    kernel_views = views[:5] + views[6:]
    assert all(t.shape == (2, 8, n, 16) for t in kernel_views)
    assert _aligned(kernel_views)

    shifted = torch.zeros(2 * n * 3 * 128 + 1,
                          dtype=torch.bfloat16)[1:].view(2, n, 3 * 128)
    wide = torch.zeros(2, n, 3 * 128 + 4, dtype=torch.bfloat16)[..., :384]
    for bad in (shifted, wide):
        q4, k4, v4, _, g4, lse3, *grads = _backward_views(layout, n, bad)
        assert not _aligned((q4, k4, v4, g4, *grads))
        launches = dict(fa.LAUNCHES)
        with pytest.raises(ValueError, match="16 bytes"):
            fa._launch_backward_kernel("dq", q4, k4, v4, g4, lse3,
                                       torch.zeros(lse3.shape), *grads, 0.25)
        assert fa.LAUNCHES == launches
    # f32 runs on the FMA kernels, which take any row start
    assert fa._backward_plan(views[0].shape, torch.float32).kernel == "fma"
