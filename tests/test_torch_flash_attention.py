"""Port: the flash-attention plain versions against the JAX kernels.

The JAX side runs its Pallas kernels in interpret mode on the CPU, as
tests/test_flash_packed.py and tests/test_pallas_attention.py do, at
block_q = block_k = 32 so that N = 40 and 100 are ragged and span several
blocks. The port's wrappers take their plain PyTorch versions for CPU
tensors. Same numpy inputs into both, f32. Tolerance 2e-4 (rtol and atol):
the same f32 softmax attention summed in another order (blockwise online
softmax against one softmax), the bound the JAX package's own kernel tests
use.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from picklebot_tpu.ops.pallas import flash_attention as jax_flash
from picklebot_tpu.ops.pallas import flash_packed as jax_packed
from picklebot_tpu_torch.ops import flash_attention as fa

TOL = dict(rtol=2e-4, atol=2e-4)
BLOCKS = dict(block_q=32, block_k=32)


def _qkv(rng, shape):
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


def _t(a):
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("lead", [(2,), (2, 3)])
@pytest.mark.parametrize("n", [40, 100])
@pytest.mark.parametrize("heads", [4, 8])
def test_packed_matches_jax(rng, heads, n, lead):
    q, k, v = _qkv(rng, lead + (n, heads * 16))
    want = jax_packed.flash_attention_packed(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads, **BLOCKS)
    before = dict(fa.LAUNCHES)
    got = fa.flash_attention_packed(_t(q), _t(k), _t(v), heads)
    assert fa.LAUNCHES == before          # a CPU tensor launches no kernel
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("n", [40, 100])
def test_packed_lse_matches_jax(rng, n):
    """The port's lse (..., H, N) against the JAX forward's, which is
    (batch, N', H*D) replicated over each head's D lanes: take one lane
    per head and trim the padded rows."""
    heads, d = 8, 16
    q, k, v = _qkv(rng, (2, n, heads * d))
    out_j, lse_j = jax_packed._packed_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads, d ** -0.5,
        32, 32, interpret=True, with_lse=True)
    lse_j = np.asarray(lse_j)[:, :n, ::d].transpose(0, 2, 1)   # (2, H, N)
    out, lse = fa.flash_attention_packed(_t(q), _t(k), _t(v), heads,
                                         with_lse=True)
    assert lse.shape == (2, heads, n) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(lse.numpy(), lse_j, **TOL)


@pytest.mark.parametrize("n", [40, 100])
def test_per_head_matches_jax(rng, n):
    q, k, v = _qkv(rng, (2, 3, n, 16))
    want = jax_flash.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), **BLOCKS)
    before = dict(fa.LAUNCHES)
    got = fa.flash_attention(_t(q), _t(k), _t(v))
    assert fa.LAUNCHES == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("n", [40, 100])
def test_qkvpacked_matches_jax(rng, n):
    qkv = rng.randn(2, n, 3, 4, 16).astype(np.float32)
    want = jax_flash.flash_attention_qkvpacked(jnp.asarray(qkv), **BLOCKS)
    before = dict(fa.LAUNCHES)
    got = fa.flash_attention_qkvpacked(_t(qkv))
    assert fa.LAUNCHES == before
    assert got.shape == (2, n, 4, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_packed_equals_per_head_on_split_heads(rng):
    """The two entries are one function on two layouts: the packed plain
    version equals the per-head one on split heads, lse included."""
    q, k, v = (_t(a) for a in _qkv(rng, (2, 50, 64)))
    out, lse = fa.flash_attention_packed(q, k, v, 4, with_lse=True)
    split = [fa.split_heads(t, 4) for t in (q, k, v)]
    want, want_lse = fa.sdpa(*split, 16 ** -0.5, with_lse=True)
    torch.testing.assert_close(out, fa.merge_heads(want))
    torch.testing.assert_close(lse, want_lse)
    torch.testing.assert_close(fa.flash_attention(*split), want)


def test_kernel_wrappers_refuse_non_cuda_tensors(rng):
    """A tensor that is neither on the CPU nor on CUDA raises before any
    build or launch: no quiet fallback to the plain version."""
    meta = torch.empty((2, 64, 128), device="meta")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fa.flash_attention_packed(meta, meta, meta, 8)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fa.flash_attention(meta, meta, meta)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fa.flash_attention_qkvpacked(torch.empty((2, 64, 3, 8, 16),
                                                 device="meta"))


# bf16: the bound chip_smoke.py holds the forward kernel to. The Pallas
# kernel rounds P per block unnormalised (p.astype(v.dtype) before the PV
# product, then acc / l), while the plain version rounds the normalised
# probabilities; both round the output once. So outputs differ by a few
# bf16 ulps of their own size: max abs err within 3% of max|ref|, rms err
# within 1% of rms(ref). The lse is f32 arithmetic on the same bf16 inputs
# on both sides, held to the f32 bound above.
BF16_MAX_TOL, BF16_RMS_TOL = 3e-2, 1e-2


def _bf16(rng, *shape):
    """Seeded normal values rounded to bf16 once: the port's tensor and
    the JAX array of the same bf16 values."""
    t = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
        torch.bfloat16)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _check_bf16(got, want, name):
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape, name
    err = np.abs(got - want)
    assert err.max() <= BF16_MAX_TOL * np.abs(want).max(), name
    assert np.sqrt((err ** 2).mean()) <= BF16_RMS_TOL * np.sqrt(
        (want ** 2).mean()), name


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("n", [40, 100])
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("layout", ["packed", "heads", "qkvpacked"])
def test_bf16_forward_matches_jax(rng, layout, d, n, with_lse):
    """The three forward entries' bf16 plain versions (what the bf16
    kernel is held to on the card) against the JAX Pallas forwards in
    bf16 (interpret mode, block 32, ragged N), with and without lse."""
    heads = 128 // d
    scale = d ** -0.5
    if layout == "packed":
        (q, jq), (k, jk), (v, jv) = (_bf16(rng, 2, n, 128) for _ in range(3))
        out_j, lse_j = jax_packed._packed_forward(
            jq, jk, jv, heads, scale, 32, 32, interpret=True,
            with_lse=with_lse)
        if with_lse:                  # one lane per head, padded rows cut
            lse_j = np.asarray(lse_j)[:, :n, ::d].transpose(0, 2, 1)
        res = fa.flash_attention_packed(q, k, v, heads, with_lse=with_lse)
    elif layout == "heads":
        (q, jq), (k, jk), (v, jv) = (_bf16(rng, 2, heads, n, d)
                                     for _ in range(3))
        out_j, lse_j = jax_flash._flash_forward(jq, jk, jv, scale, 32, 32,
                                                True)
        lse_j = np.asarray(lse_j)[:, :n, 0].reshape(2, heads, n)
        res = fa._heads_forward(q, k, v, scale, with_lse)
        res = res if with_lse else res[0]
    else:
        qkv, jqkv = _bf16(rng, 2, n, 3, heads, d)
        jq, jk, jv = (jnp.moveaxis(jqkv[..., i, :, :], -2, -3)
                      for i in range(3))
        out_j, lse_j = jax_flash._flash_forward(jq, jk, jv, scale, 32, 32,
                                                True)
        out_j = jnp.moveaxis(out_j, -3, -2)
        lse_j = np.asarray(lse_j)[:, :n, 0].reshape(2, heads, n)
        res = fa._qkvpacked_forward(qkv, scale, with_lse)
        res = res if with_lse else res[0]
    out, lse = res if with_lse else (res, None)
    assert out.dtype == torch.bfloat16
    _check_bf16(out, out_j, f"{layout} out")
    if with_lse:
        assert lse.dtype == torch.float32 and lse.shape == (2, heads, n)
        np.testing.assert_allclose(lse.numpy(), lse_j, **TOL)


# MobileViT-s's attention at bs 8: 64 sequences, 8 heads of 16, per stage N
_VIT = dict(s=64, h=8, d=16)


@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("n", [784, 147, 32])
def test_forward_plan(n, d):
    """The forward kernel's plan: bf16 on the tensor-core kernel (4 warps
    of 16 query rows), f32 on the FMA one (one thread per query row), one
    block per (sequence, head, 64-query tile) either way; a head dim the
    kernels do not take is refused."""
    s, h = _VIT["s"], 128 // d
    blocks = s * h * -(-n // 64)
    assert fa._forward_plan((s, h, n, d), torch.bfloat16) == \
        fa.ForwardPlan("mma", 128, 64, blocks)
    assert fa._forward_plan((s, h, n, d), torch.float32) == \
        fa.ForwardPlan("fma", 64, 64, blocks)
    with pytest.raises(ValueError, match="head dim"):
        fa._forward_plan((s, h, n, 8), torch.bfloat16)


def _forward_views(layout, qkv, with_lse):
    """The forward kernel's views, as each entry builds them, of a
    (S, N, 3*H*D) projection output (its chunks, split heads or the
    (3, H, D) view)."""
    h, d = _VIT["h"], _VIT["d"]
    if layout == "packed":
        return fa._packed_forward_views(*qkv.chunk(3, dim=-1), h,
                                        with_lse)[2]
    if layout == "heads":
        return fa._heads_forward_views(
            *(fa.split_heads(t, h) for t in qkv.chunk(3, dim=-1)),
            with_lse)[2]
    return fa._qkvpacked_forward_views(qkv.unflatten(-1, (3, h, d)),
                                       with_lse)[2]


def _aligned(views):
    return fa._rows_aligned16([t.data_ptr() for t in views],
                              fa._strides(views), views[0].shape[:3])


@pytest.mark.parametrize("layout", ["packed", "heads", "qkvpacked"])
@pytest.mark.parametrize("n", [784, 147, 32])
def test_forward_views_are_16_byte_aligned(layout, n):
    """Every view the three forward entries hand the bf16 kernel at
    MobileViT-s's shapes starts its rows on 16 bytes; the same views
    shifted by one element, or with a token stride that is no multiple of
    8, do not, and the launch refuses them before any build or copy."""
    qkv = torch.zeros(2, n, 3 * 128, dtype=torch.bfloat16)
    *views, lse3 = _forward_views(layout, qkv, True)
    assert all(t.shape == (2, 8, n, 16) for t in views)
    assert lse3.shape == (2, 8, n) and lse3.stride(-1) == 1
    assert _aligned(views)

    shifted = torch.zeros(2 * n * 3 * 128 + 1,
                          dtype=torch.bfloat16)[1:].view(2, n, 3 * 128)
    wide = torch.zeros(2, n, 3 * 128 + 4, dtype=torch.bfloat16)[..., :384]
    for bad in (shifted, wide):
        *views, lse3 = _forward_views(layout, bad, False)
        assert lse3 is None and not _aligned(views)
        launches = dict(fa.LAUNCHES)
        with pytest.raises(ValueError, match="16 bytes"):
            fa._launch(*views, None, 0.25)
        assert fa.LAUNCHES == launches
    # f32 runs on the FMA kernel, which takes any row start
    assert fa._forward_plan(views[0].shape, torch.float32).kernel == "fma"
