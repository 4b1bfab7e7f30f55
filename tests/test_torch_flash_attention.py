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
