"""Port: training-time augmentation (``data/augment.py``) against the JAX
package's ``apply_augment``.

The JAX function draws from threefry keys salted off the microbatch key;
the port draws from a seeded ``torch.Generator``. The draws' bits differ,
so the JAX function's own draws (recomputed here from the same key) are
handed to the port's ``apply_augment``: the outputs agree within 1e-6 of
max|x| in f32. In the train step a disabled ``Augment`` leaves the step
bit-identical, and augmenting does not move the dropout stream.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from picklebot_tpu.data import augment as jax_augment
from picklebot_tpu_torch.core.policy import DtypePolicy
from picklebot_tpu_torch.data.augment import (Augment, Draws, apply_augment,
                                              draw_augment)
from picklebot_tpu_torch.models.mobilenet3d import MobileNetLarge3D
from picklebot_tpu_torch.ops import linear
from picklebot_tpu_torch.train.optim import AdamW
from picklebot_tpu_torch.train.step import make_train_step


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel worker
    processes, and torch's OpenMP threads, each spinning at its barriers,
    slow every worker many times over once they outnumber the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_draws(aug, b, key):
    """The draws ``picklebot_tpu/data/augment.py`` makes from ``key``."""
    key = jax.random.fold_in(key, jax_augment._AUG_SALT)
    k_flip, k_crop, k_bright = jax.random.split(key, 3)
    p = int(aug.crop)
    flip = jax.random.bernoulli(k_flip, 0.5, (b,))
    oy = jax.random.randint(k_crop, (b,), 0, 2 * p + 1)
    ox = jax.random.randint(jax.random.fold_in(k_crop, 1), (b,), 0,
                            2 * p + 1)
    scale = 1.0 + jax.random.uniform(k_bright, (b,),
                                     minval=-aug.brightness,
                                     maxval=aug.brightness)
    t = lambda a: torch.from_numpy(np.array(a, copy=True))  # noqa: E731
    return Draws(t(flip) if aug.flip else None,
                 t(oy) if aug.crop else None, t(ox) if aug.crop else None,
                 t(scale) if aug.brightness else None)


@pytest.mark.parametrize("flip,crop,brightness", [
    (True, 0, 0.0), (False, 5, 0.0), (False, 0, 0.3), (True, 4, 0.2),
    (True, 1, 0.5)])
def test_apply_augment_matches_jax_given_its_draws(flip, crop, brightness):
    rng = np.random.RandomState(3)
    x = rng.rand(6, 3, 16, 12, 3).astype(np.float32)
    aug = Augment(flip, crop, brightness)
    key = jax.random.key(17)
    want = np.asarray(jax_augment.apply_augment(
        jnp.asarray(x), jax_augment.Augment(flip, crop, brightness), key))
    draws = _jax_draws(aug, x.shape[0], key)
    got = apply_augment(torch.from_numpy(x.copy()), draws, crop).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    assert not np.array_equal(got, x)


def test_draws_are_keyed_on_the_position_and_independent():
    aug = Augment(True, 4, 0.2)
    a, b = draw_augment(aug, 8, 0, 5), draw_augment(aug, 8, 0, 5)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    c = draw_augment(aug, 8, 0, 6)
    assert not torch.equal(a.scale, c.scale)
    # turning one on moves none of the others
    only_crop = draw_augment(Augment(False, 4, 0.0), 8, 0, 5)
    assert torch.equal(only_crop.oy, a.oy) and only_crop.flip is None
    assert only_crop.scale is None
    assert a.oy.min() >= 0 and a.oy.max() <= 8
    assert ((a.scale >= 0.8) & (a.scale <= 1.2)).all()


def _step(augment, masks=None):
    torch.manual_seed(0)
    model = MobileNetLarge3D(13, seed=1)
    rng = np.random.RandomState(0)
    feats = rng.randint(0, 256, (2, 2, 4, 32, 32, 3)).astype(np.uint8)
    labels = rng.randint(0, 13, (2, 2))
    step = make_train_step(model, AdamW(model.parameters()), "CE",
                           lambda e: 1e-3, DtypePolicy.f32(),
                           mean=[0.4, 0.5, 0.6], std=[0.2, 0.3, 0.25],
                           seed=7, device="cpu", augment=augment)
    if masks is None:
        metrics = step(0, feats, labels, 4)
    else:
        real = linear.dropout_mask

        def record(*a, **k):
            masks.append(real(*a, **k))
            return masks[-1]
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(linear, "dropout_mask", record)
            metrics = step(0, feats, labels, 4)
    return model, metrics


def test_disabled_augment_leaves_the_step_bit_identical():
    ref, m_ref = _step(None)
    off, m_off = _step(Augment())
    on, m_on = _step(Augment(flip=True, crop=2, brightness=0.1))
    assert torch.equal(m_ref["loss"], m_off["loss"])
    assert not torch.equal(m_ref["loss"], m_on["loss"])
    for (n, a), b in zip(ref.state_dict().items(),
                         off.state_dict().values()):
        assert torch.equal(a, b), n


def test_augment_does_not_move_the_dropout_stream():
    plain, aug = [], []
    _step(None, plain)
    _step(Augment(flip=True, crop=3, brightness=0.3), aug)
    assert len(plain) == len(aug) == 2 * 15     # 15 channel dropouts
    for a, b in zip(plain, aug):
        assert torch.equal(a, b)
