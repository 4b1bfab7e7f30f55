"""Port: activation rematerialization (``remat``, ``core/remat.py``).

``remat`` 1 and 2 give the gradients, losses and BatchNorm buffers of
``remat`` 0 bit for bit on the CPU with dropout on (the recompute
replays the dropout generator's draws and leaves the running statistics
alone), keep every ``state_dict`` key, and run each wrapped call's
forward once more in the backward (MobileNetLarge3D's 15 bottleneck
calls per microbatch become 30; MobileViT-xxs's 9 ``FlashPackedFn`` calls
become 18 at ``remat`` 1 and 27 at 2, where the level-2 transformer
recomputes its attention once more). One f32 step with ``remat`` 1 is held
against the JAX step with ``remat=1`` to the bounds of
``tests/test_torch_train_step.py``.
"""

import copy

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from picklebot_tpu.core.module import DtypePolicy, flatten_dict
from picklebot_tpu.models.mobilenet3d import MobileNetLarge3D as JaxLarge3D
from picklebot_tpu.train import optim as jax_optim
from picklebot_tpu.train.step import create_train_state
from picklebot_tpu.train.step import make_train_step as jax_make_train_step
from picklebot_tpu_torch.convert import state_dict_from_jax
from picklebot_tpu_torch.core.policy import DtypePolicy as TorchPolicy
from picklebot_tpu_torch.core.remat import apply_remat
from picklebot_tpu_torch.models.mobilenet3d import MobileNetLarge3D
from picklebot_tpu_torch.models.mobilevit import MOBILEVIT_CONFIGS, MobileViT
from picklebot_tpu_torch.ops import flash_attention as fa
from picklebot_tpu_torch.ops.bottleneck import Bottleneck3D
from picklebot_tpu_torch.train.optim import AdamW
from picklebot_tpu_torch.train.step import make_train_step
from test_torch_mobilenet3d import _perturb_batchnorm
from test_torch_train_step import _no_dropout

LR, WD = 1e-3, 5e-4
A = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel worker
    processes, and torch's OpenMP threads, each spinning at its barriers,
    slow every worker many times over once they outnumber the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# model, the call counted, its calls per microbatch at remat 0, 1 and 2:
# the bottlenecks are calls of the root (level 1), so level 2 reruns
# only their insides; MobileViT's attention sits at level 3, under a
# level-1 block and a level-2 transformer, each of which recomputes it
MODELS = {
    "MobileNetLarge3D": (lambda: MobileNetLarge3D(13, seed=3),
                         (Bottleneck3D, "forward"), (15, 30, 30)),
    "MobileViT": (lambda: MobileViT(num_classes=13, seed=3,
                                    attention_backend="packed",
                                    **MOBILEVIT_CONFIGS["xxs"]),
                  (fa.FlashPackedFn, "apply"), (9, 18, 27))}


def _run(name, remat):
    make, (owner, attr), _ = MODELS[name]
    rng = np.random.RandomState(2)
    feats = rng.randint(0, 256, (A, 2, 4, 32, 32, 3)).astype(np.uint8)
    labels = rng.randint(0, 13, (A, 2))
    calls = []
    real = getattr(owner, attr)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(owner, attr,
                   lambda *a, **k: calls.append(1) or real(*a, **k))
        model = make()
        step = make_train_step(model, AdamW(model.parameters(),
                                            weight_decay=WD), "CE",
                               lambda e: LR, TorchPolicy.f32(), seed=5,
                               device="cpu", remat=remat)
        metrics = step(0, feats, labels, 6)
    return model, metrics, len(calls)


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("remat", [1, 2])
def test_remat_gives_bit_identical_gradients(name, remat):
    ref, m_ref, calls_ref = _run(name, 0)
    got, m_got, calls = _run(name, remat)
    per_micro = MODELS[name][2]
    assert calls_ref == A * per_micro[0] and calls == A * per_micro[remat]
    assert torch.equal(m_got["loss"], m_ref["loss"])
    assert ref.state_dict().keys() == got.state_dict().keys()
    for (n, a), b in zip(ref.named_parameters(), got.parameters()):
        assert (a.grad is None) == (b.grad is None), n
        if a.grad is not None:
            assert torch.equal(a.grad, b.grad), n
        assert torch.equal(a, b), n
    for (n, a), b in zip(ref.named_buffers(), got.buffers()):
        assert torch.equal(a, b), n          # the statistics moved once
        if n.endswith("num_batches_tracked"):
            assert int(b) == A, n


def test_apply_remat_zero_takes_the_wrappers_off():
    model = MobileNetLarge3D(13)
    apply_remat(model, 2)
    assert "forward" in model.block2[0].__dict__
    assert "forward" not in model.__dict__
    # a deep copy's wrappers call the copy's own modules
    twin = copy.deepcopy(model)
    assert twin.block2[0].forward.module is twin.block2[0]
    apply_remat(model, 0)
    assert not any("forward" in m.__dict__ for m in model.modules())


def test_remat_step_matches_jax():
    name = "MobileNetLarge3D"
    rng = np.random.RandomState(8)
    jm, port = JaxLarge3D(13), MobileNetLarge3D(13)
    opt = jax_optim.AdamW(weight_decay=WD)
    state = create_train_state(jm, opt, 0)
    v = _perturb_batchnorm({"params": state.params,
                            "state": state.model_state}, rng)
    state = state._replace(model_state=v["state"])
    port.load_state_dict(state_dict_from_jax(
        flatten_dict(v["params"]), flatten_dict(v["state"]), name))
    _no_dropout(jm, port)
    feats = rng.randint(0, 256, (A, 2, 8, 64, 64, 3)).astype(np.uint8)
    labels = rng.randint(0, 13, (A, 2)).astype(np.int32)
    step = jax_make_train_step(jm, opt, "CE", lambda e: jnp.float32(LR),
                               policy=DtypePolicy.f32(), donate=False,
                               remat=1)
    new, metrics = step(state, feats, labels, jax.random.key(0))
    got = make_train_step(port, AdamW(port.parameters(), weight_decay=WD),
                          "CE", lambda e: LR, TorchPolicy.f32(),
                          device="cpu", remat=1)(0, feats, labels)
    np.testing.assert_allclose(got["loss"].numpy(),
                               np.asarray(metrics["loss"]), rtol=2e-4,
                               atol=2e-4)
    params = dict(port.named_parameters())
    for key, p in state_dict_from_jax(flatten_dict(new.params), {},
                                      name).items():
        np.testing.assert_allclose(params[key].detach().numpy(), p.numpy(),
                                   rtol=0, atol=2 * LR, err_msg=key)
    buffers = dict(port.named_buffers())
    for key, s in state_dict_from_jax({}, flatten_dict(new.model_state),
                                      name).items():
        if key.endswith("num_batches_tracked"):
            assert int(buffers[key]) == A
        else:
            np.testing.assert_allclose(buffers[key].numpy(), s.numpy(),
                                       rtol=1e-4, atol=1e-4, err_msg=key)
