"""Port: the EMA of the parameters (``ema_decay``) against the JAX
package's train step, and the eval that scores it.

Two f32 steps of MobileNetLarge3D (A = 1 microbatch of (2, 8, 64, 64, 3),
dropout off) in both packages with ``ema_decay`` 0.9: the port's EMA is
d * ema + (1 - d) * p of its own parameters, bit for bit, and the JAX
step's ``ema_params`` within the parameters' bound of
``tests/test_torch_train_step.py`` (2 * lr a step, weighted by the
EMA). In ``train()`` the eval scores the EMA weights with the live
BatchNorm statistics, and the live weights come back after it.
"""

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
from picklebot_tpu_torch.models.mobilenet3d import MobileNetLarge3D
from picklebot_tpu_torch.train import checkpoint as ckpt
from picklebot_tpu_torch.train import loop
from picklebot_tpu_torch.train.optim import AdamW
from picklebot_tpu_torch.train.step import ema_init, make_train_step
from picklebot_tpu_torch.utils.config import Config
from test_torch_train_step import _no_dropout

LR, WD, DECAY = 1e-3, 5e-4, 0.9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel worker
    processes, and torch's OpenMP threads, each spinning at its barriers,
    slow every worker many times over once they outnumber the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_ema_after_two_steps_matches_jax():
    rng = np.random.RandomState(9)
    jm, port = JaxLarge3D(13), MobileNetLarge3D(13)
    opt = jax_optim.AdamW(weight_decay=WD)
    state = create_train_state(jm, opt, 0, ema=True)
    port.load_state_dict(state_dict_from_jax(
        flatten_dict(state.params), flatten_dict(state.model_state),
        "MobileNetLarge3D"))
    _no_dropout(jm, port)
    batches = [(rng.randint(0, 256, (1, 2, 8, 64, 64, 3)).astype(np.uint8),
                rng.randint(0, 13, (1, 2)).astype(np.int32))
               for _ in range(2)]

    step = jax_make_train_step(jm, opt, "CE", lambda e: jnp.float32(LR),
                               policy=DtypePolicy.f32(), donate=False,
                               ema_decay=DECAY)
    for i, (f, lbl) in enumerate(batches):
        state, _ = step(state, f, lbl, jax.random.key(i))
    want = state_dict_from_jax(flatten_dict(state.ema_params), {},
                               "MobileNetLarge3D")

    ema = ema_init(port)
    own = {n: p.detach().clone() for n, p in port.named_parameters()}
    train_step = make_train_step(port, AdamW(port.parameters(),
                                             weight_decay=WD), "CE",
                                 lambda e: LR, TorchPolicy.f32(),
                                 device="cpu", ema=ema, ema_decay=DECAY)
    d = np.float32(DECAY)
    for i, (f, lbl) in enumerate(batches):
        train_step(0, f, lbl, i)
        for n, p in port.named_parameters():
            own[n] = (own[n] * float(d) + p.detach() * float(1 - d))
    moved = 0
    for n, e in ema.items():
        assert e.dtype == torch.float32
        assert torch.equal(e, own[n]), n
        np.testing.assert_allclose(e.numpy(), want[n].numpy(), rtol=0,
                                   atol=LR, err_msg=n)
        p = dict(port.named_parameters())[n].detach()
        moved += not torch.equal(e, p)
    assert moved > 100


def test_the_eval_scores_the_ema_weights(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    seen = []
    real = loop.make_eval_step

    def make(model, *a, **k):
        fn = real(model, *a, **k)

        def eval_step(*args):
            seen.append({k: v.clone() for k, v in
                         model.state_dict().items()})
            return fn(*args)
        return eval_step

    monkeypatch.setattr(loop, "make_eval_step", make)
    cfg = Config(model_name="MobileNetLarge3D", num_classes=13,
                 criterion="CE", use_autocast=False, learning_rate=1e-2,
                 batch_size=2, effective_batch_size=2, max_iters=1,
                 data_backend="synthetic", synthetic_len=4,
                 synthetic_shape=[4, 32, 32], t_bucket=4, max_frames=4,
                 num_workers=1, optimizer="adamw", ema_decay=0.5,
                 checkpoint_dir=str(tmp_path / "ck"),
                 log_dir=str(tmp_path / "runs")).validate()
    summary = loop.train(cfg, device="cpu")
    assert len(seen) == 2 and np.isfinite(summary["final_val_loss"])
    fin = ckpt.load_checkpoint(ckpt.latest_checkpoint(
        str(tmp_path / "ck" / f"{cfg.run_name()}_finished")))
    pth = torch.load(summary["checkpoint"], weights_only=True)
    differ = 0
    for key, live in fin["model"].items():
        at_eval = seen[0][key]
        if key in fin["ema"]:
            assert torch.equal(at_eval, fin["ema"][key]), key
            differ += not torch.equal(fin["ema"][key], live)
        else:                       # BatchNorm buffers: the live ones
            assert torch.equal(at_eval, live), key
        assert torch.equal(pth[key], live), key   # live weights restored
    assert differ > 100
