"""Port: one f32 train step of each model against the JAX package's.

The same weights (JAX ``init`` with perturbed BatchNorm statistics, moved
through ``state_dict_from_jax``) and the same uint8 batch, A = 2
microbatches of (2, 8, 64, 64, 3), dropout p set to 0 on both instances.
The JAX reference is ``jax.value_and_grad`` of the CE loss through
``model.apply(train=True)`` per microbatch (BatchNorm state carried from
one to the next), the grads summed, then one JAX AdamW update; the port
runs ``make_train_step`` with its AdamW on the CPU. MobileViT-xxs runs the
``packed`` backend, so every layer's attention goes through the port's
``FlashPackedFn`` (plain forward with lse and ``flash_backward_reference``
on the CPU) and the JAX side through its Pallas kernels (interpret mode).
One JAX compile per model, in a module-scoped fixture.

Bounds: the loss within 2e-4; each gradient within 1e-3 of its leaf's
max|grad|, or of a tenth of the model's largest gradient where the leaf's
own is smaller than that. The float noise that backpropagation carries
through Large3D's 15 train-mode BatchNorms (batch 2) is about absolute:
it reaches 1.3e-3 of the leaf max at block2.1's depthwise weight, whose
largest gradient is 2.4% of the model's; and a bias that feeds a
train-mode BatchNorm (block1's and block6's convs) has gradient zero in
exact arithmetic, noise only. Parameters after one AdamW step within
2 * lr (Adam's first step is about lr * sign(g), so a noise-level gradient
may flip it); the BatchNorm running statistics within 1e-4.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from picklebot_tpu.core.module import DtypePolicy, flatten_dict
from picklebot_tpu.models.mobilenet3d import MobileNetLarge3D as JaxLarge3D
from picklebot_tpu.models.mobilevit import MobileViT as JaxMobileViT
from picklebot_tpu.ops import linear as jax_linear
from picklebot_tpu.train import losses as jax_losses
from picklebot_tpu.train import optim as jax_optim
from picklebot_tpu.train.step import preprocess as jax_preprocess
from picklebot_tpu_torch.convert import state_dict_from_jax
from picklebot_tpu_torch.core.policy import DtypePolicy as TorchPolicy
from picklebot_tpu_torch.models.mobilenet3d import MobileNetLarge3D
from picklebot_tpu_torch.models.mobilevit import MOBILEVIT_CONFIGS, MobileViT
from picklebot_tpu_torch.ops import flash_attention as fa
from picklebot_tpu_torch.ops.linear import ChannelDropout, Dropout
from picklebot_tpu_torch.train.optim import AdamW
from picklebot_tpu_torch.train.step import make_train_step
from test_torch_mobilenet3d import _perturb_batchnorm

A, B, CLIP = 2, 2, (8, 64, 64, 3)
LR, WD = 1e-3, 5e-4
XXS = MOBILEVIT_CONFIGS["xxs"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel worker
    processes, and torch's OpenMP threads, each spinning at its barriers,
    slow every worker many times over once they outnumber the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _models(name):
    if name == "MobileViT":
        return (JaxMobileViT(num_classes=13, attention_backend="packed",
                             **XXS),
                MobileViT(num_classes=13, attention_backend="packed", **XXS))
    return JaxLarge3D(13), MobileNetLarge3D(13)


def _no_dropout(jax_model, port):
    todo = [jax_model]
    while todo:
        m = todo.pop()
        if isinstance(m, (jax_linear.Dropout, jax_linear.ChannelDropout)):
            m.p = 0.0
        todo.extend(m.named_children().values())
    for m in port.modules():
        if isinstance(m, (Dropout, ChannelDropout)):
            m.p = 0.0


def _jax_step(jm, variables, feats, labels):
    policy = DtypePolicy.f32()

    def micro(params, state, x_u8, lbl):
        logits, new_state = jm.apply(
            {"params": params, "state": state},
            jax_preprocess(x_u8, jnp.float32), train=True,
            rng=jax.random.key(0), policy=policy)
        return jax_losses.cross_entropy(
            logits, jax_losses.prepare_labels("CE", lbl)), new_state

    value_and_grad = jax.jit(jax.value_and_grad(micro, has_aux=True))
    params, state = variables["params"], variables["state"]
    losses, grads = [], None
    for i in range(A):
        (loss, state), g = value_and_grad(params, state, feats[i], labels[i])
        losses.append(float(loss))
        grads = g if grads is None else jax.tree_util.tree_map(jnp.add,
                                                               grads, g)
    opt = jax_optim.AdamW(weight_decay=WD)
    new_params, _ = opt.update(grads, opt.init(params), params,
                               jnp.float32(LR))
    return losses, grads, state, new_params


@pytest.fixture(scope="module", params=["MobileViT", "MobileNetLarge3D"])
def step(request):
    """(name, JAX results in the port's keys and layouts, the port model
    after its step, its metrics, FlashPackedFn calls)."""
    name = request.param
    rng = np.random.RandomState(1234)
    jm, port = _models(name)
    v = _perturb_batchnorm(jm.init(0), rng)
    port.load_state_dict(state_dict_from_jax(
        flatten_dict(v["params"]), flatten_dict(v["state"]), name))
    _no_dropout(jm, port)
    feats = rng.randint(0, 256, (A, B) + CLIP).astype(np.uint8)
    labels = rng.randint(0, 13, (A, B))

    losses, grads, state, new_params = _jax_step(jm, v, feats, labels)
    want = {
        "grads": state_dict_from_jax(flatten_dict(grads), {}, name),
        "params": state_dict_from_jax(flatten_dict(new_params), {}, name),
        "state": state_dict_from_jax({}, flatten_dict(state), name),
        "losses": losses}

    calls = []
    apply = fa.FlashPackedFn.apply
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fa.FlashPackedFn, "apply",
                   lambda *a: calls.append(1) or apply(*a))
        metrics = make_train_step(
            port, AdamW(port.parameters(), weight_decay=WD), "CE",
            lambda epoch: LR, TorchPolicy.f32(), device="cpu")(
                0, feats, labels)
    return name, want, port, metrics, len(calls)


def test_train_step_loss_matches_jax(step):
    name, want, port, metrics, flash_calls = step
    np.testing.assert_allclose(metrics["loss"].numpy(), want["losses"],
                               rtol=2e-4, atol=2e-4)
    assert metrics["samples"] == A * B and metrics["lr"] == LR
    # every MobileViT-xxs layer (2 + 4 + 3) per microbatch, none in Large3D
    assert flash_calls == (9 * A if name == "MobileViT" else 0)


def test_train_step_grads_match_jax(step):
    _, want, port, _, _ = step
    grads = dict(port.named_parameters())
    assert set(grads) == set(want["grads"])
    top = max(float(g.abs().max()) for g in want["grads"].values())
    for key, g in want["grads"].items():
        g = g.numpy()
        np.testing.assert_allclose(grads[key].grad.numpy(), g, rtol=0,
                                   atol=1e-3 * max(np.abs(g).max(),
                                                   0.1 * top), err_msg=key)


def test_train_step_adamw_params_match_jax(step):
    _, want, port, _, _ = step
    got = dict(port.named_parameters())
    for key, p in want["params"].items():
        np.testing.assert_allclose(got[key].detach().numpy(), p.numpy(),
                                   rtol=0, atol=2 * LR, err_msg=key)


def test_train_step_batchnorm_statistics_match_jax(step):
    _, want, port, _, _ = step
    buffers = dict(port.named_buffers())
    stats = [k for k in want["state"] if k.endswith(("running_mean",
                                                     "running_var"))]
    assert stats
    for key in stats:
        np.testing.assert_allclose(buffers[key].numpy(),
                                   want["state"][key].numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=key)
        tracked = key.rsplit(".", 1)[0] + ".num_batches_tracked"
        assert int(buffers[tracked]) == A
