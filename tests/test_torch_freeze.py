"""Port: ``freeze_params`` (``train/freeze.py``) against the JAX
package's ``freeze_mask`` and its train step with ``frozen_mask``.

The patterns name JAX parameter paths; the port matches them on each
parameter's JAX path (``convert.jax_param_path``, the key table
inverted), so the frozen set, mapped through the key table, is the JAX
mask's for the same patterns. One f32 step of MobileNetLarge3D with the
stem and one bottleneck frozen and the gradient clipped (the JAX step's
``frozen_mask``, the port's ``requires_grad=False``): frozen parameters
stay bit-identical to their start, the rest are held to the bounds of
``tests/test_torch_train_step.py``, the clip norm leaves the frozen
gradients out in both.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from picklebot_tpu.core.module import DtypePolicy, flatten_dict
from picklebot_tpu.models.registry import initialize_model as jax_model
from picklebot_tpu.train import freeze as jax_freeze
from picklebot_tpu.train import optim as jax_optim
from picklebot_tpu.train.step import create_train_state
from picklebot_tpu.train.step import make_train_step as jax_make_train_step
from picklebot_tpu.utils.config import Config as JaxConfig
from picklebot_tpu_torch.convert import (_torch_key, jax_param_path,
                                         state_dict_from_jax)
from picklebot_tpu_torch.core.policy import DtypePolicy as TorchPolicy
from picklebot_tpu_torch.models.mobilevit import MOBILEVIT_CONFIGS
from picklebot_tpu_torch.models.registry import initialize_model
from picklebot_tpu_torch.train.freeze import freeze, freeze_mask
from picklebot_tpu_torch.train.optim import AdamW
from picklebot_tpu_torch.train.step import make_train_step
from picklebot_tpu_torch.utils.config import Config
from test_torch_mobilenet3d import _perturb_batchnorm
from test_torch_train_step import _no_dropout

LR, WD, CLIP = 1e-3, 5e-4, 0.5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel worker
    processes, and torch's OpenMP threads, each spinning at its barriers,
    slow every worker many times over once they outnumber the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _kw(name):
    kw = dict(model_name=name, num_classes=13)
    if name == "MobileViT":
        kw.update(MOBILEVIT_CONFIGS["xxs"], attention_backend="packed")
    return kw


def _pair(name):
    return (jax_model(JaxConfig(**_kw(name))),
            initialize_model(Config(**_kw(name))))


@pytest.mark.parametrize("name,patterns", [
    ("MobileNetLarge3D", ["block1"]),
    ("MobileNetLarge3D", ["block2.0", "fc2.w"]),
    ("MobileNetLarge3D", ["*batchnorm*", "block1.bn.scale"]),
    ("MobileNetLarge3D", ["block[34].*", "*squeeze_excite.w?"]),
    ("MobileViT", ["stem"]),
    ("MobileViT", ["trunk.2", "head.w"]),
    ("MobileViT", ["*attns*", "conv1"]),
    ("MobileViT", ["trunk.*.transformer.ffs.?.fc1.*"])])
def test_frozen_set_matches_jax(name, patterns):
    jm, port = _pair(name)
    params = jm.init(0)["params"]
    want = {_torch_key(path, False, name)
            for path, f in flatten_dict(jax_freeze.freeze_mask(
                params, patterns)).items() if f}
    mask = freeze(port, name, patterns)
    got = {n for n, f in mask.items() if f}
    assert got == want and 0 < len(got) < len(mask)
    assert {n for n, p in port.named_parameters()
            if not p.requires_grad} == got


@pytest.mark.parametrize("name", ["MobileNetLarge3D", "MobileNetSmall3D",
                                  "MobileViT", "MoViNetA2",
                                  "MobileNetLarge2D", "MobileNetSmall2D",
                                  "MobileViTV2"])
def test_jax_param_paths_are_the_jax_package_paths(name):
    jm, port = _pair(name)
    paths = [jax_param_path(port, n, name) for n, _ in
             port.named_parameters()]
    assert sorted(paths) == sorted(flatten_dict(jm.init(0)["params"]))


@pytest.mark.parametrize("patterns,match", [
    (["block9"], "match no parameter"), (["block1", "fc3"], "fc3"),
    (["*"], "froze every parameter"), (["block*", "fc*"],
                                       "froze every parameter")])
def test_typos_and_freeze_all_are_refused_as_in_jax(patterns, match):
    jm, port = _pair("MobileNetLarge3D")
    with pytest.raises(ValueError, match=match):
        jax_freeze.freeze_mask(jm.init(0)["params"], patterns)
    with pytest.raises(ValueError, match=match):
        freeze_mask(port, "MobileNetLarge3D", patterns)


@pytest.fixture(scope="module")
def frozen_step():
    """One f32 step (A = 2 microbatches of (2, 8, 64, 64, 3), clip 0.5)
    with ``block1`` and ``block2.1`` frozen, in both packages."""
    name, patterns = "MobileNetLarge3D", ["block1", "block2.1"]
    rng = np.random.RandomState(5)
    jm, port = _pair(name)
    opt = jax_optim.AdamW(weight_decay=WD)
    state = create_train_state(jm, opt, 0)
    v = _perturb_batchnorm({"params": state.params,
                            "state": state.model_state}, rng)
    state = state._replace(model_state=v["state"])
    port.load_state_dict(state_dict_from_jax(
        flatten_dict(v["params"]), flatten_dict(v["state"]), name))
    _no_dropout(jm, port)
    start = {k: t.clone() for k, t in port.state_dict().items()}
    feats = rng.randint(0, 256, (2, 2, 8, 64, 64, 3)).astype(np.uint8)
    labels = rng.randint(0, 13, (2, 2)).astype(np.int32)

    mask = jax_freeze.freeze_mask(state.params, patterns)
    step = jax_make_train_step(jm, opt, "CE", lambda e: jnp.float32(LR),
                               policy=DtypePolicy.f32(), donate=False,
                               max_grad_norm=CLIP, frozen_mask=mask)
    new, metrics = step(state, feats, labels, jax.random.key(0))
    want = {"params": state_dict_from_jax(flatten_dict(new.params), {},
                                          name),
            "state": state_dict_from_jax({}, flatten_dict(new.model_state),
                                         name),
            "grad_norm": float(metrics["grad_norm"]),
            "loss": np.asarray(metrics["loss"]),
            "opt_count": int(new.opt_state["step"])}

    frozen = freeze(port, name, patterns)
    adamw = AdamW(port.parameters(), weight_decay=WD)
    got = make_train_step(port, adamw, "CE", lambda e: LR,
                          TorchPolicy.f32(), max_grad_norm=CLIP,
                          device="cpu")(0, feats, labels)
    return want, port, got, frozen, start, adamw


def test_frozen_step_matches_jax(frozen_step):
    want, port, got, frozen, start, adamw = frozen_step
    np.testing.assert_allclose(got["loss"].numpy(), want["loss"],
                               rtol=2e-4, atol=2e-4)
    assert float(got["grad_norm"]) == pytest.approx(want["grad_norm"],
                                                    rel=1e-3)
    params = dict(port.named_parameters())
    n_frozen = 0
    for key, p in want["params"].items():
        if frozen[key]:
            # no gradient, no update, no weight decay, in both packages
            assert params[key].grad is None
            assert torch.equal(params[key].detach(), start[key]), key
            np.testing.assert_array_equal(p.numpy(), start[key].numpy())
            n_frozen += 1
        else:
            np.testing.assert_allclose(params[key].detach().numpy(),
                                       p.numpy(), rtol=0, atol=2 * LR,
                                       err_msg=key)
    assert n_frozen == 4 + 5
    # frozen BatchNorms' running statistics still advance
    buffers = dict(port.named_buffers())
    for key, s in want["state"].items():
        if key.endswith("num_batches_tracked"):
            assert int(buffers[key]) == 2
            continue
        np.testing.assert_allclose(buffers[key].numpy(), s.numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=key)
    assert not torch.equal(buffers["block1.1.running_mean"],
                           start["block1.1.running_mean"])
    # the optimizer holds the trainable tensors only, and counts steps
    # (and so corrects its bias) as the JAX one does
    assert len(adamw.params) == len(frozen) - n_frozen
    assert adamw.steps == want["opt_count"] == 1
