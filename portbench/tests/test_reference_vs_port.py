"""The plain reference against the port, on the CPU at small clips, with
one seeded state dict loaded into both: eval logits, the loss, every
gradient, and the 8-bit AdamW update. This file is the one place that
imports both the reference and the program."""

import numpy as np
import pytest
import torch

from picklebot_tpu_torch.core.policy import DtypePolicy
from picklebot_tpu_torch.models.mobilevit import MOBILEVIT_CONFIGS
from picklebot_tpu_torch.models.registry import initialize_model
from picklebot_tpu_torch.train import optim as port_optim
from picklebot_tpu_torch.train.losses import cross_entropy
from picklebot_tpu_torch.train.step import (make_predict_fn,
                                            make_train_step, preprocess)
from picklebot_tpu_torch.utils.config import Config
from portbench.generators import train_accum
from portbench.harness import checks
from portbench.harness.weights import (calibrated, seeded_clips, seeded_ints,
                                       seeded_state)
from portbench.reference import models as R
from portbench.reference import optim as ref_optim
from portbench.reference.steps import follow_training, predict

MODELS = {"MobileNetLarge3D": {}, "MobileViT": MOBILEVIT_CONFIGS["s"]}
PARAMS = {"MobileNetLarge3D": 4_205_675, "MobileViT": 8_453_136}
CLIP = (8, 48, 48)


def pair(name, seed):
    kw = MODELS[name]
    port = initialize_model(Config(model_name=name, num_classes=13,
                                   **kw).validate())
    ref = R.build(name, 13, kw.get("dims"), kw.get("channels"))
    state = seeded_state(ref, seed, "cpu")
    port.load_state_dict(state)
    ref.load_state_dict(state)
    return port, ref, state


@pytest.mark.parametrize("name", sorted(MODELS))
def test_keys_shapes_and_count(name):
    port, ref, _ = pair(name, 1)
    ps, rs = port.state_dict(), ref.state_dict()
    assert sorted(ps) == sorted(rs)
    assert all(ps[k].shape == rs[k].shape for k in ps)
    assert sum(p.numel() for p in ref.parameters()) == PARAMS[name]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_eval_logits(name):
    port, ref, state = pair(name, 2)
    clips = seeded_clips(2, 1, (3, *CLIP, 3), "cpu")
    state = calibrated(state, R.build(name, 13, MODELS[name].get("dims"),
                                      MODELS[name].get("channels")),
                       clips[:2])
    port.load_state_dict(state)
    ref.load_state_dict(state)
    got = make_predict_fn(port, DtypePolicy.f32(), device="cpu")(clips)
    want = predict(ref, clips).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_loss_and_every_gradient(name):
    port, ref, _ = pair(name, 3)
    clips = torch.as_tensor(seeded_clips(3, 1, (2, *CLIP, 3), "cpu"))
    labels = torch.as_tensor(seeded_ints(3, 2, 13, (2,)))
    port.train()
    ref.train()
    from picklebot_tpu_torch.ops.linear import dropout_rng
    with dropout_rng(torch.Generator().manual_seed(5)):
        lp = cross_entropy(port(preprocess(clips, torch.float32)), labels)
    lp.backward()
    from portbench.reference.steps import preprocess as ref_pre
    lr = torch.nn.functional.cross_entropy(
        ref(ref_pre(clips), torch.Generator().manual_seed(5)), labels)
    lr.backward()
    assert abs(lp.item() - lr.item()) <= 1e-5 * abs(lr.item())
    # float32 sums in another order, amplified through the train-mode
    # BatchNorms on the way to the stem: up to 5e-3 of a stem leaf's
    # largest gradient, under 2e-4 at the median leaf
    grads = dict(ref.named_parameters())
    floor = 1e-3 * float(np.median([g.grad.abs().max().item()
                                    for g in grads.values()]))
    errs = []
    for n, p in port.named_parameters():
        want = grads[n].grad
        scale = max(want.abs().max().item(), floor)
        errs.append((p.grad - want).abs().max().item() / scale)
        assert errs[-1] <= 2e-2, n
    assert float(np.median(errs)) <= 1e-3


def test_codebooks_match_the_port():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4096 + 77, generator=g) * torch.rand(4096 + 77,
                                                         generator=g) ** 4
    signed = port_optim.dequantize_signed(*port_optim.quantize_signed(x),
                                          x.shape)
    unsigned = port_optim.dequantize_unsigned(
        *port_optim.quantize_unsigned(x.abs()), x.shape)
    assert torch.equal(ref_optim.roundtrip(x, True), signed)
    assert torch.equal(ref_optim.roundtrip(x.abs(), False), unsigned)
    assert len(ref_optim.codebook(True)) == 243
    assert len(ref_optim.codebook(False)) == 250


def test_adamw8bit_steps_match_the_port():
    g = torch.Generator().manual_seed(1)
    shapes = [(64, 80), (300,), (5000,)]
    ps = [torch.randn(s, generator=g) for s in shapes]
    qs = [p.clone() for p in ps]
    port = port_optim.AdamW8bit([torch.nn.Parameter(p) for p in ps],
                                weight_decay=5e-4)
    ref = ref_optim.AdamW8bit(qs, lambda t: 3e-4, weight_decay=5e-4)
    for _ in range(3):
        grads = [torch.randn(s, generator=g) for s in shapes]
        for p, gr in zip(port.params, grads):
            p.grad = gr.clone()
        port.step(3e-4)
        ref.step(grads)
    for p, q in zip(port.params, qs):
        assert (p.detach() - q).abs().max().item() <= 1e-9 + 1e-6 * 3e-4


def test_cosine_rate_matches_the_port():
    sched = port_optim.cosine_annealing_lr(3e-4, 100, warmup=3)
    for e in (0, 2, 3, 50, 99):
        assert ref_optim.cosine_lr(3e-4, 100, e, 3) == sched(e)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_three_train_steps(name):
    """The port's step in float32 against the reference's, three updates
    of two microbatches: the numbers ``correct`` compares, tight."""
    port, ref, _ = pair(name, 4)
    start = checks.as_cpu_state(port)
    opt = port_optim.AdamW8bit(port.parameters(), weight_decay=5e-4)
    step = make_train_step(port, opt, "CE",
                           port_optim.cosine_annealing_lr(3e-4, 100),
                           DtypePolicy.f32(), seed=99, device="cpu")
    ups = [(seeded_clips(4, 10 + i, (2, 2, *CLIP, 3), "cpu"),
            seeded_ints(4, 20 + i, 13, (2, 2))) for i in range(3)]
    prog = {"losses": []}
    for i, (f, lab) in enumerate(ups):
        prog["losses"].append(step(0, f, lab, position=2 * i)["loss"].tolist())
        if i == 0:
            prog["first_grads"] = {n: p.grad.clone()
                                   for n, p in port.named_parameters()}
    prog["params"] = checks.as_cpu_state(port)
    want = follow_training(ref, {"learning_rate": 3e-4, "max_iters": 100,
                                 "weight_decay": 5e-4}, ups, seed=99)
    numbers, _ = checks.train_numbers(prog, want, start)
    assert numbers["loss_gap_first"] <= 1e-5
    assert numbers["grad_norm_gap_median"] <= 1e-4
    assert numbers["update_norm_gap"] <= 2e-2

    # a fourth update, which the reference follows from the port's
    # weights and 8-bit moments, as it follows the update after a window
    pre = checks.as_cpu_state(port)
    moments = train_accum.moments(opt.state_dict(), pre)
    late = {"losses": step(0, *ups[0], position=6)["loss"].tolist()}
    late["params"] = checks.as_cpu_state(port)
    ref.load_state_dict({**ref.state_dict(), **pre})
    want = follow_training(ref, {"learning_rate": 3e-4, "max_iters": 100,
                                 "weight_decay": 5e-4}, [ups[0]], seed=99,
                           position0=6, opt_state=moments)
    numbers, _ = checks.late_numbers(late, {
        "losses": want["losses"][0], "grads": want["first_grads"],
        "params": want["params"]}, pre)
    assert numbers["late_loss_gap"] <= 1e-5
    assert numbers["late_update_gap"] <= 2e-2
