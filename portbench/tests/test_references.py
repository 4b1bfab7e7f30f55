"""The three contracts of a configuration's reference
(``harness/manifest.py``): pinned, for the two configurations the
benchmark has, to the rules they replaced, and each new rule on a small
module of its own."""

import contextlib
import math
import sys
import types

import pytest
import torch
from torch import nn

from portbench.harness import manifest, references, work
from portbench.harness import weights as W
from portbench.reference import models as R
from portbench.reference import steps
from portbench.reference.steps import follow_training

BENCH = manifest.load_manifest()
CONFIGS = ("mobilenet_large3d", "mobilevit_s")
SEEDS = (7, 2 ** 31 + 4242)


def config(name):
    return manifest.load_config(BENCH, name)


# ------------------------------------------- the rules that were replaced

def seeded_state_by_key(template: dict, seed: int, device, init="he"):
    """The weights' rule before it read the owning module: a literal copy,
    the oracle of the existing configurations' weights."""
    floats = [(k, t) for k, t in template.items() if t.is_floating_point()]
    total = sum(t.numel() for _, t in floats)
    flat = torch.randn(total, generator=W._stream(seed, 1, device),
                       device=device)
    bn = {k.rsplit(".", 1)[0] for k in template
          if k.endswith(".running_mean")}
    out, at = {}, 0
    for k, t in floats:
        n = flat[at:at + t.numel()].view(t.shape)
        owner, leaf = k.rsplit(".", 1)
        if t.dim() >= 2:
            fan_in = math.prod(t.shape[1:])
            if init == "he":
                v = n * math.sqrt(2.0 / fan_in)
            elif init == "normal_0.02":
                v = n * 0.02
            elif init == "torch_default":
                v = torch.erf(n / math.sqrt(2.0)) / math.sqrt(fan_in)
            else:
                raise ValueError(f"init {init!r}")
        elif owner in bn and leaf == "weight":
            v = 1.0 + 0.1 * n
        elif leaf == "running_var":
            v = torch.exp(0.2 * n)
        else:
            v = 0.1 * n
        at += t.numel()
        out[k] = v.to(t.dtype)
    for k, t in template.items():
        if k not in out:
            out[k] = torch.zeros(t.shape, dtype=t.dtype, device=device)
    return out


def geometry_by_class(model, clip_shape, batch):
    """Kernel calls found by the reference's classes: a literal copy of
    the rule ``kernel_call`` replaced, the oracle of ``work.geometry``."""
    model = model.to("meta").eval()
    calls = {"fused_bottleneck": [], "attention": [], "folded_conv": []}

    def on_bottleneck(m, args, out):
        b, c, t, h, w = args[0].shape
        calls["fused_bottleneck"].append(
            ((b, t, h, w, c), m.kernel_size, m.stride,
             m.pointwise_conv1.out_channels,
             m.pointwise_conv2.out_channels, m.use_se))

    def on_attention(m, args, out):
        x = args[0]
        calls["attention"].append((math.prod(x.shape[:-2]), m.heads,
                                   x.shape[-2],
                                   m.to_qkv.out_features // 3 // m.heads))

    def on_conv(m, args, out):
        b, c, t, h, w = args[0].shape
        calls["folded_conv"].append(((b, t, h, w, c), m.out_channels,
                                     tuple(m.kernel_size)))

    hooks = []
    for m in model.modules():
        if isinstance(m, R.Bottleneck3D):
            hooks.append(m.register_forward_hook(on_bottleneck))
        elif isinstance(m, R.Attention):
            hooks.append(m.register_forward_hook(on_attention))
        elif isinstance(m, R.Conv3d) and R.takes_folded_conv(m):
            hooks.append(m.register_forward_hook(on_conv))
    try:
        with torch.no_grad():
            model(torch.empty((batch, 3) + tuple(clip_shape),
                              device="meta"))
    finally:
        for h in hooks:
            h.remove()
    return calls


# --------------------------------------- pins of the two configurations

@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", CONFIGS)
def test_seeded_state_bit_equal_to_the_rule_by_key(name, seed):
    cfg = config(name)
    got = W.seeded_state(references.reference_model(cfg), seed, "cpu",
                         cfg["init"])
    want = seeded_state_by_key(references.reference_model(cfg).state_dict(),
                               seed, "cpu", cfg["init"])
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k],
                                                             want[k]), k


@pytest.mark.parametrize("batch", ["cell", 8])
@pytest.mark.parametrize("name", CONFIGS)
def test_geometry_equal_to_the_calls_found_by_class(name, batch):
    cfg = config(name)
    b = cfg["batch_size"] if batch == "cell" else batch
    got = work.geometry(references.reference_model(cfg), cfg["clip"], b)
    want = geometry_by_class(references.reference_model(cfg), cfg["clip"],
                             b)
    for family, calls in want.items():
        assert got[family] == calls, family
    assert {f for f, c in got.items() if c} == {f for f, c in want.items()
                                               if c}


# FLOPs a clip of the reference at the cells' shapes (32x224x224), the
# train step's at its microbatch and a bs-8 forward's, as counted before
# the references were found by file
FLOPS = {("mobilenet_large3d", True): 20309109312.0,
         ("mobilenet_large3d", False): 6943111360.0,
         ("mobilevit_s", True): 118796526336.0,
         ("mobilevit_s", False): 39772250368.0}


@pytest.mark.parametrize("name,train", sorted(FLOPS))
def test_flops_per_clip_unchanged(name, train):
    cfg = config(name)
    b = cfg["batch_size"] if train else 8
    assert work.flops_per_clip(references.reference_model(cfg), cfg["clip"],
                               b, train=train) == FLOPS[(name, train)]


# ---------------------------------------------------------- the new rules

class MarkedRMSNorm(nn.Module):
    """An RMSNorm as a reference file would write it, marked as a
    normalization."""
    is_normalization = True

    def __init__(self, d):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))

    def forward(self, x):
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-6) \
            * self.weight


class Norms(nn.Module):
    def __init__(self, d=512):
        super().__init__()
        self.proj = nn.Linear(64, d)
        self.ln = nn.LayerNorm(d)
        self.gn = nn.GroupNorm(8, d)
        self.rms = MarkedRMSNorm(d)
        self.bn = nn.BatchNorm1d(d)
        self.gate = nn.Parameter(torch.zeros(d))


def test_norm_weights_are_drawn_around_one():
    with torch.device("meta"):
        model = Norms()
    state = W.seeded_state(model, 11, "cpu", "normal_0.02")
    for norm in ("ln", "gn", "rms", "bn"):
        w = state[f"{norm}.weight"]
        assert abs(w.mean().item() - 1.0) < 0.02, norm
        assert 0.08 < w.std().item() < 0.12, norm
    for bias in ("ln.bias", "gn.bias", "bn.bias", "bn.running_mean",
                 "proj.bias", "gate"):
        v = state[bias]
        assert abs(v.mean().item()) < 0.02 and 0.08 < v.std().item() < 0.12
    assert (state["bn.running_var"] > 0).all()
    assert 0.015 < state["proj.weight"].std().item() < 0.025
    assert state["bn.num_batches_tracked"].item() == 0
    # one standard-normal draw over the float leaves in key order
    floats = [k for k, t in state.items() if t.is_floating_point()]
    at = sum(state[k].numel() for k in floats[:floats.index("rms.weight")])
    flat = torch.randn(sum(state[k].numel() for k in floats),
                       generator=W._stream(11, 1, "cpu"))
    assert torch.equal(state["rms.weight"], 1.0 + 0.1 * flat[at:at + 512])


def test_torch_norms_are_norms_and_plain_modules_are_not():
    assert all(W.is_norm(m) for m in (nn.LayerNorm(4), nn.GroupNorm(2, 4),
                                      nn.BatchNorm3d(4), MarkedRMSNorm(4)))
    assert not W.is_norm(nn.Linear(4, 4)) and not W.is_norm(R.Conv3d(4, 4, 1))


class Gate(nn.Module):
    """A module that stands for a hand-written function of a family the
    benchmark has not seen."""

    def __init__(self, d):
        super().__init__()
        self.lin = nn.Linear(d, d)

    def forward(self, x):
        return self.lin(x)

    def kernel_call(self, args):
        return "gate_kernel", tuple(args[0].shape)


class WithGates(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = R.Conv3d(3, 4, 1)          # no call: one tap
        self.a, self.b = Gate(4), Gate(4)

    def forward(self, x, generator=None):
        return self.b(self.a(self.conv(x).mean(dim=(2, 3, 4))))


def test_a_new_family_shows_up_in_geometry():
    calls = work.geometry(WithGates(), (2, 4, 4), 3)
    assert dict(calls) == {"gate_kernel": [(3, 4), (3, 4)]}
    assert calls["fused_bottleneck"] == [] and calls["attention"] == []
    assert work.fused_bottleneck_least_ms(types.SimpleNamespace(
        calls=calls, forwards=2)) == 0


class Tiny(nn.Module):
    def __init__(self, classes=3):
        super().__init__()
        self.conv = R.Conv3d(3, classes, 1)

    def forward(self, x, generator=None):
        return self.conv(x).mean(dim=(2, 3, 4))


def test_loss_terms_join_the_reference_steps(monkeypatch):
    """A reference file's ``loss_terms`` joins each microbatch's loss
    before the backward; the recorded loss stays the cross entropy."""
    mod = types.ModuleType("portbench.reference.tiny_with_terms")
    mod.build = lambda cfg: Tiny(cfg["num_classes"])
    mod.loss_terms = lambda model: 0.5 * model.conv.weight.pow(2).sum()
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    plain = {"learning_rate": 3e-4, "max_iters": 100, "weight_decay": 5e-4,
             "num_classes": 3}
    with_terms = dict(plain, reference="tiny_with_terms")
    a = 2
    ups = [(W.seeded_clips(5, 1, (a, 2, 2, 4, 4, 3), "cpu"),
            W.seeded_ints(5, 2, 3, (a, 2)))]
    model = references.reference_model(with_terms, "cpu")
    assert isinstance(model, Tiny)
    state = W.seeded_state(model, 5, "cpu", "he")
    out = {}
    for name, cfg in (("plain", plain), ("terms", with_terms)):
        model.load_state_dict(state)
        out[name] = follow_training(model, cfg, ups, seed=3)
    assert out["terms"]["losses"] == out["plain"]["losses"]
    added = (out["terms"]["first_grads"]["conv.weight"]
             - out["plain"]["first_grads"]["conv.weight"])
    torch.testing.assert_close(added, a * state["conv.weight"])
    assert torch.equal(out["terms"]["first_grads"]["conv.bias"],
                       out["plain"]["first_grads"]["conv.bias"])


def test_a_reference_name_is_an_identifier():
    with pytest.raises(ValueError):
        references.reference_model({"reference": "../models"})


@pytest.mark.parametrize("name", CONFIGS)
def test_recomputed_blocks_give_the_same_steps(name, monkeypatch):
    """The reference's steps recompute its blocks in the backward (the
    timed microbatch fits on the card in float32): losses, the first
    gradient, the weights and the buffers after two steps equal those of
    the steps that keep every activation, dropout masks included."""
    cfg = dict(config(name), clip=[8, 32, 32])
    state = W.seeded_state(references.reference_model(cfg), 5, "cpu",
                           cfg["init"])
    feats = W.seeded_clips(5, 1, (2, 2, 3, 8, 32, 32, 3), "cpu")
    labels = W.seeded_ints(5, 2, cfg["num_classes"], (2, 2, 3))
    ups = [(feats[k], labels[k]) for k in range(2)]
    assert len(steps.recomputed_modules(
        references.reference_model(cfg))) >= 15
    out = {}
    for mode in ("recomputed", "kept"):
        if mode == "kept":
            monkeypatch.setattr(steps, "recomputed",
                                lambda model: contextlib.nullcontext())
        model = references.reference_model(cfg, "cpu")
        model.load_state_dict(state)
        out[mode] = (follow_training(model, cfg, ups, seed=77),
                     model.state_dict())
    (a, sa), (b, sb) = out["recomputed"], out["kept"]
    assert a["losses"] == b["losses"]
    for k in b["first_grads"]:
        assert torch.equal(a["first_grads"][k], b["first_grads"][k]), k
    for k in sb:
        assert torch.equal(sa[k], sb[k]), k
    assert not any("forward" in vars(m) for m in model.modules())
