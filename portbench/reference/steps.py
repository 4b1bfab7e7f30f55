"""The plain reference of the two paths the benchmark times: batched
prediction, and training steps with gradient accumulation.

Clips arrive as uint8 (B, T, H, W, 3); the model sees (B, 3, T, H, W) in
float32 scaled to [0, 1], then, where the configuration applies them, the
per-channel mean and std. The loss is cross entropy, the mean over the
microbatch; where the configuration's reference file defines
``loss_terms(model)``, its value joins each microbatch's loss before the
backward, and the recorded loss stays the cross entropy, as the program
logs it. A training step sums the microbatches' gradients unscaled,
optionally clips their global norm, and makes one 8-bit AdamW update at
the epoch's cosine rate. Each microbatch's dropout masks come from a
generator on the device seeded with (seed * 1_000_003 + position) mod
2**63, position being the microbatch's index in the run.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.harness.references import loss_terms
from portbench.reference.models import f32_exact
from portbench.reference.optim import AdamW8bit, cosine_lr


def preprocess(clips_u8, mean=None, std=None):
    x = clips_u8.float() / 255.0
    if mean is not None and std is not None:
        x = (x - torch.tensor(mean, device=x.device)) / torch.tensor(
            std, device=x.device)
    return x.permute(0, 4, 1, 2, 3)


def mean_std(cfg: dict):
    """The configuration's per-channel mean and std, where it applies
    them (``apply_mean_std``), else (None, None)."""
    if cfg.get("apply_mean_std"):
        return cfg.get("mean"), cfg.get("std")
    return None, None


def micro_seed(seed: int, position: int) -> int:
    return (seed * 1_000_003 + position) % 2 ** 63


def serving_frames(clips_u8, t_bucket, max_frames):
    """Serving's T rule: zero frames appended up to the next multiple of
    ``t_bucket``, at most ``max_frames`` frames (a longer clip keeps its
    head)."""
    t = clips_u8.shape[1]
    t_out = min(-(-t // t_bucket) * t_bucket, max_frames)
    if t_out <= t:
        return clips_u8[:, :t_out]
    pad = torch.zeros((clips_u8.shape[0], t_out - t) + clips_u8.shape[2:],
                      dtype=clips_u8.dtype, device=clips_u8.device)
    return torch.cat([clips_u8, pad], dim=1)


def serving_config(cfg: dict) -> dict:
    """``predict``'s keywords for a configuration's serving path."""
    mean, std = mean_std(cfg)
    return {"mean": mean, "std": std, "t_bucket": cfg.get("t_bucket", 8),
            "max_frames": cfg.get("max_frames", 256)}


@torch.no_grad()
def predict(model, clips_u8, mean=None, std=None, block=8, t_bucket=1,
            max_frames=None):
    """float32 logits (N, classes) of uint8 clips on the model's device,
    ``block`` clips at a time, in eval mode, the clips first padded by
    serving's T rule (``serving_frames``)."""
    model.eval()
    device = next(model.parameters()).device
    out = []
    with f32_exact():
        for i in range(0, len(clips_u8), block):
            x = torch.as_tensor(clips_u8[i:i + block]).to(device)
            x = serving_frames(x, t_bucket, max_frames or x.shape[1])
            out.append(model(preprocess(x, mean, std)).float())
    return torch.cat(out)


def recomputed_modules(model):
    """The outermost modules of ``model`` that stand for one of the
    program's hand-written functions (they define ``kernel_call``): the
    model's blocks, which hold most of a microbatch's activations."""
    out, inside = [], set()
    for name, m in model.named_modules():
        if any(name.startswith(p + ".") for p in inside):
            continue
        if hasattr(m, "kernel_call"):
            out.append(m)
            inside.add(name)
    return out


@contextlib.contextmanager
def recomputed(model):
    """Each of ``recomputed_modules(model)`` keeps only its inputs for the
    backward and runs its forward again there, so that a microbatch of
    the timed size fits on the card in float32. The arithmetic is the
    same: a generator among the inputs is set back to the state the first
    pass saw (the dropout masks repeat) and left where it was, and
    ``backward`` puts back the buffers (BatchNorm running statistics) that
    the second pass moved."""
    wrapped = []
    for m in recomputed_modules(model):
        forward = m.forward

        def again(*args, _forward=forward):
            gens = [a for a in args if isinstance(a, torch.Generator)]
            first = [g.get_state() for g in gens]
            calls = [0]

            def run(*a):
                calls[0] += 1
                if calls[0] == 1:
                    return _forward(*a)
                now = [g.get_state() for g in gens]
                for g, s in zip(gens, first):
                    g.set_state(s)
                try:
                    return _forward(*a)
                finally:
                    for g, s in zip(gens, now):
                        g.set_state(s)
            return checkpoint(run, *args, use_reentrant=False,
                              preserve_rng_state=False)
        m.forward = again
        wrapped.append(m)
    try:
        yield
    finally:
        for m in wrapped:
            del m.forward


def backward(model, loss):
    """``loss.backward()`` with the model's buffers as the forward left
    them."""
    kept = [(b, b.clone()) for b in model.buffers()]
    loss.backward()
    with torch.no_grad():
        for b, k in kept:
            b.copy_(k)


def follow_training(model, cfg, updates, seed, position0=0, epoch=0,
                    opt_state=None):
    """Run ``len(updates)`` training steps of the reference from its
    current weights. ``updates``: [(features (A, B, T, H, W, 3) uint8,
    labels (A, B))]; ``position0``: the first microbatch's index in the
    run; ``opt_state``: (steps, m, v) to continue from, else a fresh
    optimizer. Returns {'losses': [[per-microbatch loss]],
    'first_grads': {name: summed gradient of step 1},
    'params': {name: value after the last step},
    'opt_state': (steps, m, v) after it}."""
    device = next(model.parameters()).device
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    lr = cosine_lr(cfg["learning_rate"], cfg["max_iters"], epoch,
                   cfg.get("warmup_epochs", 0))
    opt = AdamW8bit(params, lambda t: lr,
                    weight_decay=cfg["weight_decay"])
    if opt_state is not None:
        opt.load(*opt_state)
    mean, std = mean_std(cfg)
    extra = loss_terms(cfg)
    gen = torch.Generator(device=device)
    model.train()
    losses, first = [], None
    position = position0
    with f32_exact(), recomputed(model):
        for feats, labels in updates:
            for p in params:
                p.grad = None
            step_losses = []
            for i in range(feats.shape[0]):
                x = preprocess(torch.as_tensor(feats[i]).to(device), mean,
                               std)
                y = torch.as_tensor(labels[i]).to(device).long()
                gen.manual_seed(micro_seed(seed, position + i))
                loss = F.cross_entropy(model(x, gen).float(), y)
                backward(model, loss if extra is None
                         else loss + extra(model))
                step_losses.append(float(loss.detach()))
            position += feats.shape[0]
            grads = [p.grad for p in params]
            clip = cfg.get("max_grad_norm")
            if clip is not None:
                norm = torch.sqrt(sum(g.float().pow(2).sum() for g in grads
                                      if g is not None))
                s = torch.clamp(clip / (norm + 1e-6), max=1.0)
                grads = [None if g is None else g * s for g in grads]
            if first is None:
                first = {n: (torch.zeros_like(p) if g is None
                             else g.detach().clone())
                         for n, p, g in zip(names, params, grads)}
            opt.step(grads)
            losses.append(step_losses)
    return {"losses": losses, "first_grads": first,
            "params": {n: p.detach().clone() for n, p in zip(names,
                                                           params)},
            "opt_state": (opt.t, list(opt.m), list(opt.v))}
