"""The plain reference of the two paths the benchmark times: batched
prediction, and training steps with gradient accumulation.

Clips arrive as uint8 (B, T, H, W, 3); the model sees (B, 3, T, H, W) in
float32 scaled to [0, 1], then, where the configuration applies them, the
per-channel mean and std. The loss is cross entropy, the mean over the
microbatch. A training step sums the microbatches' gradients unscaled,
optionally clips their global norm, and makes one 8-bit AdamW update at
the epoch's cosine rate. Each microbatch's dropout masks come from a
generator on the device seeded with (seed * 1_000_003 + position) mod
2**63, position being the microbatch's index in the run.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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
    gen = torch.Generator(device=device)
    model.train()
    losses, first = [], None
    position = position0
    with f32_exact():
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
                loss.backward()
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
