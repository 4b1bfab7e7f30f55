"""Train, eval and inference steps: uint8 clips or images -> loss,
metrics, logits.

Counterpart of ``preprocess``, ``make_train_step`` (single device),
``make_eval_step`` and ``make_predict_fn`` in
``picklebot_tpu/train/step.py``. A train step takes a whole effective
batch (A microbatches): per microbatch, preprocess -> train-mode forward
(BatchNorm running statistics advance) -> loss -> backward, the gradients
summed unscaled into the f32 ``.grad`` of the f32 parameters; then the
optional global-norm clip and one optimizer update at the epoch's learning
rate. Compute runs in the policy's dtype (bf16 for ``use_autocast``) with
no GradScaler. Dropout masks come from one ``torch.Generator`` on the
device, seeded per microbatch from (seed, position), as the JAX step folds
the position into its key. The steps are rank-free: a batch is whatever
the model takes, (B, T, H, W, C) clips or, for MobileViTV2, (B, H, W, C)
images.

The trainer extras of the JAX step: ``augment`` (``data/augment.py``, in
the /255 domain before mean/std, draws keyed on the microbatch
position), ``remat`` (``core/remat.py``), an EMA of the parameters after
every update, and frozen parameters (``train/freeze.py``: a parameter
that does not require grad has no gradient, no update and no part in the
clip norm).
"""

from __future__ import annotations

import numpy as np
import torch

from picklebot_tpu_torch.core.policy import DtypePolicy
from picklebot_tpu_torch.core.remat import apply_remat
from picklebot_tpu_torch.data.augment import apply_augment, draw_augment
from picklebot_tpu_torch.ops.linear import dropout_rng
from picklebot_tpu_torch.ops.resize import resize_frames
from picklebot_tpu_torch.train.losses import (LOSSES, LOSSES_PER_SAMPLE,
                                              prepare_labels, smoothed_bce,
                                              smoothed_cross_entropy)


def preprocess(features: torch.Tensor, compute_dtype, mean=None, std=None,
               input_size=None) -> torch.Tensor:
    """uint8 (..., H, W, C) clips or images -> compute dtype: /255, then
    with ``input_size`` the resize to (input_size, input_size)
    (``ops/resize.py``), then the optional per-channel mean/std."""
    x = features.to(compute_dtype) / 255.0
    if input_size:
        x = resize_frames(x, input_size)
    return standardize(x, mean, std)


def standardize(x: torch.Tensor, mean=None, std=None) -> torch.Tensor:
    """The optional per-channel (x - mean) / std in x's dtype."""
    if mean is not None and std is not None:
        mean = torch.tensor(mean, dtype=x.dtype, device=x.device)
        std = torch.tensor(std, dtype=x.dtype, device=x.device)
        x = (x - mean) / std
    return x


def make_predict_fn(model, policy: DtypePolicy = None, mean=None, std=None,
                    input_size=None, device="cuda"):
    """Batched inference: a uint8 (B, T, H, W, 3) clip or (B, H, W, 3)
    image numpy batch -> f32 numpy (B, num_classes) logits, with the model
    run on ``device`` in eval mode (the model must already live there)."""
    policy = policy or DtypePolicy.bf16()
    device = torch.device(device)
    model.eval()

    def predict(features: np.ndarray) -> np.ndarray:
        with torch.inference_mode(), policy.precision():
            x = torch.from_numpy(np.ascontiguousarray(features)).to(device)
            x = preprocess(x, policy.compute_dtype, mean, std, input_size)
            return model(x).float().cpu().numpy()

    return predict


def _micro_seed(seed: int, position: int) -> int:
    return (seed * 1_000_003 + position) % 2 ** 63


def ema_init(model) -> dict:
    """The EMA weights seeded from the model's parameters: {name: f32
    copy}."""
    return {n: p.detach().float().clone()
            for n, p in model.named_parameters()}


def make_train_step(model, optimizer, criterion: str, schedule,
                    policy: DtypePolicy = None, mean=None, std=None,
                    max_grad_norm=None, label_smoothing: float = 0.0,
                    seed: int = 0, device="cuda", remat: int = 0,
                    augment=None, ema=None, ema_decay: float = 0.0,
                    input_size=None):
    """step(epoch, features, labels, position=0) -> metrics, with features
    (A, B, T, H, W, C) uint8 clips or (A, B, H, W, C) images and labels
    (A, B) (numpy or tensors) and
    ``position`` the index of the step's first microbatch in the run (it
    keys the dropout masks and the augmentation draws). Metrics:
    per-microbatch ``loss`` and
    ``correct`` (A,) tensors, ``samples`` A*B, ``lr``, and ``grad_norm``
    when clipping (torch ``clip_grad_norm_``: one global norm, grads
    scaled by max/(norm + 1e-6) when it exceeds max). The summed
    gradients stay in ``.grad`` after the step.

    ``remat`` > 0 checkpoints that many levels of module calls
    (``core/remat.apply_remat``). ``augment`` is an ``Augment``.
    ``ema`` ({name: f32 tensor}, from ``ema_init``) is updated in place
    after every optimizer step, ema = d * ema + (1 - d) * p in f32, with
    d = ``ema_decay``. ``input_size`` resizes each microbatch's frames
    in ``preprocess``, before the augmentation."""
    policy = policy or DtypePolicy.bf16()
    device = torch.device(device)
    if remat:
        apply_remat(model, remat)
    aug = augment if augment is not None and augment.enabled() else None
    if ema_decay > 0 and ema is None:
        raise ValueError("ema_decay > 0 needs the EMA weights: pass "
                         "ema=ema_init(model)")
    d = np.float32(ema_decay)
    ema_pairs = ([(ema[n], p) for n, p in model.named_parameters()]
                 if ema_decay > 0 else [])
    loss_fn, acc_fn = LOSSES[criterion]
    if label_smoothing > 0.0:
        loss_fn = (smoothed_cross_entropy(label_smoothing) if criterion == "CE"
                   else smoothed_bce(label_smoothing))
    params = [p for p in model.parameters() if p.requires_grad]
    generator = torch.Generator(device=device)

    def step(epoch, features, labels, position: int = 0):
        lr = schedule(epoch)
        feats, lbls = torch.as_tensor(features), torch.as_tensor(labels)
        model.train()
        for p in params:
            p.grad = None
        losses, corrects = [], []
        with policy.precision():
            for i in range(feats.shape[0]):
                if aug is None:
                    x = preprocess(feats[i].to(device), policy.compute_dtype,
                                   mean, std, input_size)
                else:
                    x = preprocess(feats[i].to(device), policy.compute_dtype,
                                   input_size=input_size)
                    x = apply_augment(x, draw_augment(
                        aug, x.shape[0], seed, position + i), aug.crop)
                    x = standardize(x, mean, std)
                lbl = prepare_labels(criterion, lbls[i].to(device))
                generator.manual_seed(_micro_seed(seed, position + i))
                with dropout_rng(generator):
                    logits = model(x)
                loss = loss_fn(logits, lbl)
                loss.backward()
                losses.append(loss.detach())
                corrects.append(acc_fn(logits.detach(), lbl))
            metrics = {"loss": torch.stack(losses),
                       "correct": torch.stack(corrects),
                       "samples": float(feats.shape[0] * feats.shape[1]),
                       "lr": lr}
            if max_grad_norm is not None:
                norm = torch.sqrt(sum(p.grad.float().pow(2).sum()
                                      for p in params if p.grad is not None))
                scale = torch.clamp(max_grad_norm / (norm + 1e-6), max=1.0)
                for p in params:
                    if p.grad is not None:
                        p.grad.mul_(scale)
                metrics["grad_norm"] = norm
            optimizer.step(lr)
            with torch.no_grad():
                for e, p in ema_pairs:
                    e.mul_(float(d)).add_(p.float() * float(1 - d))
        return metrics

    return step


def make_eval_step(model, criterion: str, policy: DtypePolicy = None,
                   mean=None, std=None, device="cuda", input_size=None):
    """eval_step(features, labels, mask) -> {'loss' (masked mean),
    'loss_sum', 'correct', 'samples', 'confusion'}: eval mode (BatchNorm
    running statistics), ``mask`` (B,) 1.0 for real samples and 0.0 for
    the padded tail. The confusion matrix has rows = true class, columns =
    predicted (2 x 2 for BCE)."""
    policy = policy or DtypePolicy.bf16()
    device = torch.device(device)
    loss_fn, correct_fn = LOSSES_PER_SAMPLE[criterion]

    def eval_step(features, labels, mask):
        model.eval()
        with torch.inference_mode(), policy.precision():
            x = preprocess(torch.as_tensor(features).to(device),
                           policy.compute_dtype, mean, std, input_size)
            logits = model(x)
            lbl = prepare_labels(criterion, torch.as_tensor(labels).to(device))
            m = torch.as_tensor(mask, dtype=torch.float32).to(device)
            loss_sum = (loss_fn(logits, lbl) * m).sum()
            correct = (correct_fn(logits, lbl) * m).sum()
            n = m.sum()
            if criterion == "BCE":
                pred = (logits.reshape(-1) > 0).long()
                true, ncls = lbl.reshape(-1).long(), 2
            else:
                pred, true, ncls = logits.argmax(-1), lbl, logits.shape[-1]
            confusion = torch.zeros((ncls, ncls), device=device).index_put_(
                (true, pred), m, accumulate=True)
            return {"loss": (loss_sum / n.clamp(min=1.0)).item(),
                    "loss_sum": loss_sum.item(), "correct": correct.item(),
                    "samples": n.item(), "confusion": confusion.cpu().numpy()}

    return eval_step
