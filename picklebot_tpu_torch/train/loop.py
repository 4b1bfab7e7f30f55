"""The trainer: ``train(config, max_steps=None, device="cuda")``.

The single-device subset of ``picklebot_tpu/train/loop.py``: the datasets,
gradient accumulation (``effective_batch_size // batch_size`` microbatches
per optimizer step), epochs over ``max_iters`` with a per-epoch shuffle and
the cosine schedule stepped per epoch, per-microbatch TensorBoard scalars
under the JAX loop's tag names, an eval every ``eval_interval`` epochs (and
after the last) over the whole val set with the tail padded and masked,
``config.checkpoint`` as a ``.pth`` weights-only warm start, and the final
model written as a ``.pth`` with the reference keys (which the port's
``serve`` and the JAX package's ``load_pth`` both load). Ctrl-C and SIGTERM
end the run early and still write the final model.

Every config option this trainer does not port raises NotImplementedError
naming its ROADMAP.md item; none is silently ignored. Orbax snapshots,
per-epoch snapshots and the statistics/*.npy artifacts are not written.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Optional

import numpy as np
import torch

from picklebot_tpu_torch.convert import load_pth
from picklebot_tpu_torch.core.policy import DtypePolicy
from picklebot_tpu_torch.data.dataset import ClipDataset, read_annotations
from picklebot_tpu_torch.data.loader import DataLoader, accumulate_batches
from picklebot_tpu_torch.models.registry import initialize_model
from picklebot_tpu_torch.train.metrics import SummaryWriter, windowed_average
from picklebot_tpu_torch.train.optim import OPTIMIZERS, cosine_annealing_lr
from picklebot_tpu_torch.train.step import make_eval_step, make_train_step
from picklebot_tpu_torch.utils.config import Config
from picklebot_tpu_torch.utils.devices import resolve_device

_TRAINER = "queue A, item A8"
# config option -> (is it set?, ROADMAP.md item that ports it)
UNPORTED = {
    "ema_decay": (lambda c: c.ema_decay > 0, _TRAINER),
    "freeze_params": (lambda c: bool(c.freeze_params), _TRAINER),
    "augment_flip": (lambda c: c.augment_flip, _TRAINER),
    "augment_crop": (lambda c: c.augment_crop > 0, _TRAINER),
    "augment_brightness": (lambda c: c.augment_brightness > 0, _TRAINER),
    "remat": (lambda c: int(c.remat) > 0, _TRAINER),
    "checkpoint_every_steps": (lambda c: c.checkpoint_every_steps > 0,
                               _TRAINER),
    "auto_resume": (lambda c: c.auto_resume, _TRAINER),
    "early_stop_patience": (lambda c: c.early_stop_patience > 0, _TRAINER),
    "save_best": (lambda c: c.save_best, _TRAINER),
    "warm_start": (lambda c: c.warm_start, _TRAINER),
    "warm_start_partial": (lambda c: c.warm_start_partial, _TRAINER),
    "temporal_jitter": (lambda c: c.temporal_jitter, _TRAINER),
    "keep_checkpoints": (lambda c: c.keep_checkpoints > 0, _TRAINER),
    "async_checkpoint": (lambda c: c.async_checkpoint, _TRAINER),
    "input_size": (lambda c: c.input_size is not None, "queue A, item A16"),
    "autotune": (lambda c: c.autotune, "queue A, item A17"),
    "profile": (lambda c: c.profile, "queue A, item A17"),
    "data_parallel": (lambda c: (c.data_parallel or 1) > 1,
                      "queue A, item A18"),
    "dcn_data_parallel": (lambda c: c.dcn_data_parallel > 1,
                          "queue A, item A18"),
    "zero_sharding": (lambda c: bool(c.zero_sharding), "queue A, item A19"),
    "model_parallel": (lambda c: c.model_parallel > 1, "queue A, item A20"),
    "sequence_parallel": (lambda c: c.sequence_parallel > 1,
                          "queue A, item A20"),
    "pipeline_parallel": (lambda c: c.pipeline_parallel > 1,
                          "queue A, item A20"),
    "pipeline_microbatches": (lambda c: c.pipeline_microbatches is not None,
                              "queue A, item A20"),
    "expert_parallel": (lambda c: c.expert_parallel > 1,
                        "queue A, item A20"),
    "moe_experts": (lambda c: c.moe_experts > 0, "queue A, item A20"),
}


def check_ported(config: Config):
    """Raise NotImplementedError for the first option set in ``config``
    that this trainer does not port."""
    for name, (is_set, item) in UNPORTED.items():
        if is_set(config):
            raise NotImplementedError(
                f"config {name}={getattr(config, name)!r} is not ported to "
                f"the PyTorch trainer yet (ROADMAP.md, {item})")
    if config.checkpoint and not config.checkpoint.endswith(".pth"):
        raise NotImplementedError(
            f"checkpoint {config.checkpoint!r}: the PyTorch trainer warm "
            "starts from .pth files only; Orbax snapshots are not ported "
            f"(ROADMAP.md, {_TRAINER})")


def _make_datasets(config: Config):
    syn_classes = config.resolved_synthetic_classes()
    synthetic = config.data_backend.startswith("synthetic")
    if synthetic and (syn_classes > (config.num_classes
                                     if config.criterion == "CE" else 2)):
        raise ValueError(f"synthetic_classes={syn_classes} does not fit "
                         f"criterion {config.criterion} with num_classes="
                         f"{config.num_classes}")
    if config.criterion == "CE" and not synthetic:
        # a label outside [0, num_classes) makes CE silently wrong: fail
        # before training starts
        for name, path in (("train", config.train_annotations_file),
                           ("val", config.val_annotations_file)):
            labels = read_annotations(path)[1]
            if labels.size and (labels.max() >= config.num_classes
                                or labels.min() < 0):
                raise ValueError(f"{name} annotations hold labels outside "
                                 f"[0, {config.num_classes})")
    kwargs = dict(backend=config.data_backend,
                  synthetic_shape=config.synthetic_shape,
                  synthetic_len=config.synthetic_len,
                  sample_fps=config.sample_fps,
                  synthetic_classes=syn_classes,
                  skip_bad_clips=config.skip_bad_clips)
    return (ClipDataset(config.train_annotations_file, config.video_paths,
                        **kwargs),
            ClipDataset(config.val_annotations_file, config.video_paths,
                        **kwargs))


def _pad_val_batch(feats, labels, batch):
    """Pad a partial tail batch up to ``batch``; returns a 0/1 mask."""
    n = feats.shape[0]
    mask = np.ones((batch,), np.float32)
    if n < batch:
        feats = np.concatenate(
            [feats, np.zeros((batch - n,) + feats.shape[1:], feats.dtype)])
        labels = np.concatenate([labels, np.zeros((batch - n,), labels.dtype)])
        mask[n:] = 0.0
    return feats, labels, mask


def track_best(best: float, val_loss: float) -> float:
    """The best validation loss after one more eval, by the JAX loop's rule
    (``picklebot_tpu/train/loop.py``, the ``val_loss < best_val_loss``
    update after each eval): a NaN eval (an empty val set) leaves it, and
    any lower loss replaces it. A run starts from inf."""
    return val_loss if val_loss < best else best


def train(config: Config, max_steps: Optional[int] = None,
          device="cuda") -> dict:
    """Train ``config``'s model on ``device`` (``cuda`` raises without a
    card); stop after ``max_steps`` optimizer steps if given. Returns a
    summary dict (losses, accuracies, the final model's path)."""
    check_ported(config)
    device = resolve_device(device)
    policy = DtypePolicy.bf16() if config.use_autocast else DtypePolicy.f32()
    model = initialize_model(config)
    if config.checkpoint:
        print(f"Loading checkpoint {config.checkpoint}...")
        load_pth(config.checkpoint, model)
    model.to(device)
    optimizer = OPTIMIZERS[config.optimizer](
        model.parameters(), weight_decay=config.weight_decay)
    schedule = cosine_annealing_lr(config.learning_rate, config.max_iters,
                                   warmup=config.warmup_epochs)
    mean = config.mean if config.apply_mean_std else None
    std = config.std if config.apply_mean_std else None
    train_step = make_train_step(model, optimizer, config.criterion,
                                 schedule, policy, mean, std,
                                 config.max_grad_norm,
                                 config.label_smoothing, config.seed, device)
    eval_step = make_eval_step(model, config.criterion, policy, mean, std,
                               device)

    train_ds, val_ds = _make_datasets(config)
    batch, accum = config.batch_size, config.grad_accum_steps
    loader_kw = dict(num_workers=config.num_workers,
                     t_bucket=config.t_bucket, max_frames=config.max_frames)
    train_loader = DataLoader(train_ds, batch, shuffle=True,
                              seed=config.seed, drop_last=True, **loader_kw)
    # the whole val set: the tail batch is padded and masked in eval_step
    val_loader = DataLoader(val_ds, batch, shuffle=False, drop_last=False,
                            **loader_kw)
    print(f"Using {accum} gradient accumulation steps for a total effective "
          f"batch size of {config.effective_batch_size}")

    writer = SummaryWriter(os.path.join(config.log_dir, config.run_name()))
    os.makedirs(config.checkpoint_dir, exist_ok=True)
    final_path = os.path.join(config.checkpoint_dir,
                              f"{config.run_name()}_finished.pth")
    start_time = time.time()
    print(f"Training... started: {time.ctime(start_time)}")
    global_step = 0
    train_losses_hist, train_acc_hist, all_losses = [], [], []
    val_losses, val_percent = [], []
    best_val_loss = float("inf")
    summary = {}

    def run_eval():
        tot_loss, tot_correct, tot_n, tot_conf = 0.0, 0.0, 0.0, None
        print("Evaluating...")
        for feats, labels in val_loader:
            out = eval_step(*_pad_val_batch(feats, labels, batch))
            tot_loss += out["loss_sum"]
            tot_correct += out["correct"]
            tot_n += out["samples"]
            conf = out["confusion"].astype(np.float64)
            tot_conf = conf if tot_conf is None else tot_conf + conf
        if tot_n == 0:
            return float("nan"), float("nan"), 0.0, None
        return tot_loss / tot_n, tot_correct / tot_n, tot_n, tot_conf

    prev_sigterm = None
    if threading.current_thread() is threading.main_thread():
        def _on_sigterm(signum, frame):
            raise KeyboardInterrupt("SIGTERM")
        prev_sigterm = signal.signal(signal.SIGTERM, _on_sigterm)
    steps_this_run = 0
    try:
        for epoch in range(config.max_iters):
            train_loader.set_epoch(epoch)
            epoch_correct, epoch_samples = 0.0, 0.0
            batch_losses, batch_acc = [], []
            for feats, labels in accumulate_batches(iter(train_loader),
                                                    accum):
                m = train_step(epoch, feats, labels, global_step)
                losses = m["loss"].cpu().numpy()
                corrects = m["correct"].cpu().numpy()
                if "grad_norm" in m:
                    writer.add_scalar("grad norm", float(m["grad_norm"]),
                                      global_step)
                writer.add_scalar("learning rate", m["lr"], global_step)
                for j in range(len(losses)):
                    epoch_correct += float(corrects[j])
                    epoch_samples += m["samples"] / len(losses)
                    acc = epoch_correct / max(epoch_samples, 1)
                    batch_losses.append(float(losses[j]))
                    all_losses.append(float(losses[j]))
                    batch_acc.append(acc)
                    writer.add_scalar("training loss", losses[j],
                                      global_step + j)
                    writer.add_scalar("training accuracy", acc,
                                      global_step + j)
                global_step += accum
                steps_this_run += 1
                if max_steps is not None and steps_this_run >= max_steps:
                    break
            if batch_losses:
                train_losses_hist.extend(windowed_average(batch_losses))
                train_acc_hist.extend(windowed_average(batch_acc))
            if epoch % config.eval_interval == 0 or \
                    epoch == config.max_iters - 1:
                val_loss, val_acc, val_n, val_conf = run_eval()
                val_losses.append(val_loss)
                val_percent.append(val_acc)
                best_val_loss = track_best(best_val_loss, val_loss)
                summary["val_samples"] = val_n
                if val_conf is not None:
                    summary["val_confusion"] = val_conf
                tl = train_losses_hist[-1] if train_losses_hist \
                    else float("nan")
                ta = train_acc_hist[-1] if train_acc_hist else float("nan")
                print(f"Step {epoch}: Train Loss: {tl:.4f}, "
                      f"Val Loss: {val_loss:.4f}")
                print(f"Step {epoch}: Train Accuracy: {ta * 100:.2f}%, "
                      f"Val Accuracy: {val_acc * 100:.2f}%")
                writer.add_scalar("val loss", val_loss, epoch)
                writer.add_scalar("val accuracy", val_acc, epoch)
            elapsed = time.time() - start_time
            remaining = (config.max_iters - epoch - 1) * elapsed / (epoch + 1)
            print(f"Iter [{epoch + 1}/{config.max_iters}] - Elapsed Time: "
                  f"{elapsed:.2f}s - Remaining Time: [{remaining:.2f}]")
            if max_steps is not None:
                break
    except KeyboardInterrupt:
        if train_losses_hist:
            print(f"Keyboard interrupt,\nFinal Train Loss: "
                  f"{train_losses_hist[-1]:.4f}")
    finally:
        if prev_sigterm is not None:
            signal.signal(signal.SIGTERM, prev_sigterm)
        torch.save({k: v.detach().cpu() for k, v in
                    model.state_dict().items()}, final_path)
        writer.close()
        print(f"Model saved to {final_path}")

    summary.update(
        final_train_loss=train_losses_hist[-1] if train_losses_hist
        else None,
        final_val_loss=val_losses[-1] if val_losses else None,
        final_val_accuracy=val_percent[-1] if val_percent else None,
        global_step=global_step, train_losses=all_losses,
        val_losses=list(val_losses),
        best_val_loss=best_val_loss if val_losses else None,
        # early_stop_patience is refused (UNPORTED), so no run stops early
        stopped_early=False, checkpoint=final_path)
    return summary
