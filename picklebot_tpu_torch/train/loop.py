"""The trainer: ``train(config, max_steps=None, device="cuda")``.

The counterpart of ``picklebot_tpu/train/loop.py``: the datasets,
gradient accumulation (``effective_batch_size // batch_size`` microbatches
per optimizer step), epochs over ``max_iters`` with a per-epoch shuffle and
the cosine schedule stepped per epoch, per-microbatch TensorBoard scalars
under the JAX loop's tag names, an eval every ``eval_interval`` epochs (and
after the last) over the whole val set with the tail padded and masked,
and the final model written as a ``.pth`` with the reference keys (which
the port's ``serve`` and the JAX package's ``load_pth`` both load).

The trainer extras of the JAX loop: ``ema_decay`` (the eval scores the
EMA weights with the live BatchNorm statistics), ``freeze_params``,
``augment_*``, ``remat``, ``temporal_jitter``; full-state snapshots
(``train/checkpoint.py``) after every eval, every
``checkpoint_every_steps`` optimizer steps (keep-1), under ``_best/``
with ``save_best``, and at the end under ``{run_name}_finished/``, pruned
to ``keep_checkpoints``, written on a background thread with
``async_checkpoint``; ``auto_resume`` from the newest one, mid-epoch
included (the loader fast-forwards, dropout and augmentation are keyed
on the position, so the resumed run is the uninterrupted one);
``early_stop_patience`` / ``early_stop_min_delta`` with the JAX loop's
two baselines; ``warm_start`` (weights and BatchNorm statistics only) and
``warm_start_partial`` (the tensors whose key and shape match); the
``statistics/*.npy`` artifacts. Ctrl-C and SIGTERM end the run early and
still write the final snapshot and model. ``autotune`` measures
cuDNN's algorithm search off and on (``utils/autotune.py``) and keeps the
winner for the run.

Data parallelism: ``train()`` runs once per rank of a ``torch.distributed``
process group (``parallel/mesh.py``; the CLI joins it under torchrun), and
the replicas are the group's ranks, ``data_parallel`` (when set) must equal
its size and ``dcn_data_parallel`` divide it (torchrun numbers ranks node
by node, so the arithmetic is the one-level one, as the JAX hybrid mesh's
is). ``batch_size`` is per replica: the global batch is ``batch_size x
world``. Each rank loads its own ``ClipDataset`` shard, every batch pads
to ``max_frames`` past one rank, the ranks take the smallest shard's
number of train batches, and the eval's sums are added over the ranks
(the eval itself holds no collective, so the ranks need not agree on its
batch count). ``zero_sharding`` 1 or 3 shards the optimizer state (and at
3 the parameters) over the ranks (``parallel/zero.py``). Rank 0 alone
writes TensorBoard scalars, snapshots (full leaves, the optimizer state
stacked by rank), the ``.pth`` and the statistics; a resume reshards the
optimizer state for its own degree.

Tensor, sequence, pipeline and expert parallelism (``model_parallel``,
``sequence_parallel``, ``pipeline_parallel`` with
``pipeline_microbatches``, ``expert_parallel`` with ``moe_experts``;
MobileViT only): the process group is laid out as the JAX mesh
(``parallel/mesh.init_mesh``: data = world / (pipe x seq x expert x
model), 'model' innermost), the model is built with its FFNs sharded over
'model', its transformer tokens over 'seq', its stacks pipelined over
'pipe' and its expert banks over 'expert', the replicas are the 'data'
ranks (each loads the data shard of its data rank, and the eval's sums
are added over 'data'), the MoE load-balance losses enter the step with
``moe_aux_weight``, and snapshots and the ``.pth`` hold full leaves, cut
again for the ranks on resume. Runs start under torchrun as
data-parallel ones do.

A checkpoint this trainer cannot read (an Orbax snapshot) raises
NotImplementedError naming its ROADMAP.md item; no option is silently
ignored.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import os
import signal
import threading
import time
from typing import Optional

import numpy as np
import torch

from picklebot_tpu_torch.convert import local_state_dict, read_pth
from picklebot_tpu_torch.core.policy import DtypePolicy
from picklebot_tpu_torch.data.dataset import ClipDataset, read_annotations
from picklebot_tpu_torch.data.augment import Augment
from picklebot_tpu_torch.data.loader import DataLoader, accumulate_batches
from picklebot_tpu_torch.models.registry import initialize_model
from picklebot_tpu_torch.parallel import megatron, mesh
from picklebot_tpu_torch.parallel import zero as zero_mod
from picklebot_tpu_torch.train import checkpoint as ckpt
from picklebot_tpu_torch.train.freeze import freeze, frozen_summary
from picklebot_tpu_torch.train.metrics import SummaryWriter, windowed_average
from picklebot_tpu_torch.train.optim import OPTIMIZERS, cosine_annealing_lr
from picklebot_tpu_torch.train.step import (ema_init, make_eval_step,
                                            make_train_step)
from picklebot_tpu_torch.utils.autotune import (autotune_config,
                                                cudnn_benchmark)
from picklebot_tpu_torch.utils.config import Config
from picklebot_tpu_torch.utils.devices import resolve_device

# config option -> (is it set?, ROADMAP.md item that ports it): empty
# since every option of the JAX trainer is ported
UNPORTED = {}


def check_ported(config: Config):
    """Raise NotImplementedError for the first option set in ``config``
    that this trainer does not port and for a checkpoint that is neither
    a .pth nor a snapshot of this trainer (an Orbax directory), and
    ValueError for MoViNetA2Stream,
    which neither package trains (the JAX train step passes its forward
    no carry), and for MobileViTV2, an image classifier that the clip
    pipeline cannot feed (the JAX loop refuses it alike)."""
    if config.model_name == "MobileViTV2":
        raise ValueError(
            "MobileViTV2 is an image classifier; the clip training loop "
            "cannot feed it. Use the step API with image batches "
            "(picklebot_tpu_torch.train.step.make_train_step, "
            "make_predict_fn; see python -m picklebot_tpu_torch.bench "
            "--model MobileViTV2).")
    if config.model_name == "MoViNetA2Stream":
        raise ValueError(
            "MoViNetA2Stream is a serving model: the clip trainer passes no "
            "stream carry. Train MoViNetA2 (the same parameters and keys) "
            "and serve its .pth as MoViNetA2Stream")
    for name, (is_set, item) in UNPORTED.items():
        if is_set(config):
            raise NotImplementedError(
                f"config {name}={getattr(config, name)!r} is not ported to "
                f"the PyTorch trainer yet (ROADMAP.md, {item})")
    if config.checkpoint:
        _check_checkpoint(config.checkpoint)


def _check_checkpoint(path: str):
    if not path.endswith(".pth") and not ckpt.is_snapshot(path):
        raise NotImplementedError(
            f"checkpoint {path!r}: the PyTorch trainer reads a .pth or its "
            "own snapshot files; Orbax snapshots are the JAX package's "
            "(export one's weights as a .pth with python -m "
            "picklebot_tpu.convert; ROADMAP.md, queue A, item A8)")


def check_world(config: Config, world: int) -> int:
    """The parallel degrees of ``config`` against the process group's
    ``world`` size, by the JAX loop's rules: ``model_parallel`` x
    ``sequence_parallel`` x ``pipeline_parallel`` x ``expert_parallel``
    must divide it, the quotient is the data degree, ``data_parallel``
    (when set) must equal that and ``dcn_data_parallel`` divide it.
    Returns the data degree."""
    inner = (config.model_parallel * config.sequence_parallel
             * config.pipeline_parallel * config.expert_parallel)
    if world % inner:
        raise ValueError(
            f"model_parallel={config.model_parallel} x sequence_parallel="
            f"{config.sequence_parallel} x pipeline_parallel="
            f"{config.pipeline_parallel} x expert_parallel="
            f"{config.expert_parallel} needs a multiple of {inner} ranks; "
            f"the process group has {world}: launch torchrun "
            f"--nproc_per_node {inner} (or a multiple)")
    n_data = world // inner
    if config.data_parallel is not None and config.data_parallel != n_data:
        raise ValueError(
            f"data_parallel={config.data_parallel} but the process group "
            f"has {world} rank(s), {n_data} replica(s) of {inner}: launch "
            f"one process per rank (torchrun --nproc_per_node "
            f"{config.data_parallel * inner} -m picklebot_tpu_torch.cli "
            "...) or leave data_parallel unset")
    if n_data % config.dcn_data_parallel:
        raise ValueError(f"dcn_data_parallel={config.dcn_data_parallel} "
                         f"must divide the {n_data} replica(s)")
    return n_data


class _NoWriter:
    """The TensorBoard writer of a rank other than 0: writes nothing."""

    def add_scalar(self, *args, **kwargs):
        pass

    def close(self):
        pass


def _make_datasets(config: Config):
    """The train and val datasets, each this rank's shard."""
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
                  skip_bad_clips=config.skip_bad_clips,
                  shard=mesh.axis_index("data"),
                  num_shards=mesh.axis_size("data"))
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


def _warm_graft(model, donor, model_name):
    """warm_start_partial: load the donor tensors whose key and shape
    match, keep the fresh values of the rest, and say which; grafting no
    parameter at all is an error (a wrong donor)."""
    fresh = model.state_dict()
    merged, grafted, skipped = ckpt.graft_matching(donor, fresh)
    params = {n for n, _ in model.named_parameters()}
    if not params & set(grafted):
        raise ValueError(
            "warm_start_partial: NO donor param leaf matched the fresh "
            f"{model_name}: wrong donor checkpoint? First donor keys: "
            f"{[k for k, _ in skipped[:5]]}")
    for key, why in skipped:
        print(f"warm_start_partial: kept fresh {key} ({why})")
    print(f"warm_start_partial: grafted {len(grafted)} tensors; "
          f"{len(skipped)} kept fresh init")
    model.load_state_dict(merged, strict=True)


def train(config: Config, max_steps: Optional[int] = None,
          device="cuda") -> dict:
    """Train ``config``'s model on ``device`` (``cuda`` raises without a
    card); stop after ``max_steps`` optimizer steps if given. Returns a
    summary dict (losses, accuracies, the final model's path). In a
    process group every rank calls it, with its own device.

    With ``autotune`` the measured ``cudnn.benchmark`` choice
    (``utils/autotune.py``, cached; ``varying_input_size`` skips it)
    holds for the run, and the flag is restored after. ``profile`` is the
    CLI's (cProfile around this call)."""
    check_ported(config)
    check_world(config, mesh.world())
    mesh.init_mesh(model=config.model_parallel, seq=config.sequence_parallel,
                   pipe=config.pipeline_parallel,
                   expert=config.expert_parallel)
    device = resolve_device(device)
    benchmark = None
    if config.autotune:
        config, benchmark = autotune_config(config, "train", device=device)
        print(f"autotune: cudnn.benchmark={benchmark}")
    with cudnn_benchmark(benchmark):
        return _train(config, max_steps, device)


def _train(config: Config, max_steps: Optional[int], device) -> dict:
    policy = DtypePolicy.bf16() if config.use_autocast else DtypePolicy.f32()
    n_ranks, rank, is_main = mesh.world(), mesh.rank(), mesh.is_main()
    n_data = mesh.axis_size("data")
    # TP or EP: the ranks hold shards, so snapshots are collectives
    sharded = config.model_parallel > 1 or config.expert_parallel > 1
    model = initialize_model(config)
    if config.freeze_params:
        # before the optimizer is built: it keeps the trainable ones only
        mask = freeze(model, config.model_name, config.freeze_params)
        fl, tl, fn, tn = frozen_summary(model, mask)
        print(f"Freezing {fl}/{tl} param leaves ({fn:,}/{tn:,} params) "
              f"via {config.freeze_params}")

    # ---- resume (a snapshot) or warm start (a .pth, or a snapshot's
    # weights and BatchNorm statistics with warm_start) ----
    snap_dir = os.path.join(config.checkpoint_dir, config.model_name)
    start_epoch = resume_skip = resume_global_step = 0
    resume_best = resume_baseline = float("inf")
    resume_evals = 0
    opt_state = ema_state = None
    if config.auto_resume and (not config.checkpoint or config.warm_start):
        # a warm start's own snapshots outrank its donor: after a
        # preemption the fine-tune resumes itself
        latest = ckpt.latest_checkpoint(snap_dir)
        if latest:
            _check_checkpoint(latest)
            print(f"auto_resume: found {latest}")
            config = dataclasses.replace(config, checkpoint=latest,
                                         warm_start=False)
    if config.checkpoint:
        print(f"Loading checkpoint {config.checkpoint}...")
        # a .pth holds weights and BatchNorm statistics only: a warm start
        if config.checkpoint.endswith(".pth"):
            payload, warm = {"model": read_pth(config.checkpoint)}, True
        else:
            payload = ckpt.load_checkpoint(config.checkpoint)
            warm = config.warm_start
        # full leaves on disk: this rank's TP / EP shards
        payload["model"] = local_state_dict(payload["model"])
        if payload.get("ema") is not None:
            payload["ema"] = local_state_dict(payload["ema"])
        if warm and config.warm_start_partial:
            _warm_graft(model, payload["model"], config.model_name)
        else:
            model.load_state_dict(payload["model"], strict=True)
        if not warm:
            opt_state, ema_state = payload["optimizer"], payload["ema"]
            start_epoch = int(payload["epoch"])
            resume_global_step, resume_skip = (
                int(v) for v in payload["loop_state"].tolist())
            resume_best, resume_baseline, evals = \
                payload["early_stop"].tolist()
            resume_evals = int(evals)
        elif config.warm_start:
            print("warm_start: loaded weights + BN stats; optimizer, "
                  "epoch and early-stop state start fresh")
        if resume_skip:
            print(f"Loaded checkpoint at epoch {start_epoch}, "
                  f"optimizer step {resume_skip} within the epoch")
        else:
            print(f"Loaded checkpoint at epoch {start_epoch}")
    model.to(device)
    # the EMA is seeded from the (possibly restored) weights when a run
    # turns it on, and dropped when it turns it off
    ema = None
    if config.ema_decay > 0:
        ema = ema_init(model) if ema_state is None else {
            k: v.to(device) for k, v in ema_state.items()}
    zero = None
    if config.zero_sharding and n_ranks > 1:
        zero = zero_mod.ZeroLayout(model, n_ranks, rank,
                                   stage=int(config.zero_sharding))
        optimizer = zero_mod.zero_optimizer(
            OPTIMIZERS[config.optimizer], zero,
            weight_decay=config.weight_decay)
        if ema is not None and zero.stage == 3:
            ema = {k: zero.shard_value(ema[k], i).clone()
                   for i, k in enumerate(zero.names)}
    else:
        optimizer = OPTIMIZERS[config.optimizer](
            model.parameters(), weight_decay=config.weight_decay)
    if opt_state is not None:
        n_want = n_ranks if zero is not None else 0
        n_saved = zero_mod.zero_degree_of(opt_state)
        if n_saved != n_want:
            print(f"Resharding optimizer state: ZeRO degree {n_saved} -> "
                  f"{n_want}")
            opt_state = zero_mod.zero_reshard(optimizer, opt_state, n_want,
                                              n_old=n_saved)
        if zero is not None:
            opt_state = zero_mod.local_optimizer_state(zero, opt_state)
        else:
            opt_state = megatron.local_optimizer_state(opt_state, optimizer,
                                                       model)
        optimizer.load_state_dict(opt_state)
    schedule = cosine_annealing_lr(config.learning_rate, config.max_iters,
                                   warmup=config.warmup_epochs)
    mean = config.mean if config.apply_mean_std else None
    std = config.std if config.apply_mean_std else None
    train_step = make_train_step(
        model, optimizer, config.criterion, schedule, policy, mean, std,
        config.max_grad_norm, config.label_smoothing, config.seed, device,
        remat=int(config.remat),
        augment=Augment(flip=config.augment_flip, crop=config.augment_crop,
                        brightness=config.augment_brightness),
        ema=ema, ema_decay=config.ema_decay, input_size=config.input_size,
        zero=zero, moe_aux_weight=config.moe_aux_weight)
    eval_step = make_eval_step(model, config.criterion, policy, mean, std,
                               device, input_size=config.input_size)

    train_ds, val_ds = _make_datasets(config)
    batch, accum = config.batch_size, config.grad_accum_steps
    # past one rank every batch pads to max_frames: one shape on all ranks
    loader_kw = dict(num_workers=config.num_workers,
                     t_bucket=(config.max_frames if n_ranks > 1
                               else config.t_bucket),
                     max_frames=config.max_frames)
    train_loader = DataLoader(train_ds, batch, shuffle=True,
                              seed=config.seed, drop_last=True,
                              temporal_jitter=config.temporal_jitter,
                              **loader_kw)
    # the whole val set: the tail batch is padded and masked in eval_step
    val_loader = DataLoader(val_ds, batch, shuffle=False, drop_last=False,
                            **loader_kw)
    # the ranks' shards can differ by a batch: all take the smallest count
    n_train = mesh.min_int(len(train_loader)) if n_ranks > 1 else None
    print(f"Using {accum} gradient accumulation steps for a total effective "
          f"batch size of {config.effective_batch_size}"
          + (f" per replica, {n_data} replicas" if n_data > 1 else ""))

    writer = (SummaryWriter(os.path.join(config.log_dir, config.run_name()))
              if is_main else _NoWriter())
    os.makedirs(config.checkpoint_dir, exist_ok=True)
    final_path = os.path.join(config.checkpoint_dir,
                              f"{config.run_name()}_finished.pth")
    start_time = time.time()
    print(f"Training... started: {time.ctime(start_time)}")
    global_step = resume_global_step
    state_epoch = start_epoch   # the JAX TrainState.epoch: +1 per epoch
    supers_in_epoch = 0         # optimizer steps into the current epoch
    train_losses_hist, train_acc_hist, all_losses = [], [], []
    val_losses, val_percent = [], []
    # two baselines, as in the JAX loop (Keras EarlyStopping): the best
    # moves on any improvement and gates save_best; the patience baseline
    # only on one larger than early_stop_min_delta
    best_val_loss = resume_best
    patience_baseline = resume_baseline
    evals_since_improve = resume_evals
    stopped_early = False
    summary = {}
    snapshots = ckpt.SnapshotWriter()

    def save(directory, epoch, minor=None, block=None):
        # under ZeRO, TP or EP the snapshot is a collective; rank 0
        # writes it
        block = not config.async_checkpoint if block is None else block
        if is_main or zero is not None or sharded:
            payload = ckpt.snapshot(
                model, optimizer, ema, state_epoch,
                [global_step, supers_in_epoch],
                [best_val_loss, patience_baseline, evals_since_improve],
                zero=zero)
        if is_main:
            snapshots.save(directory, epoch, payload, block=block,
                           minor=minor)
        if block:
            mesh.barrier()

    def prune(fn, directory, keep):
        if is_main:
            fn(directory, keep=keep)

    ncls = 2 if config.criterion == "BCE" else config.num_classes

    def run_eval():
        tot_loss, tot_correct, tot_n = 0.0, 0.0, 0.0
        tot_conf = np.zeros((ncls, ncls))
        print("Evaluating...")
        # the EMA weights are scored, with the live BatchNorm statistics
        live = None
        with zero_mod.gathered(zero):
            if ema is not None:
                live = {n: p.detach().clone()
                        for n, p in model.named_parameters()}
                _load_params(model, ema if zero is None or zero.stage == 1
                             else zero_mod.zero3_unshard_params(
                                 zero, [ema[k] for k in zero.names]))
            try:
                for feats, labels in val_loader:
                    out = eval_step(*_pad_val_batch(feats, labels, batch))
                    tot_loss += out["loss_sum"]
                    tot_correct += out["correct"]
                    tot_n += out["samples"]
                    tot_conf += out["confusion"]
            finally:
                if live is not None:
                    _load_params(model, live)
        if n_data > 1:
            # every replica's sums (a replica's own shard of the val set)
            sums = torch.tensor(
                [tot_loss, tot_correct, tot_n, *tot_conf.ravel()],
                dtype=torch.float64, device=device)
            sums = mesh.all_reduce_sum_(sums, "data").cpu().numpy()
            tot_loss, tot_correct, tot_n = (float(v) for v in sums[:3])
            tot_conf = sums[3:].reshape(ncls, ncls)
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
        for epoch in range(start_epoch, config.max_iters):
            train_loader.set_epoch(epoch)
            epoch_correct, epoch_samples = 0.0, 0.0
            batch_losses, batch_acc = [], []
            # a mid-epoch resume: past the steps this epoch already took
            if epoch == start_epoch and resume_skip:
                train_loader.skip(resume_skip * accum)
                supers_in_epoch = resume_skip
            feed = accumulate_batches(iter(train_loader), accum)
            if n_train is not None:
                feed = itertools.islice(
                    feed, max(0, n_train // accum - supers_in_epoch))
            for feats, labels in feed:
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
                supers_in_epoch += 1
                if config.checkpoint_every_steps and supers_in_epoch % \
                        config.checkpoint_every_steps == 0:
                    # step_<epoch>_<n>, keep-1 before saving: at most two
                    # mid-epoch snapshots on disk
                    prune(ckpt.prune_midepoch, snap_dir, 1)
                    save(snap_dir, epoch, minor=supers_in_epoch)
                if max_steps is not None and steps_this_run >= max_steps:
                    break
            state_epoch += 1          # the scheduler's step
            supers_in_epoch = 0
            if batch_losses:
                train_losses_hist.extend(windowed_average(batch_losses))
                train_acc_hist.extend(windowed_average(batch_acc))
            if epoch % config.eval_interval == 0 or \
                    epoch == config.max_iters - 1:
                val_loss, val_acc, val_n, val_conf = run_eval()
                val_losses.append(val_loss)
                val_percent.append(val_acc)
                summary["val_samples"] = val_n
                if val_conf is not None:
                    summary["val_confusion"] = val_conf
                tl = train_losses_hist[-1] if train_losses_hist \
                    else float("nan")
                ta = train_acc_hist[-1] if train_acc_hist else float("nan")
                if is_main:
                    print(f"Step {epoch}: Train Loss: {tl:.4f}, "
                          f"Val Loss: {val_loss:.4f}")
                    print(f"Step {epoch}: Train Accuracy: "
                          f"{ta * 100:.2f}%, Val Accuracy: "
                          f"{val_acc * 100:.2f}%")
                writer.add_scalar("val loss", val_loss, epoch)
                writer.add_scalar("val accuracy", val_acc, epoch)
                # best and patience move before the epoch's snapshot, so
                # that a resume from it tracks them as this run does; a
                # NaN eval (an empty val set) moves neither
                if not math.isnan(val_loss):
                    if val_loss < patience_baseline - \
                            config.early_stop_min_delta:
                        evals_since_improve = 0
                        patience_baseline = val_loss
                    else:
                        evals_since_improve += 1
                improved_best = val_loss < best_val_loss
                best_val_loss = track_best(best_val_loss, val_loss)
                save(snap_dir, epoch)
                if config.checkpoint_every_steps:
                    prune(ckpt.prune_midepoch, snap_dir, 1)
                if config.keep_checkpoints:
                    prune(ckpt.prune_epochs, snap_dir,
                          config.keep_checkpoints)
                if improved_best and config.save_best:
                    best_dir = os.path.join(config.checkpoint_dir,
                                            f"{config.model_name}_best")
                    prune(ckpt.prune_epochs, best_dir, 1)
                    save(best_dir, epoch)
                if config.early_stop_patience and \
                        evals_since_improve >= config.early_stop_patience:
                    stopped_early = True
                    print(f"Early stopping at epoch {epoch}: no val-loss "
                          f"improvement in {evals_since_improve} evals "
                          f"(best {best_val_loss:.4f})")
                    break
            elapsed = time.time() - start_time
            done = epoch - start_epoch + 1
            remaining = (config.max_iters - epoch - 1) * elapsed / done
            if is_main:
                print(f"Iter [{epoch + 1}/{config.max_iters}] - Elapsed "
                      f"Time: {elapsed:.2f}s - Remaining Time: "
                      f"[{remaining:.2f}]")
            if max_steps is not None:
                break
    except KeyboardInterrupt:
        if train_losses_hist:
            print(f"Keyboard interrupt,\nFinal Train Loss: "
                  f"{train_losses_hist[-1]:.4f}")
    finally:
        if prev_sigterm is not None:
            signal.signal(signal.SIGTERM, prev_sigterm)
        snapshots.wait()
        save(os.path.join(config.checkpoint_dir,
                          f"{config.run_name()}_finished"), state_epoch,
             block=True)
        with zero_mod.gathered(zero):
            weights = {k: v.detach().cpu() for k, v in
                       ckpt.full_state_dict(model).items()}
        if is_main:
            torch.save(weights, final_path)
            _save_statistics(config.run_name(), train_losses_hist,
                             train_acc_hist, val_losses, val_percent,
                             summary.get("val_confusion"))
            print(f"Model saved to {final_path}")
        writer.close()
        mesh.barrier()

    summary.update(
        final_train_loss=train_losses_hist[-1] if train_losses_hist
        else None,
        final_val_loss=val_losses[-1] if val_losses else None,
        final_val_accuracy=val_percent[-1] if val_percent else None,
        global_step=global_step, train_losses=all_losses,
        val_losses=list(val_losses),
        best_val_loss=best_val_loss if val_losses else None,
        stopped_early=stopped_early, checkpoint=final_path)
    return summary


def _load_params(model, values):
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(values[n])


def _save_statistics(run_name, train_losses, train_acc, val_losses,
                     val_percent, confusion):
    """``statistics/{run_name}_finished_*.npy`` (relative to the working
    directory), the JAX loop's names and shapes: windowed train losses
    and accuracies as (n, 1), val losses and accuracies as (n,), the last
    eval's confusion matrix."""
    os.makedirs("statistics", exist_ok=True)
    base = os.path.join("statistics", f"{run_name}_finished")
    np.save(f"{base}_train_losses.npy",
            np.asarray(train_losses).reshape(-1, 1))
    np.save(f"{base}_train_percent.npy",
            np.asarray(train_acc).reshape(-1, 1))
    np.save(f"{base}_val_losses.npy", np.asarray(val_losses))
    np.save(f"{base}_val_percent.npy", np.asarray(val_percent))
    if confusion is not None:
        np.save(f"{base}_val_confusion.npy", confusion)
