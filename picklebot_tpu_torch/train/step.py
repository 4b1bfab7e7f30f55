"""Train, eval and inference steps: uint8 clips or images -> loss,
metrics, logits.

Counterpart of ``preprocess``, ``make_train_step``, ``make_eval_step``,
``make_predict_fn`` and ``make_sharded_predict_fn`` in
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

Data parallelism (the JAX step under its 'data' mesh axis): when a
``torch.distributed`` process group exists (``parallel/mesh.py``), each
rank runs its own share of the batch, BatchNorm takes its batch
statistics from that share alone (per-replica BatchNorm, as DDP), and
after the last microbatch one flat f32 all-reduce averages the summed
gradients (the sum, then / world: the JAX ``pmean``); the BatchNorm
running means and variances are averaged too, the per-microbatch losses
averaged and the correct counts and samples summed over the ranks; the
clip works on the averaged gradients. With more than one rank the rank is
folded into the dropout and augmentation seeds (the JAX step folds
``axis_index('data')`` into its key); at world 1 the seeds are those of a
run without a group. No ``DistributedDataParallel``: it would all-reduce
every microbatch and broadcast rank 0's buffers where the JAX package
averages them. ``zero`` (a ``parallel.zero.ZeroLayout``) replaces the
gradient all-reduce by ZeRO's reduce-scatter, sliced update and (stage 1)
all-gather; at stage 3 the step gathers the parameters first and
releases them after, and the EMA lives in the rank's chunks.

Under a mesh (``mesh.init_mesh``: tensor parallelism over 'model',
sequence parallelism over 'seq', pipeline parallelism over 'pipe', expert
parallelism over 'expert', the JAX step under shard_map) every replica
reduction above runs over 'data' alone: gradients, BatchNorm statistics,
losses and correct counts, and the seeds fold in the data rank only, so
the other ranks of one replica draw the same masks. The gradients of the
token-sharded transformer stacks are first summed over 'seq'
(``parallel/sequence.sp_sync_grads``) and those of the pipelined ones over
'pipe' (``parallel/pipeline.pp_sync_grads``). The global-norm clip counts
a sharded parameter's squared norm summed over its axis ('model' or
'expert') and a replicated one once, so every rank scales by the same
factor. The MoE feed-forwards' load-balance losses (``ops/moe.py``), times
``moe_aux_weight``, join each microbatch's backward loss; the logged
``loss`` stays the task loss (the JAX ``collect_aux_losses``).

In a torch profiler's trace (``utils/profiling.span``) a train step's
phases are spans that tile it: ``picklebot.step.input`` (the microbatch's
H2D copy, ``preprocess``, the augmentation, the labels),
``picklebot.step.forward`` (the forward, the loss and the MoE aux sum)
and ``picklebot.step.backward`` per microbatch, then
``picklebot.step.update`` once (the replica reductions, the clip, the
optimizer or ZeRO update, the EMA, the stage-3 release).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from picklebot_tpu_torch.core.policy import DtypePolicy
from picklebot_tpu_torch.core.remat import apply_remat
from picklebot_tpu_torch.data.augment import apply_augment, draw_augment
from picklebot_tpu_torch.ops.linear import dropout_rng
from picklebot_tpu_torch.ops.resize import resize_frames
from picklebot_tpu_torch.parallel import mesh
from picklebot_tpu_torch.parallel import zero as zero_mod
from picklebot_tpu_torch.parallel.megatron import layout
from picklebot_tpu_torch.parallel.pipeline import pp_sync_grads
from picklebot_tpu_torch.parallel.sequence import sp_sync_grads
from picklebot_tpu_torch.train.losses import (LOSSES, LOSSES_PER_SAMPLE,
                                              prepare_labels, smoothed_bce,
                                              smoothed_cross_entropy)
from picklebot_tpu_torch.utils.profiling import span


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


def make_sharded_predict_fn(model, devices, policy: DtypePolicy = None,
                            mean=None, std=None, input_size=None):
    """Data-parallel inference over ``devices`` (e.g. ``["cuda:0",
    "cuda:1"]``): one eval-mode replica of ``model`` per listed device (a
    device may be listed twice); a batch is zero-padded to a multiple of
    their number, split in equal chunks, each chunk run on its replica
    (every replica's kernels launched before any result is read), and the
    logits concatenated and trimmed to the batch. Same contract as
    ``make_predict_fn``."""
    policy = policy or DtypePolicy.bf16()
    devices = [torch.device(d) for d in devices]
    replicas = [copy.deepcopy(model).to(d).eval() for d in devices]

    def predict(features: np.ndarray) -> np.ndarray:
        b, n = features.shape[0], len(replicas)
        pad = (-b) % n
        if pad:
            features = np.concatenate(
                [features, np.zeros((pad,) + features.shape[1:],
                                    features.dtype)])
        outs = []
        with torch.inference_mode(), policy.precision():
            for rep, dev, chunk in zip(replicas, devices,
                                       np.split(features, n)):
                x = torch.from_numpy(np.ascontiguousarray(chunk)).to(dev)
                x = preprocess(x, policy.compute_dtype, mean, std,
                               input_size)
                outs.append(rep(x).float())
            return np.concatenate([o.cpu().numpy() for o in outs])[:b]

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
                    input_size=None, zero=None, data_parallel=None,
                    moe_aux_weight: float = 0.01):
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
    in ``preprocess``, before the augmentation.

    Under a process group the features are this rank's share and the
    metrics the replicas' (``loss`` averaged, ``correct`` and ``samples``
    summed). ``zero``: a ``parallel.zero.ZeroLayout`` over ``model``,
    with ``optimizer`` built on its slices (``zero.zero_optimizer``); at
    stage 3 ``ema`` holds the rank's chunks, {name: (chunk,) f32}.
    ``data_parallel=False`` runs this process alone even under a group
    (the bench's measurement, which the autotuner makes on rank 0 only).
    ``moe_aux_weight`` scales the MoE load-balance losses added to each
    microbatch's backward loss."""
    policy = policy or DtypePolicy.bf16()
    device = torch.device(device)
    if remat:
        apply_remat(model, remat)
    aug = augment if augment is not None and augment.enabled() else None
    if ema_decay > 0 and ema is None:
        raise ValueError("ema_decay > 0 needs the EMA weights: pass "
                         "ema=ema_init(model)")
    d = np.float32(ema_decay)
    stage3 = zero is not None and zero.stage == 3
    ema_pairs = []
    if ema_decay > 0:
        ema_pairs = ([(ema[n], s) for n, s in zip(zero.names, zero.shards)]
                     if stage3 else
                     [(ema[n], p) for n, p in model.named_parameters()])
    dp = mesh.distributed() if data_parallel is None else data_parallel
    n_ranks = mesh.axis_size("data") if dp else 1
    # the data rank folded into the seeds only past one replica: at one
    # the dropout and augmentation draws are those of a run without a
    # group
    key_seed = (seed if n_ranks == 1
                else _micro_seed(seed, -1 - mesh.axis_index("data")))
    statistics = [b for k, b in model.named_buffers()
                  if k.endswith((".running_mean", ".running_var"))]
    loss_fn, acc_fn = LOSSES[criterion]
    if label_smoothing > 0.0:
        loss_fn = (smoothed_cross_entropy(label_smoothing) if criterion == "CE"
                   else smoothed_bce(label_smoothing))
    params = [p for p in model.parameters() if p.requires_grad]
    sharded = layout(model)
    # index of each sharded trainable parameter -> its axis
    shard_axes = {i: sharded[n][0] for i, (n, p) in enumerate(
        (n, p) for n, p in model.named_parameters() if p.requires_grad)
        if n in sharded}
    aux_modules = [m for m in model.modules() if hasattr(m, "aux_loss")]
    generator = torch.Generator(device=device)

    def step(epoch, features, labels, position: int = 0):
        lr = schedule(epoch)
        feats, lbls = torch.as_tensor(features), torch.as_tensor(labels)
        model.train()
        if stage3:
            zero_mod.zero3_gather_params(zero)
        for p in params:
            p.grad = None
        losses, corrects = [], []
        with policy.precision():
            for i in range(feats.shape[0]):
                with span("picklebot.step.input"):
                    x = feats[i].to(device)
                    if aug is None:
                        x = preprocess(x, policy.compute_dtype, mean, std,
                                       input_size)
                    else:
                        x = preprocess(x, policy.compute_dtype,
                                       input_size=input_size)
                        x = apply_augment(x, draw_augment(
                            aug, x.shape[0], key_seed, position + i),
                            aug.crop)
                        x = standardize(x, mean, std)
                    lbl = prepare_labels(criterion, lbls[i].to(device))
                with span("picklebot.step.forward"):
                    generator.manual_seed(_micro_seed(key_seed, position + i))
                    with dropout_rng(generator):
                        logits = model(x)
                    loss = total = loss_fn(logits, lbl)
                    if aux_modules:
                        # read before the backward: a remat recompute
                        # overwrites aux_loss with its own value
                        aux = sum(m.aux_loss.float() for m in aux_modules)
                        total = loss + moe_aux_weight * aux
                    corrects.append(acc_fn(logits.detach(), lbl))
                with span("picklebot.step.backward"):
                    total.backward()
                for m in aux_modules:
                    m.aux_loss = None
                losses.append(loss.detach())
        with span("picklebot.step.update"), policy.precision():
            metrics = {"loss": torch.stack(losses),
                       "correct": torch.stack(corrects),
                       "samples": float(feats.shape[0] * feats.shape[1]
                                        * n_ranks),
                       "lr": lr}
            if dp:
                _reduce_replicas(metrics, statistics, n_ranks)
                sp_sync_grads(model)
                pp_sync_grads(model)
            if zero is not None:
                update = (zero_mod.zero3_update if stage3
                          else zero_mod.zero_update)
                norm = update(zero, optimizer, lr, max_grad_norm)
                if norm is not None:
                    metrics["grad_norm"] = norm
            else:
                if dp:
                    for p in params:
                        if p.grad is None:
                            p.grad = torch.zeros_like(p)
                    mesh.all_reduce_mean_([p.grad for p in params], "data")
                if max_grad_norm is not None:
                    norm = torch.sqrt(sum(_squares(params, shard_axes)))
                    scale = torch.clamp(max_grad_norm / (norm + 1e-6),
                                        max=1.0)
                    for p in params:
                        if p.grad is not None:
                            p.grad.mul_(scale)
                    metrics["grad_norm"] = norm
                optimizer.step(lr)
            with torch.no_grad():
                for e, p in ema_pairs:
                    e.mul_(float(d)).add_(p.float() * float(1 - d))
            if stage3:
                zero_mod.zero3_release_params(zero)
        return metrics

    return step


def _squares(params, shard_axes):
    """Each gradient's f32 squared norm, in parameter order; those of the
    sharded parameters (``shard_axes``: index -> axis) summed over their
    axis, one all-reduce per axis."""
    sq = [None if p.grad is None else p.grad.float().pow(2).sum()
          for p in params]
    for axis in sorted(set(shard_axes.values())):
        idx = [i for i, a in shard_axes.items()
               if a == axis and sq[i] is not None]
        if idx:
            total = mesh.all_reduce_sum_(torch.stack([sq[i] for i in idx]),
                                         axis)
            for j, i in enumerate(idx):
                sq[i] = total[j]
    return [s for s in sq if s is not None]


def _reduce_replicas(metrics, statistics, n_ranks):
    """The replicas' metrics and BatchNorm running statistics over 'data',
    in place: losses averaged and correct counts summed (one all-reduce),
    running means and variances averaged (one more)."""
    a = metrics["loss"].numel()
    both = torch.cat([metrics["loss"].float(), metrics["correct"].float()])
    mesh.all_reduce_sum_(both, "data")
    metrics["loss"] = both[:a] / n_ranks
    metrics["correct"] = both[a:].to(metrics["correct"].dtype)
    with torch.no_grad():
        mesh.all_reduce_mean_(statistics, "data")


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
