"""The system under test: the PyTorch/CUDA port, ``picklebot_tpu_torch``.

The harness reaches the program only through this module and the
generators, and only through the program's public entries: its config,
its model registry, ``train.step`` and ``serve``. The benchmark's own
seeded state dict replaces the weights the model draws at construction.
"""

from __future__ import annotations

import dataclasses


def config(cfg: dict):
    """The program's ``Config`` of a configuration file: its keys that
    the program knows (the benchmark's own keys are left out)."""
    from picklebot_tpu_torch.utils.config import Config
    known = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: v for k, v in cfg.items() if k in known}).validate()


def policy(pcfg):
    from picklebot_tpu_torch.core.policy import DtypePolicy
    return DtypePolicy.bf16() if pcfg.use_autocast else DtypePolicy.f32()


def model(pcfg, state: dict, device):
    """The configuration's model on ``device`` holding ``state``."""
    from picklebot_tpu_torch.models.registry import initialize_model
    m = initialize_model(pcfg).to(device)
    m.load_state_dict(state)
    return m


def mean_std(pcfg):
    return ((pcfg.mean, pcfg.std) if pcfg.apply_mean_std
            else (None, None))


def predictor(m, pcfg, device):
    """``make_predict_fn`` as ``serve`` builds it for a checkpoint."""
    from picklebot_tpu_torch.train.step import make_predict_fn
    mean, std = mean_std(pcfg)
    return make_predict_fn(m, policy(pcfg), mean=mean, std=std,
                           input_size=pcfg.input_size, device=device)


def records_fn(predict, pcfg, max_batch):
    from picklebot_tpu_torch import serve
    return serve.records_fn(predict, pcfg, max_batch)


def train_step(m, pcfg, seed, device):
    """(step, optimizer): the optimizer and ``make_train_step`` as the
    trainer (``train/loop.py``) builds them for one process."""
    from picklebot_tpu_torch.data.augment import Augment
    from picklebot_tpu_torch.train.optim import (OPTIMIZERS,
                                                 cosine_annealing_lr)
    from picklebot_tpu_torch.train.step import make_train_step
    optimizer = OPTIMIZERS[pcfg.optimizer](m.parameters(),
                                           weight_decay=pcfg.weight_decay)
    schedule = cosine_annealing_lr(pcfg.learning_rate, pcfg.max_iters,
                                   warmup=pcfg.warmup_epochs)
    mean, std = mean_std(pcfg)
    step = make_train_step(
        m, optimizer, pcfg.criterion, schedule, policy(pcfg), mean, std,
        pcfg.max_grad_norm, pcfg.label_smoothing, seed, device,
        remat=int(pcfg.remat),
        augment=Augment(flip=pcfg.augment_flip, crop=pcfg.augment_crop,
                        brightness=pcfg.augment_brightness),
        input_size=pcfg.input_size, moe_aux_weight=pcfg.moe_aux_weight)
    return step, optimizer


def optimizer_state(optimizer) -> dict:
    """The optimizer's ``state_dict``: ``steps``, and per parameter, in
    the model's order, an f32 moment or an 8-bit (codes, scales) pair."""
    return optimizer.state_dict()
