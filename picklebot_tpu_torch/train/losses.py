"""Losses and accuracy metrics, all in f32.

Counterpart of ``picklebot_tpu/train/losses.py``: CE as torch
nn.CrossEntropyLoss (mean, integer labels), BCE as nn.BCEWithLogitsLoss on
(B, 1) float labels, their label-smoothed forms and the per-sample
variants the masked eval uses.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy_per_sample(logits, labels):
    """logits (B, C), labels (B,) int -> (B,) per-sample NLL."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None])[:, 0]


def cross_entropy(logits, labels):
    return cross_entropy_per_sample(logits, labels).mean()


def smoothed_cross_entropy(eps: float):
    """CE against (1-eps)*onehot + eps/C (torch ``label_smoothing=``):
    (1-eps)*NLL + eps*mean_c(-log p_c)."""
    def loss(logits, labels):
        logp = F.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
        return ((1.0 - eps) * nll + eps * -logp.mean(-1)).mean()

    return loss


def bce_per_sample(logits, labels):
    """logits (B, 1), labels (B, 1) -> (B,): max(x, 0) - x*y +
    log(1 + exp(-|x|))."""
    x, y = logits.float(), labels.float()
    return (x.clamp(min=0) - x * y + torch.log1p(torch.exp(-x.abs())))[:, 0]


def bce_with_logits(logits, labels):
    return bce_per_sample(logits, labels).mean()


def smoothed_bce(eps: float):
    """BCE against y*(1-eps) + eps/2."""
    def loss(logits, labels):
        return bce_with_logits(logits, labels.float() * (1.0 - eps)
                               + eps / 2.0)

    return loss


def correct_ce(logits, labels):
    """(B,) 1.0 where the argmax is the label."""
    return (logits.argmax(-1) == labels.long()).float()


def accuracy_ce(logits, labels):
    return correct_ce(logits, labels).sum()


def correct_bce(logits, labels, threshold: float = 0.5):
    preds = (torch.sigmoid(logits.float()) >= threshold).float()
    return (preds == labels.float()).float()[:, 0]


def accuracy_bce(logits, labels, threshold: float = 0.5):
    return correct_bce(logits, labels, threshold).sum()


LOSSES = {"CE": (cross_entropy, accuracy_ce),
          "BCE": (bce_with_logits, accuracy_bce)}
LOSSES_PER_SAMPLE = {"CE": (cross_entropy_per_sample, correct_ce),
                     "BCE": (bce_per_sample, correct_bce)}


def prepare_labels(criterion: str, labels):
    """CE: (B,) int64; BCE: (B, 1) f32."""
    if criterion == "CE":
        return labels.reshape(-1).long()
    return labels.reshape(-1, 1).float()
