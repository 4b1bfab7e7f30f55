"""Inference step: uint8 clips -> logits.

Counterpart of ``preprocess`` and ``make_predict_fn`` in
``picklebot_tpu/train/step.py``. The train and eval steps come with the
training slice (ROADMAP.md, queue A, slice 2).
"""

from __future__ import annotations

import numpy as np
import torch

from picklebot_tpu_torch.core.policy import DtypePolicy


def preprocess(features: torch.Tensor, compute_dtype, mean=None, std=None,
               input_size=None) -> torch.Tensor:
    """uint8 (..., T, H, W, C) -> compute dtype: /255, then the optional
    per-channel mean/std."""
    if input_size:
        raise NotImplementedError(
            "config.input_size (the in-graph resize of ops/resize.py) is "
            "not ported yet; see ROADMAP.md")
    x = features.to(compute_dtype) / 255.0
    if mean is not None and std is not None:
        mean = torch.tensor(mean, dtype=compute_dtype, device=x.device)
        std = torch.tensor(std, dtype=compute_dtype, device=x.device)
        x = (x - mean) / std
    return x


def make_predict_fn(model, policy: DtypePolicy = None, mean=None, std=None,
                    input_size=None, device="cuda"):
    """Batched inference: a uint8 (B, T, H, W, 3) numpy batch -> f32 numpy
    (B, num_classes) logits, with the model run on ``device`` in eval
    mode (the model must already live there)."""
    policy = policy or DtypePolicy.bf16()
    device = torch.device(device)
    model.eval()

    def predict(features: np.ndarray) -> np.ndarray:
        with torch.inference_mode(), policy.precision():
            x = torch.from_numpy(np.ascontiguousarray(features)).to(device)
            x = preprocess(x, policy.compute_dtype, mean, std, input_size)
            return model(x).float().cpu().numpy()

    return predict
