"""Mixed-precision policy: f32 parameters, compute in bf16 or f32.

Counterpart of ``DtypePolicy`` in ``picklebot_tpu/core/module.py``. There is
no autocast: preprocess casts the input to ``compute_dtype`` and every op
casts its f32 parameters to its input's dtype explicitly. BatchNorm folds
its statistics in f32, and pooling reduces in f32.

An f32 policy means full f32 arithmetic: ``precision()`` turns TF32 off for
both cuDNN convolutions and matmuls while it is active (cuDNN convs use
TF32 by default on the card), and restores the previous flags after.
"""

from __future__ import annotations

import contextlib

import torch


class DtypePolicy:
    def __init__(self, param_dtype=torch.float32,
                 compute_dtype=torch.float32):
        self.param_dtype = param_dtype
        self.compute_dtype = compute_dtype

    @staticmethod
    def bf16() -> "DtypePolicy":
        return DtypePolicy(torch.float32, torch.bfloat16)

    @staticmethod
    def f32() -> "DtypePolicy":
        return DtypePolicy(torch.float32, torch.float32)

    @contextlib.contextmanager
    def precision(self):
        """TF32 off for f32 compute; the global flags are restored after."""
        if self.compute_dtype != torch.float32:
            yield
            return
        matmul = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            with torch.backends.cudnn.flags(
                    enabled=torch.backends.cudnn.enabled,
                    benchmark=torch.backends.cudnn.benchmark,
                    deterministic=torch.backends.cudnn.deterministic,
                    allow_tf32=False):
                yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul
