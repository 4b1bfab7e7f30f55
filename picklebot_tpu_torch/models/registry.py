"""Model registry of the port: config -> model.

Counterpart of ``picklebot_tpu/models/registry.py``. Only MobileNetLarge3D
is ported so far; ROADMAP.md lists the other models' slices.
"""

from __future__ import annotations

from picklebot_tpu_torch.models.mobilenet3d import MobileNetLarge3D

PORTED = ("MobileNetLarge3D",)


def initialize_model(cfg):
    """Build the config's model with weights made from ``cfg.seed``. The
    JAX package's fold options (early_fold, fold_span, space_to_depth)
    change its execution only and are ignored here."""
    if cfg.model_name not in PORTED:
        raise NotImplementedError(
            f"{cfg.model_name} is not ported to PyTorch yet (ported: "
            f"{', '.join(PORTED)}); ROADMAP.md lists its slice")
    return MobileNetLarge3D(num_classes=cfg.num_classes, seed=cfg.seed)
