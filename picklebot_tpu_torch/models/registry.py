"""Model registry of the port: config -> model.

Counterpart of ``picklebot_tpu/models/registry.py``. MobileNetLarge3D and
MobileViT are ported so far; ROADMAP.md lists the other models' slices.
"""

from __future__ import annotations

from picklebot_tpu_torch.models.mobilenet3d import MobileNetLarge3D
from picklebot_tpu_torch.models.mobilevit import MobileViT

PORTED = ("MobileNetLarge3D", "MobileViT")


def _mobilevit(cfg):
    for knob in ("model_parallel", "sequence_parallel", "pipeline_parallel"):
        if getattr(cfg, knob) > 1:
            raise NotImplementedError(
                f"MobileViT with {knob}={getattr(cfg, knob)} comes with the "
                "parallel layouts slice of the port (ROADMAP.md, queue A, "
                "slice 7)")
    if cfg.moe_experts > 0:
        raise NotImplementedError(
            "MobileViT with moe_experts > 0 comes with the parallel layouts "
            "slice of the port (ROADMAP.md, queue A, slice 7)")
    if cfg.dims is None or cfg.channels is None:
        raise ValueError("a MobileViT config needs 'dims' and 'channels'")
    return MobileViT(dims=cfg.dims, channels=cfg.channels,
                     num_classes=cfg.num_classes,
                     attention_backend=cfg.attention_backend, seed=cfg.seed)


def initialize_model(cfg):
    """Build the config's model with weights made from ``cfg.seed``. The
    JAX package's fold options (early_fold, fold_span, space_to_depth)
    change its execution only and are ignored here."""
    if cfg.model_name not in PORTED:
        raise NotImplementedError(
            f"{cfg.model_name} is not ported to PyTorch yet (ported: "
            f"{', '.join(PORTED)}); ROADMAP.md lists its slice")
    if cfg.model_name == "MobileViT":
        return _mobilevit(cfg)
    return MobileNetLarge3D(num_classes=cfg.num_classes, seed=cfg.seed)
