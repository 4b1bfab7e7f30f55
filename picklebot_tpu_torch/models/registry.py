"""Model registry of the port: config -> model.

Counterpart of ``picklebot_tpu/models/registry.py``, all eight of its
names: the four models the reference's trainer registers
(MobileNetLarge3D, MobileNetSmall3D, MobileViT v1, MoViNetA2 offline), the
three that ``serve --stream`` serves (MoViNetA2Stream, MobileNetLarge2D,
MobileNetSmall2D) and the image classifier MobileViTV2.
"""

from __future__ import annotations

from picklebot_tpu_torch.models.mobilenet2d_lstm import (MobileNetLarge2D,
                                                         MobileNetSmall2D)
from picklebot_tpu_torch.models.mobilenet3d import (MobileNetLarge3D,
                                                    MobileNetSmall3D)
from picklebot_tpu_torch.models.mobilevit import MobileViT
from picklebot_tpu_torch.models.mobilevitv2 import MobileViTV2
from picklebot_tpu_torch.models.movinet import MoViNetA2, MoViNetA2Stream
from picklebot_tpu_torch.parallel import mesh

# the models built from num_classes and the seed alone
_PLAIN = {"MobileNetLarge3D": MobileNetLarge3D,
          "MobileNetSmall3D": MobileNetSmall3D, "MoViNetA2": MoViNetA2,
          "MoViNetA2Stream": MoViNetA2Stream,
          "MobileNetLarge2D": MobileNetLarge2D,
          "MobileNetSmall2D": MobileNetSmall2D, "MobileViTV2": MobileViTV2}
PORTED = ("MobileNetLarge3D", "MobileNetSmall3D", "MobileViT", "MoViNetA2",
          "MoViNetA2Stream", "MobileNetLarge2D", "MobileNetSmall2D",
          "MobileViTV2")


def _mobilevit(cfg):
    """MobileViT, with its FFNs sharded over the mesh's 'model' axis at
    ``model_parallel`` > 1, its transformer tokens over 'seq' at
    ``sequence_parallel`` > 1, its stacks pipelined over 'pipe' at
    ``pipeline_parallel`` > 1, routed expert banks at ``moe_experts`` > 0,
    sharded over 'expert' at ``expert_parallel`` > 1
    (``parallel/mesh.init_mesh`` lays the process group out first)."""
    if cfg.dims is None or cfg.channels is None:
        raise ValueError("a MobileViT config needs 'dims' and 'channels'")
    for axis, degree in (("model", cfg.model_parallel),
                         ("seq", cfg.sequence_parallel),
                         ("pipe", cfg.pipeline_parallel),
                         ("expert", cfg.expert_parallel)):
        if degree > 1 and mesh.axis_size(axis) != degree:
            raise ValueError(
                f"a MobileViT with a '{axis}' axis of {degree} needs the "
                f"process group laid out as that mesh first (parallel."
                f"mesh.init_mesh); the axis has {mesh.axis_size(axis)}")
    return MobileViT(dims=cfg.dims, channels=cfg.channels,
                     num_classes=cfg.num_classes,
                     attention_backend=cfg.attention_backend, seed=cfg.seed,
                     model_axis="model" if cfg.model_parallel > 1 else None,
                     sequence_axis=("seq" if cfg.sequence_parallel > 1
                                    else None),
                     pipeline_axis=("pipe" if cfg.pipeline_parallel > 1
                                    else None),
                     pipeline_microbatches=cfg.pipeline_microbatches,
                     moe_experts=cfg.moe_experts, moe_top_k=cfg.moe_top_k,
                     moe_capacity_factor=cfg.moe_capacity_factor,
                     expert_axis=("expert" if cfg.expert_parallel > 1
                                  else None),
                     moe_dispatch=cfg.moe_dispatch)


def initialize_model(cfg):
    """Build the config's model with weights made from ``cfg.seed``. The
    JAX package's fold options (early_fold, fold_span, space_to_depth)
    change its execution only and are ignored here."""
    if cfg.model_name not in PORTED:
        raise ValueError(f"unknown model {cfg.model_name!r} (valid: "
                         f"{', '.join(PORTED)})")
    if cfg.model_name == "MobileViT":
        return _mobilevit(cfg)
    return _PLAIN[cfg.model_name](num_classes=cfg.num_classes, seed=cfg.seed)
