"""Config loader: the same flat JSON files as the JAX package.

The port's own copy of ``picklebot_tpu/utils/config.py``: the same keys,
defaults and checks, so a config that loads there loads here. The field
comments there explain each key; the port reads only those its ported
slices use, and ``models/registry.py`` refuses a model it has not ported.
"""

from __future__ import annotations

import dataclasses
import json
import warnings
from typing import Any, Dict, List, Optional, Tuple

MODEL_NAMES = ("MoViNetA2", "MobileNetLarge3D", "MobileNetSmall3D",
               "MobileViT", "MobileNetLarge2D", "MobileNetSmall2D",
               "MobileViTV2", "MoViNetA2Stream")

# per-model fold_span vocabulary of the JAX package (its FOLD_SPANS)
FOLD_SPANS = {
    "MobileNetLarge3D": ("block2", "block4", "boundary"),
    "MobileNetSmall3D": ("block3", "boundary"),
    "MoViNetA2": ("block2", "block4", "boundary", "stem"),
    "MobileViT": ("stem", "trunk"),
    "MobileNetLarge2D": ("block2", "boundary"),
    "MobileNetSmall2D": ("block3", "boundary"),
}


@dataclasses.dataclass
class Config:
    # --- reference schema ---
    model_name: str = "MobileNetLarge3D"
    learning_rate: float = 3e-4
    batch_size: int = 16
    max_iters: int = 1
    eval_interval: int = 1
    weight_decay: float = 5e-4
    std: Optional[List[float]] = None
    mean: Optional[List[float]] = None
    use_autocast: bool = True           # -> bf16 compute policy
    compile: bool = True
    criterion: str = "CE"
    checkpoint: Optional[str] = None
    train_annotations_file: str = ""
    val_annotations_file: str = ""
    video_paths: str = ""
    num_classes: int = 2
    effective_batch_size: int = 16
    dims: Optional[List[int]] = None
    channels: Optional[List[int]] = None
    varying_input_size: bool = False
    # --- extensions of the JAX package ---
    optimizer: str = "adamw8bit"
    data_backend: str = "opencv"
    num_workers: int = 4
    skip_bad_clips: bool = False
    t_bucket: int = 8
    max_frames: int = 256
    apply_mean_std: bool = False
    data_parallel: Optional[int] = None
    dcn_data_parallel: int = 1
    model_parallel: int = 1
    sequence_parallel: int = 1
    pipeline_parallel: int = 1
    pipeline_microbatches: Optional[int] = None
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    moe_dispatch: str = "replicated"
    expert_parallel: int = 1
    zero_sharding: int = 0
    label_smoothing: float = 0.0
    augment_flip: bool = False
    augment_crop: int = 0
    augment_brightness: float = 0.0
    input_size: Optional[int] = None
    sample_fps: float = 0.0
    temporal_jitter: bool = False
    warmup_epochs: int = 0
    ema_decay: float = 0.0
    save_best: bool = False
    early_stop_patience: int = 0
    early_stop_min_delta: float = 0.0
    warm_start: bool = False
    warm_start_partial: bool = False
    freeze_params: Optional[list] = None
    max_grad_norm: Optional[float] = None
    remat: int = 0
    auto_resume: bool = False
    checkpoint_every_steps: int = 0
    keep_checkpoints: int = 0
    async_checkpoint: bool = False
    seed: int = 1234
    checkpoint_dir: str = "checkpoints"
    log_dir: str = "runs"
    synthetic_len: Optional[int] = None
    synthetic_shape: Tuple[int, int, int] = (16, 224, 224)
    synthetic_classes: Optional[int] = None
    profile: bool = False
    attention_backend: str = "auto"
    space_to_depth: bool = False
    early_fold: bool = False
    autotune: bool = False
    autotune_shape: Optional[Tuple[int, int, int]] = None
    fold_span: Optional[str] = None

    def resolved_synthetic_classes(self) -> int:
        if self.synthetic_classes is not None:
            return self.synthetic_classes
        return 2 if self.criterion == "BCE" else min(13, self.num_classes)

    def validate(self) -> "Config":
        def need(ok, msg):
            if not ok:
                raise ValueError(msg)

        need(self.model_name in MODEL_NAMES,
             f"Invalid model name: {self.model_name} "
             f"(valid: {sorted(MODEL_NAMES)})")
        need(self.criterion in ("CE", "BCE"),
             f"Invalid criterion: {self.criterion}")
        need(self.criterion != "BCE" or self.num_classes == 1,
             "criterion='BCE' requires num_classes=1 (binary head; "
             f"got num_classes={self.num_classes})")
        need(self.batch_size >= 1 and self.effective_batch_size >= 1,
             f"batch_size={self.batch_size} / effective_batch_size="
             f"{self.effective_batch_size}: both must be >= 1")
        need(self.effective_batch_size % self.batch_size == 0,
             "Batch size must divide effective batch size")
        for knob in ("model_parallel", "sequence_parallel",
                     "pipeline_parallel", "expert_parallel",
                     "dcn_data_parallel"):
            need(getattr(self, knob) >= 1,
                 f"{knob}={getattr(self, knob)}: parallel degrees must be "
                 ">= 1")
        need(self.data_parallel is None or self.data_parallel >= 1,
             f"data_parallel={self.data_parallel}: must be >= 1")
        need(self.optimizer in ("adamw", "adamw8bit"),
             f"Invalid optimizer: {self.optimizer}")
        need(not self.apply_mean_std or (self.mean is not None
                                         and self.std is not None),
             "apply_mean_std=true requires 'mean' and 'std' in the config")
        need(self.data_backend in ("opencv", "ffmpeg", "npy", "synthetic",
                                   "synthetic_learnable"),
             f"Invalid data_backend: {self.data_backend}")
        if self.synthetic_classes is None:
            self.synthetic_classes = self.resolved_synthetic_classes()
        synthetic = self.data_backend.startswith("synthetic")
        need(not (synthetic and self.criterion == "CE"
                  and self.synthetic_classes > self.num_classes),
             f"synthetic_classes={self.synthetic_classes} > "
             f"num_classes={self.num_classes}")
        need(not (synthetic and self.criterion == "BCE"
                  and self.synthetic_classes > 2),
             f"synthetic_classes={self.synthetic_classes} with "
             "criterion='BCE' (binary targets)")
        mobilevit_only = ("model_parallel", "sequence_parallel",
                          "pipeline_parallel")
        for knob in mobilevit_only:
            need(getattr(self, knob) <= 1 or self.model_name == "MobileViT",
                 f"{knob} is currently supported for MobileViT")
        if self.moe_experts:
            need(self.model_name == "MobileViT",
                 "moe_experts is currently supported for MobileViT")
            need(1 <= self.moe_top_k <= min(2, self.moe_experts),
                 f"moe_top_k={self.moe_top_k} invalid for "
                 f"moe_experts={self.moe_experts}")
            need(max(getattr(self, k) for k in mobilevit_only) <= 1,
                 "moe_experts composes with data and expert parallelism "
                 "only")
        need(self.moe_dispatch in ("replicated", "tokens"),
             f"Invalid moe_dispatch: {self.moe_dispatch}")
        if self.expert_parallel > 1:
            need(bool(self.moe_experts),
                 "expert_parallel requires moe_experts > 0")
            need(self.moe_experts % self.expert_parallel == 0,
                 f"expert_parallel={self.expert_parallel} must divide "
                 f"moe_experts={self.moe_experts}")
        need(int(self.zero_sharding) in (0, 1, 3),
             f"zero_sharding={self.zero_sharding!r} must be 0, 1 or 3")
        need(not self.zero_sharding or max(
            getattr(self, k) for k in mobilevit_only + ("expert_parallel",)
        ) <= 1, "zero_sharding composes with pure data parallelism only")
        need(self.max_grad_norm is None or self.max_grad_norm > 0,
             "max_grad_norm must be positive")
        need(self.early_stop_patience >= 0,
             "early_stop_patience must be >= 0")
        need(self.early_stop_min_delta >= 0,
             "early_stop_min_delta must be >= 0")
        if self.freeze_params is not None:
            need(isinstance(self.freeze_params, (list, tuple))
                 and len(self.freeze_params) > 0
                 and all(isinstance(p, str) and p
                         for p in self.freeze_params),
                 "freeze_params must be a non-empty list of non-empty "
                 "param-path patterns")
        need(0.0 <= self.ema_decay < 1.0, "ema_decay must be in [0, 1)")
        need(0.0 <= self.label_smoothing < 1.0,
             "label_smoothing must be in [0, 1)")
        if self.input_size is not None:
            need(self.input_size > 0, "input_size must be positive")
            if self.input_size % 32 != 0:
                warnings.warn(f"input_size={self.input_size} is not a "
                              "multiple of 32")
        need(self.sample_fps >= 0, "sample_fps must be >= 0")
        need(not (self.sample_fps > 0 and self.data_backend in (
            "npy", "synthetic", "synthetic_learnable")),
            f"sample_fps needs a video backend with fps metadata; "
            f"data_backend={self.data_backend!r} carries none")
        need(self.augment_crop >= 0, "augment_crop must be >= 0")
        need(0.0 <= self.augment_brightness < 1.0,
             "augment_brightness must be in [0, 1)")
        need(self.checkpoint_every_steps >= 0,
             "checkpoint_every_steps must be >= 0")
        need(not self.warm_start or bool(self.checkpoint),
             "warm_start requires `checkpoint`")
        need(not self.warm_start_partial or self.warm_start,
             "warm_start_partial requires warm_start")
        need(self.keep_checkpoints >= 0, "keep_checkpoints must be >= 0")
        need(self.dcn_data_parallel <= 1 or self.data_parallel is None
             or self.data_parallel % self.dcn_data_parallel == 0,
             f"dcn_data_parallel={self.dcn_data_parallel} must divide "
             f"data_parallel={self.data_parallel}")
        need(self.warmup_epochs == 0
             or 0 < self.warmup_epochs < max(self.max_iters, 1),
             f"warmup_epochs={self.warmup_epochs} must be in "
             f"[0, max_iters={self.max_iters})")
        need(int(self.remat) >= 0, "remat must be >= 0")
        if self.pipeline_microbatches is not None:
            need(self.pipeline_microbatches >= 1,
                 "pipeline_microbatches must be >= 1")
            need(self.batch_size % self.pipeline_microbatches == 0,
                 f"pipeline_microbatches={self.pipeline_microbatches} "
                 f"must divide batch_size={self.batch_size}")
        if self.fold_span is not None:
            valid = FOLD_SPANS.get(self.model_name)
            need(valid is None or self.fold_span in valid,
                 f"fold_span={self.fold_span!r} is not valid for "
                 f"{self.model_name} (valid: {valid})")
        return self

    @property
    def grad_accum_steps(self) -> int:
        return self.effective_batch_size // self.batch_size

    def run_name(self) -> str:
        """The reference's run name: model and the torch repr of the
        criterion, e.g. ``MobileViT_CrossEntropyLoss()``."""
        crit = {"CE": "CrossEntropyLoss()",
                "BCE": "BCEWithLogitsLoss()"}[self.criterion]
        return f"{self.model_name}_{crit}"


def replicated_equivalent(config: Config) -> Config:
    """The same model with every sharded-execution axis (TP/SP/PP/EP)
    stripped: they change the execution layout, not the weights."""
    if (config.model_parallel > 1 or config.sequence_parallel > 1
            or config.pipeline_parallel > 1 or config.expert_parallel > 1):
        return dataclasses.replace(config, model_parallel=1,
                                   sequence_parallel=1, pipeline_parallel=1,
                                   expert_parallel=1)
    return config


def load_config(path: str) -> Config:
    """JSON file -> validated Config."""
    with open(path) as fh:
        raw: Dict[str, Any] = json.load(fh)
    known = {f.name for f in dataclasses.fields(Config)}
    unknown = sorted(k for k in raw if k not in known)
    if unknown:
        warnings.warn(f"unknown config keys ignored: {unknown}")
    kwargs = {k: v for k, v in raw.items() if k in known}
    if kwargs.get("synthetic_shape") is not None:
        kwargs["synthetic_shape"] = tuple(kwargs["synthetic_shape"])
    elif "synthetic_shape" in kwargs:
        del kwargs["synthetic_shape"]
    if kwargs.get("autotune_shape") is not None:
        kwargs["autotune_shape"] = tuple(kwargs["autotune_shape"])
    return Config(**kwargs).validate()
