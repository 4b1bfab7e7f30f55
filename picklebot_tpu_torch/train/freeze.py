"""Parameter freezing for fine-tuning: ``freeze_params`` patterns.

Counterpart of ``picklebot_tpu/train/freeze.py``. The patterns are
written against the JAX package's parameter paths (``block1.conv.w``),
so the same config freezes the same leaves in both packages: each port
parameter is matched on its JAX path (``convert.jax_param_path``, the
key table inverted). A pattern freezes a parameter if it names it, names
an ancestor module (a prefix at a '.' boundary), or glob-matches its path
(``'block*'``, ``'*bn*'``). A pattern that matches nothing, and a set that
freezes everything, are refused.

The semantics are torch's ``requires_grad=False``, as the JAX step spells
them out: a frozen parameter gets no gradient, no update and no decoupled
weight decay, and stays out of the clip norm (the port's train step and
``AdamW`` keep only parameters that require grad, so freeze before the
optimizer is built); BatchNorm running statistics still advance.
"""

from __future__ import annotations

import fnmatch
from typing import Dict, Sequence, Tuple

import torch

from picklebot_tpu_torch.convert import jax_param_path


def _matches(path: str, pattern: str) -> bool:
    if path == pattern or path.startswith(pattern + "."):
        return True
    return any(c in pattern for c in "*?[") and fnmatch.fnmatchcase(
        path, pattern)


def freeze_mask(model: torch.nn.Module, model_name: str,
                patterns: Sequence[str]) -> Dict[str, bool]:
    """{port parameter name: frozen?} for ``patterns`` on the JAX paths."""
    patterns = list(patterns)
    paths = {name: jax_param_path(model, name, model_name)
             for name, _ in model.named_parameters()}
    used = [False] * len(patterns)
    mask = {}
    for name, path in paths.items():
        hits = [i for i, pat in enumerate(patterns) if _matches(path, pat)]
        for i in hits:
            used[i] = True
        mask[name] = bool(hits)
    unused = [p for p, u in zip(patterns, used) if not u]
    if unused:
        sample = ", ".join(sorted({p.split(".")[0]
                                   for p in paths.values()})[:12])
        raise ValueError(
            f"freeze_params patterns {unused!r} match no parameter "
            f"(module names include: {sample}, ...)")
    if all(mask.values()):
        raise ValueError("freeze_params froze every parameter: nothing "
                         "left to train")
    return mask


def freeze(model: torch.nn.Module, model_name: str,
           patterns: Sequence[str]) -> Dict[str, bool]:
    """Set ``requires_grad=False`` on the parameters ``patterns`` match;
    returns the mask."""
    mask = freeze_mask(model, model_name, patterns)
    for name, p in model.named_parameters():
        p.requires_grad_(not mask[name])
    return mask


def frozen_summary(model: torch.nn.Module,
                   mask: Dict[str, bool]) -> Tuple[int, int, int, int]:
    """(frozen tensors, tensors, frozen parameter count, parameter count)
    for the one-line training log."""
    sizes = {n: p.numel() for n, p in model.named_parameters()}
    return (sum(mask.values()), len(mask),
            sum(sizes[n] for n, f in mask.items() if f), sum(sizes.values()))
