"""Activation rematerialization: ``remat = N`` (config ``remat``).

Counterpart of ``apply(..., remat=N)`` in ``picklebot_tpu/core/module.py``:
the first N levels of child-module calls below the model run under
``torch.utils.checkpoint`` (non-reentrant), so the backward recomputes
their activations from their inputs instead of keeping them; N = 1 wraps
each module the root's forward calls, N = 2 their children too. Gradients
are unchanged. ``apply_remat`` sets each submodule's ``forward`` as an
instance attribute, so no ``state_dict`` key moves.

The recompute must run the forward that ran before, once more:
  * BatchNorm's running statistics advance only in the first run: the
    recompute runs with ``recomputing()`` true, and ``BatchNorm.forward``
    leaves its buffers alone then;
  * dropout draws from the generator of ``ops.linear.dropout_rng``, which
    torch's ``preserve_rng_state`` does not cover and which is unset where
    the backward runs: each wrapped call keeps that generator's state and
    the recompute draws from a copy of it;
  * the recompute is never cut short (early stop off), so a wrapped
    call's kernels run exactly twice: in the forward and in the backward.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
from torch.utils import checkpoint as torch_checkpoint

from picklebot_tpu_torch.ops import linear

_DEPTH = contextvars.ContextVar("remat_depth", default=0)
_RECOMPUTING = contextvars.ContextVar("remat_recomputing", default=False)


def recomputing() -> bool:
    """True inside a checkpointed call's recompute."""
    return _RECOMPUTING.get()


@contextlib.contextmanager
def _set(var, value):
    token = var.set(value)
    try:
        yield
    finally:
        var.reset(token)


class _Checkpointed:
    """A submodule's ``forward``, run under checkpoint at the first
    ``levels`` levels of calls. It holds the module, not a bound method,
    so a deep copy of the model calls its own copy."""

    def __init__(self, module: torch.nn.Module, levels: int):
        self.module, self.levels = module, levels

    def __call__(self, *args, **kwargs):
        forward = type(self.module).forward.__get__(self.module)
        depth = _DEPTH.get() + 1
        if depth > self.levels or not torch.is_grad_enabled():
            with _set(_DEPTH, depth):
                return forward(*args, **kwargs)
        gen = linear._GENERATOR.get()
        gen_state = None if gen is None else gen.get_state()
        runs = []

        def run(*a, **k):
            with contextlib.ExitStack() as stack:
                stack.enter_context(_set(_DEPTH, depth))
                if runs:
                    stack.enter_context(_set(_RECOMPUTING, True))
                    if gen is not None:
                        replay = torch.Generator(device=gen.device)
                        replay.set_state(gen_state)
                        stack.enter_context(linear.dropout_rng(replay))
                runs.append(1)
                return forward(*a, **k)

        with torch_checkpoint.set_checkpoint_early_stop(False):
            return torch_checkpoint.checkpoint(
                run, *args, use_reentrant=False, preserve_rng_state=False,
                **kwargs)


def apply_remat(model: torch.nn.Module, levels: int) -> torch.nn.Module:
    """Checkpoint the first ``levels`` levels of module calls below
    ``model``; 0 takes every wrapper off again."""
    for m in model.modules():
        if m is model:
            continue
        m.__dict__.pop("forward", None)
        if levels > 0:
            m.forward = _Checkpointed(m, int(levels))
    return model
