"""The hand-written kernels' inference launches as ``torch.library`` custom
ops, so that ``torch.export`` keeps them as named nodes.

Each op of the ``picklebot`` namespace is registered beside its kernel
wrapper: ``fused_pool`` and ``fused_main`` in ``ops/fused_bottleneck.py``,
``flash_packed``, ``flash_heads`` and ``flash_qkvpacked`` in
``ops/flash_attention.py``, ``folded_conv_fwd`` in ``ops/folded_conv.py``.
Each has a CUDA implementation (the wrapper's launch: plan, kernel,
``LAUNCHES`` count), a CPU implementation (the plain PyTorch version) and
a fake one that states only the output's shape and dtype, following a
symbolic batch. None mutates its inputs; a split launch's workspace stays
inside the CUDA implementation.

Eager calls go to the same launch function directly (``use_ops`` is
false): the dispatcher adds host time to every call, and serving is
bound by the host already (``PERF.md``). Calls made while ``torch.export``
or ``torch.compile`` traces go through the op. Importing
``picklebot_tpu_torch.ops`` registers every op, which is all a program
loaded by ``torch.export.load`` needs of the port.
"""

from __future__ import annotations

import torch

NAMESPACE = "picklebot"


def use_ops() -> bool:
    """True where a kernel call goes through its registered custom op:
    while ``torch.export`` or ``torch.compile`` traces."""
    return torch.compiler.is_compiling()
