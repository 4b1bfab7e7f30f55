"""Device resolution: CUDA by default, the CPU only when asked for.

Counterpart of ``picklebot_tpu/utils/devices.py``. A caller that asks for
``cuda`` on a machine without a card gets an error, never a quiet run on
the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(name: str = "cuda") -> torch.device:
    """``"cuda"``, ``"cuda:N"`` or ``"cpu"`` -> torch.device. Raises
    RuntimeError when CUDA is asked for and not available."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} requested but CUDA is not available; pass "
                "--device cpu (or device='cpu') to run on the CPU")
        index = device.index or 0
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"device {name!r} requested but only "
                               f"{torch.cuda.device_count()} card(s) exist")
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {name!r} (cuda or cpu)")
    return device
