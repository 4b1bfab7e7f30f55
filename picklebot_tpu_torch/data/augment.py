"""Training-time augmentation of a float clip batch, per clip.

Counterpart of ``picklebot_tpu/data/augment.py``: a horizontal flip with
p = 0.5 (``augment_flip``), a random (H, W) window of the batch zero-padded
by P on each side (``augment_crop: P``) and a brightness scale drawn from
U[1 - b, 1 + b] (``augment_brightness: b``), applied in that order, in the
/255 domain before mean/std (``train/step.py``). Eval and serving never
augment.

The work is split in two: ``draw_augment`` makes the draws (flip mask,
crop offsets, scales) from a CPU ``torch.Generator`` seeded from (seed,
microbatch position, a salt), so they are apart from the dropout stream
and a mid-epoch resume replays them; ``apply_augment`` applies given
draws. The draws' bits differ from the JAX package's threefry ones, as
dropout's do; given the same draws the two functions agree.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# keeps the augmentation draws apart from the dropout stream, which is
# seeded from (seed, position) alone
_AUG_SALT = 0x41554731  # "AUG1"


class Augment(NamedTuple):
    flip: bool = False
    crop: int = 0
    brightness: float = 0.0

    def enabled(self) -> bool:
        return bool(self.flip or self.crop > 0 or self.brightness > 0)


class Draws(NamedTuple):
    """One microbatch's draws: ``flip`` (B,) bool, ``oy``/``ox`` (B,)
    crop offsets in [0, 2P], ``scale`` (B,) f32; an unused one is None."""
    flip: object
    oy: object
    ox: object
    scale: object


def aug_seed(seed: int, position: int) -> int:
    return ((seed * 1_000_003 + position) * 1_000_003 + _AUG_SALT) % 2 ** 63


def draw_augment(aug: Augment, batch: int, seed: int,
                 position: int) -> Draws:
    """The draws of microbatch ``position``. All three are always drawn,
    in a fixed order, so turning one on moves none of the others."""
    g = torch.Generator().manual_seed(aug_seed(seed, position))
    flip = torch.rand(batch, generator=g) < 0.5
    span = 2 * int(aug.crop) + 1
    oy = torch.randint(0, span, (batch,), generator=g)
    ox = torch.randint(0, span, (batch,), generator=g)
    u = torch.rand(batch, generator=g)
    scale = 1.0 + (2.0 * u - 1.0) * float(aug.brightness)
    return Draws(flip if aug.flip else None,
                 oy if aug.crop > 0 else None,
                 ox if aug.crop > 0 else None,
                 scale.float() if aug.brightness > 0 else None)


def apply_augment(x: torch.Tensor, draws: Draws,
                  crop: int = 0) -> torch.Tensor:
    """Augment a (B, ..., H, W, C) float batch with ``draws``: flip W,
    then the (H, W) window at (oy, ox) of the batch zero-padded by
    ``crop``, then the per-clip scale."""
    b = x.shape[0]
    bcast = (b,) + (1,) * (x.dim() - 1)
    if draws.flip is not None:
        m = draws.flip.to(x.device).reshape(bcast)
        x = torch.where(m, x.flip(-2), x)
    if draws.oy is not None and crop > 0:
        p = int(crop)
        h, w = x.shape[-3], x.shape[-2]
        pad = [0, 0, p, p, p, p]                  # C, W, H (last axes first)
        xp = torch.nn.functional.pad(x, pad)
        x = torch.stack([
            xp[i].narrow(-3, int(oy), h).narrow(-2, int(ox), w)
            for i, (oy, ox) in enumerate(zip(draws.oy.tolist(),
                                             draws.ox.tolist()))])
    if draws.scale is not None:
        x = x * draws.scale.to(x.device).reshape(bcast).to(x.dtype)
    return x
