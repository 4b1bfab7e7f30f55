"""Squeeze-and-excite over channels-last activations.

Counterpart of ``picklebot_tpu/ops/se.py``: global mean pool (in f32) ->
1x1 conv E -> E/4 -> relu -> 1x1 conv E/4 -> E -> hardsigmoid -> channel
scale, the MLP in the compute dtype. The two convs keep the reference's
keys ``se.1`` and ``se.3`` and its weights: (O, I, 1, 1, 1) for the 3-D
models' Conv3d, (O, I, 1, 1) for the 2-D models' Conv2d (``rank`` 4).
Rank-agnostic: it pools every axis between batch and channel.
"""

from __future__ import annotations

from torch import nn

from picklebot_tpu_torch.ops.activations import hardsigmoid, relu
from picklebot_tpu_torch.ops.linear import Dense


class SEBlock(nn.Module):
    def __init__(self, channels: int, reduction: int = 4, rank: int = 5):
        super().__init__()
        self.channels = channels
        self.reduced = channels // reduction
        self.se = nn.ModuleDict({
            "1": Dense(channels, self.reduced, rank=rank),
            "3": Dense(self.reduced, channels, rank=rank)})

    def mlp_weights(self):
        """(w1 (E, E/4), b1, w2 (E/4, E), b2) in the JAX package's layout."""
        fc1, fc2 = self.se["1"], self.se["3"]
        return fc1.matrix(), fc1.bias, fc2.matrix(), fc2.bias

    def forward(self, x):
        mean = x.float().mean(dim=tuple(range(1, x.dim() - 1))).to(x.dtype)
        s = hardsigmoid(self.se["3"](relu(self.se["1"](mean))))
        return x * s.reshape((x.shape[0],) + (1,) * (x.dim() - 2)
                             + (x.shape[-1],))
