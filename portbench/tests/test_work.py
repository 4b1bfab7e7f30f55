"""The work counts against hand-worked values at one small geometry."""

import pytest
import torch
from torch import nn

from portbench.harness import work
from portbench.reference import models as R


def test_fused_bottleneck_work():
    # x (1, 2, 4, 4, 8), k 3, stride 1, E 16, Co 8: T' = 4, of which
    # frames 1 and 2 read an input frame; 4x4 outputs a frame
    nbytes, flops = work.fused_bottleneck_work((1, 2, 4, 4, 8), 3, 1, 16, 8,
                                               False)
    assert nbytes == 2 * (2 * 16 * 8 + 8 * 16 + 9 * 16 + 16 * 8
                          + 4 * 16 * 8)                      # 2336
    assert flops == 2 * 2 * 16 * 8 * 16 + 2 * 32 * 9 * 16 + 2 * 32 * 16 * 8
    with_se = work.fused_bottleneck_work((1, 2, 4, 4, 8), 3, 1, 16, 8, True)
    assert with_se == (nbytes + 2 * (2 * 16 * 4 + 16 + 4), flops + 32 * 16)


def test_flash_work():
    assert work.flash_work(2, 2, 4, 8) == (4 * 2 * 2 * 4 * 8 * 2,
                                           4 * 2 * 2 * 16 * 8)
    assert work.flash_work(2, 2, 4, 8, with_lse=True)[0] == 1024 + 64
    assert work.flash_backward_work(2, 2, 4, 8) == (1792 + 128,
                                                    10 * 2 * 2 * 16 * 8)


def test_conv_work():
    # (1, 2, 3, 3, 4) -> 8 channels, 3x3x3: taps inside 4 * 7 * 7 = 196
    assert work.conv_work((1, 2, 3, 3, 4), 8, (3, 3, 3)) == (
        2 * (2 * 9 * 12 + 27 * 32), 2 * 196 * 4 * 8)


def test_least_ms():
    assert work.least_ms(3.35e9, 0) == pytest.approx(1.0)
    assert work.least_ms(0, 989e9) == pytest.approx(1.0)
    assert work.least_ms(0, 67e9, elem=4) == pytest.approx(1.0)


class _Two(nn.Module):
    def __init__(self):
        super().__init__()
        self.a = R.Conv3d(3, 4, 1)
        self.b = R.Conv3d(4, 4, 3, padding=1, groups=4, bias=False)

    def forward(self, x, generator=None):
        return self.b(self.a(x)).mean(dim=(2, 3, 4))


def test_flops_per_clip_counts_grouped_backward():
    p = 4 * 6 * 6                       # positions of a (4, 6, 6) clip
    fwd = 2 * 4 * 3 * p + 2 * 4 * 27 * p
    assert work.flops_per_clip(_Two(), (4, 6, 6), 2, train=False) == fwd
    # backward: the first conv's weight gradient only (its input needs
    # none), the depthwise conv's input and weight gradients
    train = fwd + 2 * 4 * 3 * p + 2 * (2 * 4 * 27 * p)
    assert work.flops_per_clip(_Two(), (4, 6, 6), 2, train=True) == train


def test_geometry_of_the_models():
    vit = R.build("MobileViT", 13, [144, 192, 240],
                  [16, 32, 64, 64, 96, 96, 128, 128, 160, 160, 640])
    calls = work.geometry(vit, (32, 224, 224), 8)
    assert len(calls["fused_bottleneck"]) == 7
    assert [c[2] for c in calls["attention"]] == [784] * 2 + [147] * 4 + [
        32] * 3
    assert all(c[0] == 64 and c[1] == 8 and c[3] == 16
               for c in calls["attention"])
    assert len(calls["folded_conv"]) == 6
    large = work.geometry(R.build("MobileNetLarge3D", 13), (32, 224, 224), 8)
    assert len(large["fused_bottleneck"]) == 15
    assert not large["attention"] and not large["folded_conv"]
    assert large["fused_bottleneck"][0] == ((8, 16, 112, 112, 16), 3, 1, 16,
                                            16, False)
    assert torch.device("meta") == next(vit.parameters()).device
