"""``fused_bottleneck_backward_ms_per_clip.train``: see ``harness/spans.py`` ``fused_bottleneck_backward_ms_per_clip``."""

from portbench.harness import spans


def read(win):
    return spans.fused_bottleneck_backward_ms_per_clip(win, "train")
