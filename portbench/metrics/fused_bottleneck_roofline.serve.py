"""``fused_bottleneck_roofline.serve``: see ``harness/readers.py`` ``fused_bottleneck_roofline``."""

from portbench.harness import readers


def read(win):
    return readers.fused_bottleneck_roofline(win, "serve")
