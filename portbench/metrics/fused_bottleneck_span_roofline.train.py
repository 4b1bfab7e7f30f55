"""``fused_bottleneck_span_roofline.train``: see ``harness/spans.py`` ``fused_bottleneck_span_roofline``."""

from portbench.harness import spans


def read(win):
    return spans.fused_bottleneck_span_roofline(win, "train")
