"""``folded_conv_span_roofline.train``: see ``harness/spans.py`` ``folded_conv_span_roofline``."""

from portbench.harness import spans


def read(win):
    return spans.folded_conv_span_roofline(win, "train")
