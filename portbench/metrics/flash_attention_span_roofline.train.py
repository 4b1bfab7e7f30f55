"""``flash_attention_span_roofline.train``: see ``harness/spans.py`` ``flash_attention_span_roofline``."""

from portbench.harness import spans


def read(win):
    return spans.flash_attention_span_roofline(win, "train")
