"""``folded_conv_roofline.train``: see ``harness/readers.py`` ``folded_conv_roofline``."""

from portbench.harness import readers


def read(win):
    return readers.folded_conv_roofline(win, "train")
