"""``flash_attention_roofline.train``: see ``harness/readers.py`` ``flash_attention_roofline``."""

from portbench.harness import readers


def read(win):
    return readers.flash_attention_roofline(win, "train")
