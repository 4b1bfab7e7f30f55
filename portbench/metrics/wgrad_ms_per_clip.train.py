"""``wgrad_ms_per_clip.train``: see ``harness/readers.py`` ``wgrad_ms_per_clip``."""

from portbench.harness import readers


def read(win):
    return readers.wgrad_ms_per_clip(win, "train")
