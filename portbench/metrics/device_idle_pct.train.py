"""``device_idle_pct.train``: see ``harness/readers.py`` ``device_idle_pct``."""

from portbench.harness import readers


def read(win):
    return readers.device_idle_pct(win, "train")
