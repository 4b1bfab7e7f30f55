"""``step_mfu_pct.train``: see ``harness/readers.py`` ``step_mfu_pct``."""

from portbench.harness import readers


def read(win):
    return readers.step_mfu_pct(win, "train")
