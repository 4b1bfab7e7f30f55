"""``update_ms_per_step.train``: see ``harness/spans.py`` ``phase_ms``."""

from portbench.harness import spans


def read(win):
    return spans.phase_ms(win, "train", spans.UPDATE, "step")
