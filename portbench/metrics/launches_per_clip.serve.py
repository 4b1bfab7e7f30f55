"""``launches_per_clip.serve``: see ``harness/readers.py`` ``launches_per_clip``."""

from portbench.harness import readers


def read(win):
    return readers.launches_per_clip(win, "serve")
