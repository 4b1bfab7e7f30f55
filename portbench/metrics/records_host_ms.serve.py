"""``records_host_ms.serve``: see ``harness/readers.py`` ``records_host_ms``."""

from portbench.harness import readers


def read(win):
    return readers.records_host_ms(win, "serve")
