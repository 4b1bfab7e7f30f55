"""The card: presence, name, power limit, peak memory; the process's start
time, from which set-up is counted."""

from __future__ import annotations

import os
import subprocess
import time


def process_start() -> float:
    """Wall-clock time (s) at which this process started."""
    try:
        with open("/proc/self/stat") as fh:
            fields = fh.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/stat") as fh:
            btime = next(int(line.split()[1]) for line in fh
                         if line.startswith("btime"))
        return btime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def require_cards(count: int):
    """Raise SystemExit (code 2) unless ``count`` CUDA cards are here."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("portbench: no CUDA device (torch.cuda.is_available"
                         "() is false); the benchmark runs on the card only")
    have = torch.cuda.device_count()
    if have < count:
        raise SystemExit(f"portbench: the cell needs {count} cards, "
                         f"{have} present")


def power_limit_w(index: int = 0):
    """The card's power limit in W (nvidia-smi), or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def device_line(count: int) -> dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(count)),
            "power_limit_w": power_limit_w(0)}
