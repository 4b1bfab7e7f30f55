#!/usr/bin/env python3
"""Device time of the PyTorch port's bf16 conv kernel (csrc/folded_conv.cu)
at MobileViT-s's 12 conv launches (conv1/conv4 of its three stages at bs 8,
forward and dx) under other launch plans than ``ops/folded_conv.py``
``_plan``: the other N tile on a tie, other split targets, no split, one
tile width everywhere. Every variant's output is held against the plain
version first; times are the kernels' own (torch.profiler, 20 calls).

    python3 scripts/probe_torch_conv_plans.py      # on an NVIDIA card

Prints one JSON line per launch geometry, then the sums per variant, the
library's (cuDNN) sums and the card's name and power limit. Imports nothing
of JAX.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from picklebot_tpu_torch.ops import folded_conv as fc  # noqa: E402


def device_ms(fn):
    ms = cs.device_ms(fn, 20)
    if ms is None:
        raise RuntimeError("no trace held device events")
    return ms


def variant(prefer_wide=True, target=2 * 132, tile=None):
    """A plan like ``_plan`` with another tie rule, split target (blocks
    the grid must reach before it stops splitting; 0: never split) or one
    fixed N tile."""
    def plan(m, co, taps):
        tile_n = tile or min((64, 96), key=lambda n: (
            -(-co // n) * n, -n if prefer_wide else n))
        blocks = -(-m // 128) * -(-co // tile_n)
        splits = 1 if blocks >= target else min(taps, -(-target // blocks))
        return fc.Plan(tile_n, splits, blocks * splits,
                       splits * m * co if splits > 1 else 0)
    return plan


def main():
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    port_plan = fc._plan
    variants = {"port": port_plan, "narrow_on_tie": variant(False),
                "target_132": variant(target=132),
                "target_396": variant(target=396),
                "target_528": variant(target=528),
                "no_split": variant(target=0), "all_64": variant(tile=64),
                "all_96": variant(tile=96)}
    rows = []
    try:
        for stage, ((b, t, h, w_), c) in enumerate(cs.VIT_CONV_STAGES, 1):
            for conv, ci in (("conv1", c), ("conv4", 2 * c)):
                shape = (b, t, h, w_, ci)
                x, w, g, pads, w_flip, w_lib = cs.conv_case(
                    shape, c, (3, 3, 3), torch.bfloat16, seed=1)
                want = fc.folded_conv_reference(x, w, pads)
                want_dx = fc.folded_conv_reference(g, w_flip, pads)
                xc, gc = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3)
                row = {"stage": stage, "conv": conv,
                       "library": [device_ms(lambda: F.conv3d(
                           xc, w_lib, padding=1)), device_ms(
                           lambda: torch.nn.grad.conv3d_input(
                               xc.shape, w_lib, gc, padding=1))]}
                m = b * t * h * w_
                for name, plan in variants.items():
                    fc._plan = plan
                    cs.check_bf16_flash(f"{name} fwd",
                                        fc._conv(x, w, pads, "fwd"), want)
                    cs.check_bf16_flash(f"{name} dx",
                                        fc._conv(g, w_flip, pads, "dx"),
                                        want_dx)
                    row[name] = {
                        "ms": [device_ms(lambda: fc._conv(
                            x, w, pads, "fwd")), device_ms(
                            lambda: fc._conv(g, w_flip, pads, "dx"))],
                        "plan": [plan(m, c, 27)[:2], plan(m, ci, 27)[:2]]}
                print(json.dumps(row), flush=True)
                rows.append(row)
    finally:
        fc._plan = port_plan
    for name in variants:
        print(json.dumps({"variant": name, "fwd_ms": sum(
            r[name]["ms"][0] for r in rows), "dx_ms": sum(
            r[name]["ms"][1] for r in rows)}))
    print(json.dumps({"variant": "library (cuDNN)", "fwd_ms": sum(
        r["library"][0] for r in rows), "dx_ms": sum(
        r["library"][1] for r in rows)}))
    print(cs.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
