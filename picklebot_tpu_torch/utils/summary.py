"""Model summaries: per-module parameter tables and forward FLOPs.

Counterpart of ``picklebot_tpu/utils/summary.py`` (the torchinfo analog
the reference lacks). The parameter table has one row per top-level
parameter group, named as the JAX package's checkpoints and the
``freeze_params`` patterns name them (``convert.jax_param_path``), so the
port's rows are the JAX table's; a parameter at the root gets a
``(root)`` row, and the total comes last.

FLOPs are those of the plain path (``kernels=False``), counted by the
bench's ``count_flops()`` (``torch.utils.flop_counter``: convolutions and
matrix products, attention's included) on the ``meta`` device, where no
data exists and nothing runs; a train-mode forward, whose dropout draws
from a generator, is counted on the CPU. The hand-written kernels are
``ctypes`` calls the counter cannot see, and they compute the same
function, so the plain path is the count. It holds every tap a
convolution multiplies, its zero padding's too, where XLA's counts only
the taps inside the input and adds the elementwise work: the port reads
2-16% above the JAX summary, most on small maps. XLA's "bytes
accessed" has no PyTorch counterpart: the summary says so. Like the JAX
summary it touches no accelerator.

Usage:
  python -m picklebot_tpu_torch.utils.summary <config.json> [--frames 32]
      [--size 224] [--batch 1] [--train]
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Tuple

import torch

NO_BYTES = ("bytes accessed: not counted (XLA's cost analysis has no "
            "PyTorch counterpart)")


def count_params(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def param_table(model: torch.nn.Module, model_name: str
                ) -> List[Tuple[str, int, float]]:
    """[(name, params, share)] per top-level JAX parameter group, in the
    order the parameters come, + ('total', N, 1.0)."""
    from picklebot_tpu_torch.convert import jax_param_path
    counts = {}
    for key, p in model.named_parameters():
        path = jax_param_path(model, key, model_name)
        name = path.split(".")[0] if "." in path else "(root)"
        counts[name] = counts.get(name, 0) + p.numel()
    total = count_params(model)
    rows = [(n, c) for n, c in counts.items() if n != "(root)"]
    if "(root)" in counts:
        rows.append(("(root)", counts["(root)"]))
    return [(n, c, c / max(total, 1)) for n, c in rows] + \
        [("total", total, 1.0)]


def cost_summary(model: torch.nn.Module, input_shape, policy=None,
                 train: bool = False) -> dict:
    """{'flops': N}: the forward's FLOPs on a uint8 batch of
    ``input_shape`` (clips (B, T, H, W, 3), images (B, H, W, 3)), the
    plain path, counted on the meta device (the CPU in train mode). The
    model is left as it was."""
    import copy

    from picklebot_tpu_torch.bench import count_flops
    from picklebot_tpu_torch.core.policy import DtypePolicy
    from picklebot_tpu_torch.ops.linear import dropout_rng
    from picklebot_tpu_torch.train.step import preprocess

    policy = policy or DtypePolicy.f32()
    device = torch.device("cpu" if train else "meta")
    work = copy.deepcopy(model).to(device).train(train)
    x = torch.zeros(tuple(input_shape), dtype=torch.uint8, device=device)
    counter = count_flops()
    with counter, torch.no_grad(), dropout_rng(
            torch.Generator().manual_seed(0) if train else None):
        # a stream model builds its carry when given none
        work(preprocess(x, policy.compute_dtype), kernels=False)
    return {"flops": counter.get_total_flops()}


def format_summary(model: torch.nn.Module, input_shape, model_name: str,
                   policy=None, train: bool = False) -> str:
    rows = param_table(model, model_name)
    lines = [f"{'module':<14} {'params':>12}  share"]
    for name, n, frac in rows:
        lines.append(f"{name:<14} {n:>12,}  {frac:6.1%}")
    flops = cost_summary(model, input_shape, policy=policy,
                         train=train)["flops"]
    per = flops / max(input_shape[0], 1)
    lines.append(f"forward flops  {flops / 1e9:,.2f} GFLOP "
                 f"({per / 1e9:,.2f}/sample, convolutions and matrix "
                 f"products of the plain path)")
    lines.append(NO_BYTES)
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser(description="Model summary")
    p.add_argument("config")
    p.add_argument("--frames", type=int, default=32)
    p.add_argument("--size", type=int, default=224)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--train", action="store_true",
                   help="summarize the train-mode forward")
    args = p.parse_args(argv)

    from picklebot_tpu_torch.bench import input_shape
    from picklebot_tpu_torch.models.registry import initialize_model
    from picklebot_tpu_torch.utils.config import (load_config,
                                                  replicated_equivalent)

    config = replicated_equivalent(load_config(args.config))
    model = initialize_model(config)
    shape = input_shape(config.model_name, args.batch, args.frames,
                        args.size)
    print(f"# {config.model_name} input {shape}")
    print(format_summary(model, shape, config.model_name, train=args.train))
    return 0


if __name__ == "__main__":
    sys.exit(main())
