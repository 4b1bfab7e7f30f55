"""Training CLI of the port: ``python -m picklebot_tpu_torch.cli cfg.json``.

Counterpart of ``picklebot_tpu/cli.py``: one positional config, the
precision/device banner, ``--steps N`` to stop after N optimizer steps.
It trains on ``--device cuda`` (the default; an error if there is no
card) or ``--device cpu``. The JAX CLI's ``--profile`` and
``--jax-profile-dir`` are not ported (ROADMAP.md, queue A, item A17).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Train a model with the specified config")
    parser.add_argument("config", type=str, help="Path to config file")
    parser.add_argument("--steps", type=int, default=None,
                        help="stop after N optimizer steps (smoke runs)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    args = parser.parse_args(argv)

    import torch

    from picklebot_tpu_torch.train.loop import train
    from picklebot_tpu_torch.utils.config import load_config
    from picklebot_tpu_torch.utils.devices import resolve_device

    config = load_config(args.config)
    device = resolve_device(args.device)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    dtype = "bfloat16" if config.use_autocast else "float32"
    print(f"Using {dtype} on {device.type} ({kind})")
    return train(config, max_steps=args.steps, device=device)


if __name__ == "__main__":
    main()
