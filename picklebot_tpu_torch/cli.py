"""Training CLI of the port: ``python -m picklebot_tpu_torch.cli cfg.json``.

Counterpart of ``picklebot_tpu/cli.py``: one positional config, the
precision/device banner, ``--steps N`` to stop after N optimizer steps.
It trains on ``--device cuda`` (the default; an error if there is no
card) or ``--device cpu``. ``--profile`` (or ``"profile": true`` in the
config) runs the whole run under cProfile and dumps ``train_stats.prof``
into the working directory, as the reference does; ``--torch-profile-dir
DIR`` (the counterpart of ``--jax-profile-dir``) records a torch.profiler
trace of the run into DIR (``utils/profiling.py``).

Under torchrun (``RANK`` / ``WORLD_SIZE`` set) every process joins the
process group first (``parallel/mesh.init_distributed``: NCCL on
``cuda:LOCAL_RANK``, gloo with ``--device cpu``) and trains one replica:
``torchrun --standalone --nproc_per_node N -m picklebot_tpu_torch.cli
cfg.json``.
"""

from __future__ import annotations

import argparse
import cProfile
import pstats
from pstats import SortKey


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Train a model with the specified config")
    parser.add_argument("config", type=str, help="Path to config file")
    parser.add_argument("--profile", action="store_true",
                        help="cProfile the run -> train_stats.prof "
                             "(reference behavior)")
    parser.add_argument("--steps", type=int, default=None,
                        help="stop after N optimizer steps (smoke runs)")
    parser.add_argument("--torch-profile-dir", type=str, default=None,
                        help="record a torch.profiler trace of the whole "
                             "run into this dir (TensorBoard / Perfetto); "
                             "combine with --steps to bound it")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    args = parser.parse_args(argv)

    import torch

    from picklebot_tpu_torch.parallel.mesh import init_distributed
    from picklebot_tpu_torch.train.loop import train
    from picklebot_tpu_torch.utils.config import load_config

    config = load_config(args.config)
    device = init_distributed(device=args.device)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    dtype = "bfloat16" if config.use_autocast else "float32"
    print(f"Using {dtype} on {device.type} ({kind})")

    def run():
        if args.torch_profile_dir:
            from picklebot_tpu_torch.utils.profiling import trace
            with trace(args.torch_profile_dir):
                return train(config, max_steps=args.steps, device=device)
        return train(config, max_steps=args.steps, device=device)

    if args.profile or config.profile:
        profiler = cProfile.Profile()
        result = profiler.runcall(run)
        stats = pstats.Stats(profiler)
        stats.sort_stats(SortKey.TIME)
        stats.dump_stats("train_stats.prof")
        print("profile dumped to train_stats.prof")
    else:
        result = run()
    return result


if __name__ == "__main__":
    main()
