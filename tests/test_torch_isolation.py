"""Port: the package and chip_smoke.py import neither jax nor anything of
the JAX package, and no module builds or launches a kernel on import."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
sys.path.insert(0, {root!r})
import picklebot_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    picklebot_tpu_torch.__path__, "picklebot_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "picklebot_tpu" or m.startswith("picklebot_tpu."))
from picklebot_tpu_torch.ops import flash_attention as fa
from picklebot_tpu_torch.ops import fused_bottleneck as fb
print(json.dumps({{"modules": names, "bad": bad,
                  "launches": fb.LAUNCHES, "flash_launches": fa.LAUNCHES}}))
"""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    import json
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE.format(root=ROOT)],
                         capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    # every layer of the slice was imported, the serve entry point included
    for mod in ("serve", "convert", "ops.fused_bottleneck", "ops.bottleneck",
                "models.mobilenet3d", "models.registry", "utils.config",
                "data.dataset", "train.step", "utils.devices",
                "core.policy", "ops.attention", "ops.flash_attention",
                "models.mobilevit"):
        assert f"picklebot_tpu_torch.{mod}" in res["modules"]
    assert res["launches"] == {"pool": 0, "main": 0}
    assert res["flash_launches"] == {"packed": 0, "heads": 0}


def test_chip_smoke_refuses_to_run_without_cuda(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the check is for one without")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, cwd=tmp_path,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_unported_model_points_to_roadmap():
    from picklebot_tpu_torch.models.registry import initialize_model
    from picklebot_tpu_torch.utils.config import Config
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        initialize_model(Config(model_name="MoViNetA2").validate())
