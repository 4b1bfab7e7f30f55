"""What the benchmark imports: never JAX nor the JAX package, compared
by whole top-level module names; the reference nothing of the program."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = ("jax", "jaxlib", "flax", "picklebot_tpu")


def loaded_after(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split("
         "'.')[0] for m in sys.modules}))"], cwd=ROOT, capture_output=True,
        text=True, timeout=300, env={"PYTHONPATH": str(ROOT),
                                     "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_run_and_reference_load_no_jax():
    top = loaded_after(
        "import portbench.run, portbench.harness.program\n"
        "import portbench.generators.serve_closed\n"
        "import portbench.generators.train_accum\n"
        "import portbench.reference.models, portbench.reference.steps\n"
        "from portbench.harness import program\n"
        "program.config({'model_name': 'MobileNetLarge3D'})\n"
        "import picklebot_tpu_torch.serve, picklebot_tpu_torch.train.step")
    assert not top & set(FORBIDDEN)
    assert "picklebot_tpu_torch" in top      # the port passes: its own name


def test_reference_imports_nothing_of_the_program():
    top = loaded_after("import portbench.reference.models\n"
                       "import portbench.reference.steps\n"
                       "import portbench.reference.optim")
    assert "picklebot_tpu_torch" not in top
    assert not top & set(FORBIDDEN)
    for f in (ROOT / "portbench" / "reference").glob("*.py"):
        assert "picklebot" not in f.read_text(), f.name


def test_run_refuses_the_cpu():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "large3d_serve_b8", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
