"""Port: the bench entry ``python -m picklebot_tpu_torch.bench`` on the
CPU at tiny shapes (``--device cpu``): one parseable JSON line per run,
``--remat`` on a train step, ``--baked`` on the exported program (and
refused in training), the matrix artifact written row by row, and no
quiet fallback to the CPU."""

import json
import os
import subprocess
import sys

import pytest
import torch
import torch.nn.functional as F

from picklebot_tpu_torch import bench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ("MobileNetSmall3D", None, "infer", 1, 4, 32, False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel worker
    processes, and torch's OpenMP threads slow every worker once they
    outnumber the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _one_line(capsys):
    lines = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    assert len(lines) == 1, lines
    return json.loads(lines[0])


@pytest.mark.parametrize("argv,unit", [
    (["--model", "MobileNetSmall3D", "--mode", "infer", "--batch", "1",
      "--frames", "4", "--size", "32"], "clips/s"),
    (["--model", "MobileViTV2", "--mode", "train", "--batch", "2",
      "--size", "32"], "images/s"),
    (["--model", "MobileNetSmall3D", "--mode", "train", "--batch", "1",
      "--frames", "4", "--size", "32", "--remat", "1"], "clips/s"),
    (["--model", "MobileNetLarge3D", "--mode", "infer", "--batch", "2",
      "--frames", "4", "--size", "32", "--baked"], "clips/s"),
], ids=["small3d_infer", "mobilevitv2_train", "small3d_train_remat1",
        "large3d_infer_baked"])
def test_bench_prints_one_line(capsys, argv, unit):
    ret = bench.main(argv + ["--steps", "1", "--warmup", "1",
                             "--device", "cpu"])
    line = _one_line(capsys)
    assert line == ret
    assert line["value"] > 0 and line["unit"] == unit
    assert line["vs_baseline"] is None
    assert line["timing"] == "host" and line["device"] == "cpu"
    assert argv[1] in line["metric"] and "/sec/cpu (" in line["metric"]
    if unit == "images/s":
        assert "bs=2 32x32" in line["metric"]
    elif "--baked" in argv:
        assert "weights baked (exported program), bs=2 T=4 32x32" in \
            line["metric"]
    else:
        assert "bs=1 T=4 32x32" in line["metric"]


@pytest.mark.parametrize("flag,item", [(["--baked"], "A17")])
def test_unported_options_are_refused(flag, item):
    """Kept under its first name: ``--baked`` is ported (A17's export),
    and is refused where the JAX bench refuses it, in training."""
    with pytest.raises(ValueError, match=f"ROADMAP.*{item}.*inference-only"):
        bench.main(["--device", "cpu", "--mode", "train"] + flag)


def test_no_card_no_fallback():
    """``--device cuda`` (the default) fails without a card, in process
    and as a command."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the check is for one without")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--model", "MobileNetSmall3D", "--mode", "infer"])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "picklebot_tpu_torch.bench",
                          "--mode", "infer"], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=300)
    assert out.returncode != 0
    assert '"value"' not in out.stdout


def test_matrix_records_rows_and_appends(tmp_path, monkeypatch, capsys):
    out = str(tmp_path / "matrix.json")
    argv = ["--matrix", "--matrix-out", out, "--device", "cpu", "--steps",
            "1", "--warmup", "0"]
    monkeypatch.setattr(bench, "MATRIX_ROWS",
                        [TINY, TINY[:6] + (True,)])
    bench.main(argv)
    with open(out) as fh:
        art = json.load(fh)
    assert art["device"] == "cpu" and len(art["rows"]) == 2
    measured, baked = art["rows"]
    assert measured["value"] > 0 and "error" not in measured
    assert measured["flops_per_step"] > 0
    assert measured["ms_per_step"] == pytest.approx(1e3 / measured["value"])
    assert measured["timing"] == "host"
    # a CPU run gives no device rate
    assert "tflops" not in measured and "mfu_pct" not in measured
    # the baked row times the exported program of the same forward
    assert baked["value"] > 0 and "error" not in baked
    assert baked["flops_per_step"] == measured["flops_per_step"]
    assert not os.path.exists(out + ".tmp")
    # append: the two recorded rows are skipped, a new one is measured
    new = TINY[:2] + ("train",) + TINY[3:]
    monkeypatch.setattr(bench, "MATRIX_ROWS",
                        [TINY, TINY[:6] + (True,), new])
    capsys.readouterr()
    bench.main(argv + ["--matrix-append"])
    printed = [json.loads(l) for l in capsys.readouterr().out.splitlines()
               if l.startswith("{")]
    assert [r["mode"] for r in printed] == ["train"]
    assert printed[0]["value"] > 0 and "error" not in printed[0]
    # forward and backward: more than the forward alone
    assert printed[0]["flops_per_step"] > 2 * measured["flops_per_step"]
    with open(out) as fh:
        art = json.load(fh)
    assert len(art["rows"]) == 3 and "appended" in art


@pytest.mark.parametrize("groups", [1, 4, 16])
def test_conv_backward_flops_count_the_groups(groups):
    """A conv's input and weight gradients cost a forward each, grouped
    (depthwise) or dense: forward and backward count 3x the forward."""
    x = torch.rand(2, 16, 9, 7, requires_grad=True)
    w = torch.rand(32, 16 // groups, 3, 3, requires_grad=True)
    with bench.count_flops() as fwd:
        F.conv2d(x, w, padding=1, groups=groups)
    with bench.count_flops() as both:
        F.conv2d(x, w, padding=1, groups=groups).sum().backward()
    assert fwd.get_total_flops() == 2 * 32 * (16 // groups) * 9 * 2 * 9 * 7
    assert both.get_total_flops() == 3 * fwd.get_total_flops()
