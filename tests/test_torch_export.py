"""Port: the exported predictor (``export.py``), ``serve --exported`` and
the kernels' custom ops (``ops/library.py``), on the CPU.

Mirrors ``tests/test_aot_export.py``: one artifact serves every batch
size, a pinned one only its own, MoViNetA2Stream exports its whole-clip
pass, every registry model exports and reloads, and the export CLI's
program serves the checkpoint server's lines. On the CPU a traced kernel
call goes through its custom op, whose CPU implementation is the plain
version, so the graph holds the ``picklebot::*`` nodes of the program the
card would run. ``serve --exported``'s host resize is held bit for bit to
the JAX server's.

Bounds: the program against the eager model in f32, 1e-6 of max|logit|
(the eager CPU path runs the modules' plain chain, the program the
kernels' plain versions: the same f32 arithmetic, summed in other
orders); served lines: pred and label equal, confidence within 1e-4 (the
rounding unit of the 4 decimals).
"""

import collections
import json

import numpy as np
import pytest
import torch

from picklebot_tpu import export as jax_export
from picklebot_tpu import serve as jax_serve
from picklebot_tpu_torch import export as ex
from picklebot_tpu_torch import serve
from picklebot_tpu_torch.core.policy import DtypePolicy
from picklebot_tpu_torch.models.mobilevit import MOBILEVIT_CONFIGS
from picklebot_tpu_torch.models.registry import PORTED, initialize_model
from picklebot_tpu_torch.ops import flash_attention as fa
from picklebot_tpu_torch.ops import folded_conv as fc
from picklebot_tpu_torch.ops import fused_bottleneck as fb
from picklebot_tpu_torch.ops import library
from picklebot_tpu_torch.utils.config import Config
from test_torch_http import _get, _post, http_serve

SMALL = "MobileNetSmall3D"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel worker
    processes, and torch's OpenMP threads slow every worker once they
    outnumber the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model(name, **kw):
    extra = dict(MOBILEVIT_CONFIGS["xxs"]) if name == "MobileViT" else {}
    extra.update(kw)
    return initialize_model(Config(model_name=name, num_classes=13,
                                   **extra).validate()).eval()


def _eager(model, name, x):
    with torch.no_grad():
        return ex.build_predict_fn(model, DtypePolicy.f32(),
                                   model_name=name)(torch.from_numpy(x))


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def _save_load(tmp_path, program, **meta):
    path = tmp_path / "m.pt2"
    ex.save_artifact(path, program, {"device": "cpu",
                                     "compute_dtype": "float32", **meta})
    return ex.load_artifact(path, "cpu")


def test_roundtrip_symbolic_batch(tmp_path, rng):
    """One artifact serves batches 1, 3 and 5 with the eager model's
    logits; its metadata comes back."""
    model = _model(SMALL)
    program = ex.export_predictor(model, DtypePolicy.f32(), frames=6,
                                  size=64, model_name=SMALL, device="cpu")
    fn, meta = _save_load(tmp_path, program, num_classes=13)
    assert meta["num_classes"] == 13
    for b in (1, 3, 5):
        x = rng.randint(0, 255, (b, 6, 64, 64, 3)).astype(np.uint8)
        got = fn(x)
        assert got.shape == (b, 13) and got.dtype == np.float32
        _close(got, _eager(model, SMALL, x))


def test_pinned_batch_rejects_other_sizes(tmp_path, rng):
    model = _model(SMALL)
    program = ex.export_predictor(model, DtypePolicy.f32(), frames=6,
                                  size=64, model_name=SMALL, batch=2,
                                  device="cpu")
    fn, _ = _save_load(tmp_path, program, batch=2)
    ok = rng.randint(0, 255, (2, 6, 64, 64, 3)).astype(np.uint8)
    assert fn(ok).shape == (2, 13)
    with pytest.raises(Exception):
        fn(rng.randint(0, 255, (3, 6, 64, 64, 3)).astype(np.uint8))


def test_streaming_model_exports_whole_clip(tmp_path, rng):
    """MoViNetA2Stream's whole-clip pass from a zero carry built inside
    the program, the batch symbolic through the carry's zeros."""
    name = "MoViNetA2Stream"
    model = _model(name)
    program = ex.export_predictor(model, DtypePolicy.f32(), frames=4,
                                  size=32, model_name=name, device="cpu")
    fn, _ = _save_load(tmp_path, program)
    for b in (2, 3):
        x = rng.randint(0, 255, (b, 4, 32, 32, 3)).astype(np.uint8)
        got = fn(x)
        assert got.shape == (b, 13)
        with torch.no_grad():
            want = model(torch.from_numpy(x).float() / 255.0,
                         model.init_stream(b, 32, 32))[0]
        _close(got, want.numpy())


# the models whose forward reaches a kernel, and its ops' nodes; the
# others export without one
NODES = {
    "MobileNetLarge3D": {"fused_pool": 8, "fused_main": 15},
    "MobileNetSmall3D": {"fused_pool": 9, "fused_main": 11},
    "MobileViT": {"fused_main": 7, "flash_packed": 2, "folded_conv_fwd": 6},
}
SHAPES = {"MobileViT": (2, 4, 64, 64, 3), "MobileViTV2": (2, 64, 64, 3),
          "MobileNetLarge2D": (2, 2, 224, 224, 3),
          "MobileNetSmall2D": (2, 2, 224, 224, 3)}


def _graph_ops(program):
    return dict(collections.Counter(
        str(n.target).split(".")[1] for n in program.graph.nodes
        if n.op == "call_function"
        and str(n.target).startswith(f"{library.NAMESPACE}.")))


@pytest.mark.parametrize("name", PORTED)
def test_export_model_families(tmp_path, rng, name):
    """Every registry model exports, reloads and gives the eager logits
    at two batch sizes; the graph holds its kernels' op nodes."""
    model = _model(name)
    shape = SHAPES.get(name, (2, 4, 32, 32, 3))
    program = ex.export_predictor(model, DtypePolicy.f32(),
                                  frames=shape[1], size=shape[-2],
                                  model_name=name, device="cpu")
    assert _graph_ops(program) == NODES.get(name, {})
    fn, _ = _save_load(tmp_path, program)
    for b in (shape[0], 1):
        x = rng.randint(0, 255, (b,) + shape[1:]).astype(np.uint8)
        got = fn(x)
        assert got.shape == (b, 13)
        _close(got, _eager(model, name, x))


@pytest.mark.parametrize("backend,nodes", [
    ("pallas", {"flash_heads": 9}), ("pallas_packed", {"flash_qkvpacked": 9})
], ids=["pallas", "pallas_packed"])
def test_export_keeps_the_per_head_flash_ops(tmp_path, rng, backend, nodes):
    """MobileViT-xxs with every attention layer on the per-head kernel:
    the graph holds its op in place of the head-packed one."""
    model = _model("MobileViT", attention_backend=backend)
    program = ex.export_predictor(model, DtypePolicy.f32(), frames=4,
                                  size=64, model_name="MobileViT",
                                  device="cpu")
    assert _graph_ops(program) == {"fused_main": 7, "folded_conv_fwd": 6,
                                   **nodes}
    fn, _ = _save_load(tmp_path, program)
    x = rng.randint(0, 255, (2, 4, 64, 64, 3)).astype(np.uint8)
    _close(fn(x), _eager(model, "MobileViT", x))


def test_artifact_is_bound_to_its_device(tmp_path):
    """An artifact exported for the card is refused on the CPU, before
    its program is read; one for the CPU is refused on the card."""
    model = _model(SMALL)
    program = ex.export_predictor(model, DtypePolicy.f32(), frames=4,
                                  size=32, model_name=SMALL, device="cpu")
    path = tmp_path / "m.pt2"
    ex.save_artifact(path, program, {"device": "cuda:0"})
    assert ex.read_metadata(path) == {"device": "cuda:0"}
    with pytest.raises(ValueError, match="exported for 'cuda:0'.*'cpu'"):
        ex.load_artifact(path, "cpu")
    ex.save_artifact(path, program, {"device": "cpu"})
    with pytest.raises(ValueError, match="exported for 'cpu'.*'cuda:0'"):
        ex.load_artifact(path, "cuda")


# --------------------------------------------------------------------------
# the custom ops
# --------------------------------------------------------------------------

def _op_cases(rng):
    """(op, args) at small shapes, for every op of the namespace."""
    f = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    x, w1, wd, w2 = f(2, 4, 10, 10, 8), f(8, 40), f(3, 3, 40), f(40, 16)
    scale = torch.rand(2, 40)
    q, k, v = f(3, 40, 32), f(3, 40, 32), f(3, 40, 32)
    h = f(3, 2, 40, 16)
    qkv = f(2, 40, 3, 2, 16)
    xc, wc = f(2, 3, 6, 6, 32), f(3, 3, 3, 32, 32) * 0.1
    return [("fused_pool", (x, w1, wd, 3, 2)),
            ("fused_main", (x, w1, wd, w2, scale, 3, 2)),
            ("flash_packed", (q, k, v, 2, 0.25)),
            ("flash_heads", (h, h * 0.5, h + 1.0, 0.25)),
            ("flash_qkvpacked", (qkv, 0.25)),
            ("folded_conv_fwd", (xc, wc, [1, 1, 1]))]


def test_custom_ops_pass_opcheck(rng):
    """Schema, fake (shape and dtype, a symbolic batch included) and
    dispatch of every op on CPU tensors."""
    for name, args in _op_cases(rng):
        torch.library.opcheck(getattr(torch.ops.picklebot, name), args)


def test_eager_and_op_routes_give_the_same_values(rng, monkeypatch):
    """Each wrapper on CPU tensors, eager (the plain version, directly)
    and with every call routed through its op (the op's CPU
    implementation): the same values, and no launch counted."""
    f = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    x, w1, wd, w2 = f(2, 4, 10, 10, 8), f(8, 40), f(3, 3, 40), f(40, 16)
    se = (f(40, 10), f(10), f(10, 40), f(40))
    q, k, v = f(3, 40, 32), f(3, 40, 32), f(3, 40, 32)
    qkv = f(2, 40, 3, 2, 16)
    xc, wc = f(2, 3, 6, 6, 32), f(3, 3, 3, 32, 32) * 0.1
    calls = {
        "pool": lambda: fb.fused_pool(x, w1, wd, 3, 2),
        "main": lambda: fb.fused_main(x, w1, wd, w2, torch.ones(2, 40), 3,
                                      1),
        "chain": lambda: fb.fused_bottleneck(x, w1, wd, w2, *se, 3, 2,
                                             True),
        "packed": lambda: fa.flash_attention_packed(q, k, v, 2),
        "heads": lambda: fa.flash_attention(q, k, v),
        "qkvpacked": lambda: fa.flash_attention_qkvpacked(qkv),
        "conv": lambda: fc.folded_conv_s1(xc, wc, ((1, 1),) * 3),
    }
    with torch.no_grad():
        eager = {n: c() for n, c in calls.items()}
        monkeypatch.setattr(library, "use_ops", lambda: True)
        for n, c in calls.items():
            with torch.profiler.profile() as prof:
                routed = c()
            assert any(e.name.startswith(f"{library.NAMESPACE}::")
                       for e in prof.events()), n
            np.testing.assert_allclose(routed.numpy(), eager[n].numpy(),
                                       rtol=0, atol=1e-5, err_msg=n)
    assert fb.LAUNCHES == {"pool": 0, "main": 0, "dw_stencil": 0,
                           "dw_dgrad": 0, "dw_wgrad": 0}
    assert fa.LAUNCHES["packed"] == fa.LAUNCHES["heads"] == 0
    assert fc.LAUNCHES["fwd"] == 0


# --------------------------------------------------------------------------
# the export CLI and serve --exported
# --------------------------------------------------------------------------

def _write_mp4(path, size, frames, seed):
    cv2 = pytest.importorskip("cv2")
    w, h = size
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30,
                         (w, h))
    r = np.random.RandomState(seed)
    for _ in range(frames):
        vw.write(r.randint(0, 255, (h, w, 3)).astype(np.uint8))
    vw.release()
    return str(path)


def _lines(capsys):
    return [json.loads(l) for l in capsys.readouterr().out.splitlines()
            if l.startswith("{")]


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """A config, a seeded ``.pth`` of MobileNetSmall3D and the export
    CLI's artifact of it (symbolic batch, 6 frames at 48x48, CPU)."""
    tmp = tmp_path_factory.mktemp("exported")
    cfg = tmp / "cfg.json"
    cfg.write_text(json.dumps({
        "model_name": SMALL, "num_classes": 13, "criterion": "CE",
        "use_autocast": False, "t_bucket": 6, "max_frames": 6,
        "sample_fps": 0.0}))
    pth = str(tmp / "w.pth")
    torch.save(initialize_model(Config(model_name=SMALL, num_classes=13,
                                       seed=3)).state_dict(), pth)
    out = str(tmp / "m.pt2")
    assert ex.main([str(cfg), "--checkpoint", pth, "--out", out,
                    "--frames", "6", "--size", "48", "--device",
                    "cpu"]) == 0
    return str(cfg), pth, out, tmp


def test_export_cli_writes_the_metadata(exported):
    _, _, out, _ = exported
    meta = ex.read_metadata(out)
    assert meta == {
        "model_name": SMALL, "num_classes": 13, "criterion": "CE",
        "frames": 6, "size": 48, "batch": -1, "sample_fps": 0.0,
        "compute_dtype": "float32", "device": "cpu",
        "torch_version": torch.__version__,
        "input": "uint8 (B, frames, size, size, 3) RGB",
        "output": "float32 logits (B, num_classes)"}
    assert set(meta) >= {"model_name", "num_classes", "criterion", "frames",
                         "size", "batch", "sample_fps", "compute_dtype",
                         "input", "output"}


def test_serve_exported_lines_equal_checkpoint_serve(exported, capsys):
    """Clips at the program's shape (no host resize, T = frames) and a
    longer one that the server trims: ``serve --exported`` prints the
    checkpoint server's lines."""
    cfg, pth, out, tmp = exported
    clips = [_write_mp4(tmp / f"c{i}.mp4", (48, 48), 6, seed=i)
             for i in range(3)]
    assert serve.main(["--exported", out, *clips, "--batch", "2",
                       "--device", "cpu"]) == 0
    got = _lines(capsys)
    assert serve.main([cfg, "--checkpoint", pth, *clips, "--batch", "2",
                       "--device", "cpu"]) == 0
    want = _lines(capsys)
    assert [l["clip"] for l in got] == [l["clip"] for l in want] == clips
    for g, w in zip(got, want):
        assert (g["pred"], g["label"]) == (w["pred"], w["label"])
        assert abs(g["confidence"] - w["confidence"]) <= 1e-4


def test_serve_exported_pinned_batch_chunks(exported, capsys):
    """A pinned artifact (batch 2) serves 3 clips in chunks of 2, the
    tail padded, with the symbolic artifact's lines."""
    cfg, pth, out, tmp = exported
    pinned = str(tmp / "pinned.pt2")
    assert ex.main([cfg, "--checkpoint", pth, "--out", pinned, "--frames",
                    "6", "--size", "48", "--batch", "2", "--device",
                    "cpu"]) == 0
    capsys.readouterr()
    clips = [_write_mp4(tmp / f"p{i}.mp4", (48, 48), 6, seed=10 + i)
             for i in range(3)]
    assert serve.main(["--exported", pinned, *clips, "--device",
                       "cpu"]) == 0
    got = _lines(capsys)
    assert serve.main(["--exported", out, *clips, "--device", "cpu"]) == 0
    want = _lines(capsys)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert (g["clip"], g["pred"], g["label"]) == \
            (w["clip"], w["pred"], w["label"])
        assert abs(g["confidence"] - w["confidence"]) <= 1e-4


@pytest.mark.parametrize("native", [(96, 64), (32, 40), (48, 48)],
                         ids=["down", "up", "same"])
@pytest.mark.parametrize("frames", [4, 9], ids=["pad", "trim"])
def test_prep_matches_the_jax_servers(tmp_path, monkeypatch, capsys,
                                      native, frames):
    """``exported_prep`` against the ``prep`` inside the JAX server's
    ``_serve_exported``, read from the batch that server hands its
    artifact: bit for bit."""
    clip = _write_mp4(tmp_path / "c.mp4", native, frames, seed=5)
    seen = []

    def fake_load(path):
        def predict(feats):
            seen.append(np.array(feats, copy=True))
            return np.zeros((feats.shape[0], 13), np.float32)
        return predict, {"model_name": SMALL, "frames": 6, "size": 48,
                         "num_classes": 13, "criterion": "CE"}

    monkeypatch.setattr(jax_export, "load_artifact", fake_load)
    assert jax_serve.main(["--exported", "m.pbz", clip]) == 0
    capsys.readouterr()
    from picklebot_tpu_torch.data.dataset import decode_opencv
    got = serve.exported_prep(decode_opencv(clip), 6, 48)
    assert got.dtype == np.uint8 and got.shape == (6, 48, 48, 3)
    np.testing.assert_array_equal(got, seen[0][0])


def test_serve_exported_http(exported, monkeypatch):
    """``serve --exported --http``: GET / the metadata, a clip's answer
    the checkpoint server's, a bad body 400, another path 404, and the
    counters."""
    cfg, pth, out, tmp = exported
    body = open(_write_mp4(tmp / "h.mp4", (48, 48), 6, seed=7), "rb").read()
    with http_serve(serve, [cfg, "--checkpoint", pth, "--http", "0",
                            "--device", "cpu"], monkeypatch) as port:
        want = _post(port, body)
    monkeypatch.undo()
    with http_serve(serve, ["--exported", out, "--http", "0",
                            "--device", "cpu"], monkeypatch) as port:
        info = _get(port, "/")
        got = _post(port, body)
        bad = _post(port, b"not a video")
        missing = _post(port, b"", path="/elsewhere")
        health = _get(port, "/healthz")
    assert info == {"mode": "exported", **ex.read_metadata(out)}
    assert got[0] == want[0] == 200
    assert (got[1]["pred"], got[1]["label"]) == (want[1]["pred"],
                                                 want[1]["label"])
    assert abs(got[1]["confidence"] - want[1]["confidence"]) <= 1e-4
    assert bad[0] == 400 and missing[0] == 404
    assert health == {"status": "ok", "requests": 2, "errors": 1}


@pytest.mark.parametrize("flags,message", [
    (["--csv", "x"], "--exported does not support --csv"),
    (["--stream"], "--exported does not support --stream"),
    (["--data-parallel", "2"], "--exported does not support --data-parallel"),
], ids=["csv", "stream", "data_parallel"])
def test_serve_exported_refusals(capsys, flags, message):
    assert serve.main(["--exported", "m.pt2", "x.mp4", "--device", "cpu"]
                      + flags) == 1
    assert message in capsys.readouterr().err


def test_serve_exported_refuses_an_image_model(tmp_path, capsys):
    name = "MobileViTV2"
    program = ex.export_predictor(_model(name), DtypePolicy.f32(),
                                  frames=None, size=32, model_name=name,
                                  device="cpu")
    path = tmp_path / "v2.pt2"
    ex.save_artifact(path, program, {"model_name": name, "device": "cpu"})
    assert serve.main(["--exported", str(path), "x.mp4", "--device",
                       "cpu"]) == 1
    assert "MobileViTV2 artifacts take single images" in \
        capsys.readouterr().err


def test_export_ema_rejects_pth(exported, tmp_path):
    cfg, _, _, _ = exported
    with pytest.raises(SystemExit, match="EMA"):
        ex.main([cfg, "--checkpoint", "donor.pth", "--ema", "--out",
                 str(tmp_path / "m.pt2"), "--device", "cpu"])


def test_no_card_no_fallback(exported, tmp_path):
    """``export`` and ``serve --exported`` default to the card and raise
    without one."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the check is for one without")
    cfg, pth, out, _ = exported
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ex.main([cfg, "--checkpoint", pth, "--out",
                 str(tmp_path / "m.pt2")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--exported", out, "x.mp4"])
