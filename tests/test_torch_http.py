"""Port: ``serve --http`` (``RequestBatcher``, ``make_http_server``),
``serve --ema`` and the serve CLI's refusals, against the JAX server.

The batcher and the server's hostile-input handling mirror the JAX tests
of ``tests/test_serve.py`` on the port's classes. The servers themselves
run in this process on an ephemeral port, both packages from one
``.pth`` (written by the JAX package from its init, BatchNorm statistics
perturbed) and mp4s written with cv2, MobileNetSmall3D in f32 on the CPU:
every answer has the JAX server's pred and label, its confidence within
1e-3 (both round to 4 decimals; the batch a clip lands in moves its
logits in the last f32 bits).
"""

import contextlib
import http.client
import json
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from picklebot_tpu import serve as jax_serve
from picklebot_tpu.models.mobilenet3d import MobileNetSmall3D as JaxSmall3D
from picklebot_tpu.train.checkpoint import build_reverse_map, save_pth
from picklebot_tpu.train.key_maps import export_rank_for, key_map_for
from picklebot_tpu_torch import serve
from picklebot_tpu_torch.data.dataset import decode_opencv
from picklebot_tpu_torch.models.mobilenet3d import MobileNetSmall3D
from picklebot_tpu_torch.train import checkpoint as ckpt
from picklebot_tpu_torch.train import loop
from picklebot_tpu_torch.train.optim import AdamW
from picklebot_tpu_torch.utils.config import Config
from test_torch_mobilenet3d import _perturb_batchnorm

NAME = "MobileNetSmall3D"
CONF_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel worker
    processes, and torch's OpenMP threads slow every worker once they
    outnumber the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------------------
# RequestBatcher
# --------------------------------------------------------------------------

def test_request_batcher_coalesces_and_pads():
    """Concurrent submits within the window coalesce into one predictor
    call (two if the scheduler splits them); the batch dim buckets to
    powers of two as the JAX server's does."""
    calls = []

    def predict_clips(clips):
        calls.append(len(clips))
        return [{"pred": int(c[0]), "label": "x", "confidence": 1.0}
                for c in clips]

    b = serve.RequestBatcher(predict_clips, max_batch=8, window_ms=200.0)
    results = [None] * 5

    def worker(i):
        results[i] = b.submit(np.array([i]))
    ts = [threading.Thread(target=worker, args=(i,)) for i in range(5)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert [r["pred"] for r in results] == [0, 1, 2, 3, 4]
    assert len(calls) <= 2 and sum(calls) == 5
    for n in range(1, 12):
        assert serve.pad_batch_pow2(n, 8) == jax_serve.pad_batch_pow2(n, 8)


def test_request_batcher_propagates_errors():
    def predict_clips(clips):
        raise RuntimeError("boom")

    b = serve.RequestBatcher(predict_clips, max_batch=4, window_ms=1.0)
    with pytest.raises(RuntimeError, match="boom"):
        b.submit(np.zeros(1))
    # every waiter of the failed batch gets the error, and the worker
    # takes the next batch
    errors = []

    def worker():
        try:
            b.submit(np.zeros(1))
        except RuntimeError as e:
            errors.append(str(e))
    ts = [threading.Thread(target=worker) for _ in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert errors == ["boom"] * 3
    b2 = serve.RequestBatcher(lambda clips: [{"pred": 0}], max_batch=4,
                              window_ms=1.0)
    assert b2.submit(np.zeros(1)) == {"pred": 0}


def test_request_batcher_keys_separate_batches():
    """Entries with different keys never share a predictor call."""
    calls = []

    def predict_clips(clips):
        shapes = {c.shape for c in clips}
        assert len(shapes) == 1, shapes
        calls.append(len(clips))
        return [{"pred": int(c.shape[0])} for c in clips]

    b = serve.RequestBatcher(predict_clips, max_batch=8, window_ms=150.0)
    results = {}

    def worker(i, t):
        results[i] = b.submit(np.zeros((t, 4)), key=(t, 4))

    ts = [threading.Thread(target=worker, args=(i, 8 if i % 2 else 16))
          for i in range(6)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert all(results[i]["pred"] == (8 if i % 2 else 16)
               for i in range(6))
    assert len(calls) >= 2 and sum(calls) == 6


def test_batch_key_is_the_t_bucket_and_frame_size():
    config = Config(model_name=NAME, t_bucket=4, max_frames=16)
    clip = np.zeros((5, 32, 40, 3), np.uint8)
    assert serve.batch_key(clip, config) == (8, 32, 40)
    assert serve.batch_key(clip[:4], config) == (4, 32, 40)


# --------------------------------------------------------------------------
# make_http_server: hostile input
# --------------------------------------------------------------------------

def _run_server(classify, info=None, **kw):
    srv = serve.make_http_server(0, classify, info or {"mode": "test"}, **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, srv.server_address[1]


def _post(port, body, path="/predict", timeout=60):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, body=body)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def test_http_rejects_oversize_body():
    """413 before the body is read; the error counter moves."""
    calls = []
    srv, port = _run_server(lambda p: calls.append(p) or {"pred": 0},
                            max_body=1000)
    try:
        status, obj = _post(port, b"x" * 5000)
        assert status == 413 and "cap" in obj["error"]
        assert calls == []
        assert _post(port, b"x" * 100)[0] == 200
        h = _get(port, "/healthz")
        assert h["requests"] == 2 and h["errors"] == 1
    finally:
        srv.shutdown()


def test_http_missing_length_and_empty_body():
    srv, port = _run_server(lambda p: {"pred": 0})
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.putrequest("POST", "/predict")
        conn.putheader("Transfer-Encoding", "chunked")
        conn.endheaders()
        conn.send(b"0\r\n\r\n")
        resp = conn.getresponse()
        assert resp.status == 411
        json.loads(resp.read())
        conn.close()
        status, obj = _post(port, b"")
        assert status == 400 and "empty" in obj["error"]
        h = _get(port, "/healthz")
        assert h["requests"] == 2 and h["errors"] == 2
    finally:
        srv.shutdown()


def test_http_malformed_content_length():
    calls = []
    srv, port = _run_server(lambda p: calls.append(p) or {"pred": 0})
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.putrequest("POST", "/predict")
        conn.putheader("Content-Length", "abc")
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 400
        assert "Content-Length" in json.loads(resp.read())["error"]
        conn.close()
        assert calls == []
        h = _get(port, "/healthz")
        assert h["requests"] == 1 and h["errors"] == 1
    finally:
        srv.shutdown()


def test_http_client_disconnect_counts_once():
    """A client that hangs up before reading its answer: one request, no
    error."""
    srv, port = _run_server(lambda p: {"pred": 0})
    try:
        s = socket.create_connection(("127.0.0.1", port), timeout=30)
        body = b"x" * 64
        s.sendall(b"POST /predict HTTP/1.1\r\nHost: t\r\n"
                  b"Content-Length: %d\r\n\r\n" % len(body) + body)
        s.close()
        deadline = time.time() + 10
        while time.time() < deadline and not _get(port,
                                                  "/healthz")["requests"]:
            time.sleep(0.05)
        time.sleep(0.2)
        h = _get(port, "/healthz")
        assert h["requests"] == 1 and h["errors"] == 0
    finally:
        srv.shutdown()


def test_http_request_timeout_504():
    def classify(path):
        if os.path.getsize(path) > 10:
            time.sleep(3.0)       # a stalled decode
        return {"pred": 1}

    srv, port = _run_server(classify, request_timeout=0.3)
    try:
        status, obj = _post(port, b"x" * 100)
        assert status == 504 and "0.3" in obj["error"]
        status, obj = _post(port, b"ok")
        assert status == 200 and obj == {"pred": 1}
        h = _get(port, "/healthz")
        assert h["requests"] == 2 and h["errors"] == 1
    finally:
        srv.shutdown()


def test_http_spool_write_failure_503(monkeypatch):
    """A body that cannot be spooled (a full disk) is the server's fault:
    503, counted."""
    srv, port = _run_server(lambda p: {"pred": 0})

    class Full:
        def __init__(self, fd, mode):
            os.close(fd)

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def write(self, data):
            raise OSError(28, "No space left on device")

    try:
        monkeypatch.setattr(os, "fdopen", Full)
        status, obj = _post(port, b"x" * 10)
        monkeypatch.undo()
        assert status == 503 and "spool" in obj["error"]
        h = _get(port, "/healthz")
        assert h["requests"] == 1 and h["errors"] == 1
    finally:
        srv.shutdown()


def _write_mp4(path, size, frames, seed):
    cv2 = pytest.importorskip("cv2")
    w, h = size
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30,
                         (w, h))
    r = np.random.RandomState(seed)
    for _ in range(frames):
        vw.write(r.randint(0, 255, (h, w, 3)).astype(np.uint8))
    vw.release()
    return path.read_bytes()


def test_http_truncated_video_is_400(tmp_path):
    """An mp4 cut mid-file decodes to nothing: 400, not 500."""
    body = _write_mp4(tmp_path / "c.mp4", (32, 32), 6, seed=0)

    def classify(path):
        decode_opencv(path)
        return {"pred": 0}

    srv, port = _run_server(classify)
    try:
        status, obj = _post(port, body[:len(body) // 2])
        assert status == 400 and "error" in obj
        h = _get(port, "/healthz")
        assert h["requests"] == 1 and h["errors"] == 1
    finally:
        srv.shutdown()


# --------------------------------------------------------------------------
# serve --http against the JAX server
# --------------------------------------------------------------------------

@contextlib.contextmanager
def http_serve(module, argv, monkeypatch, wait_s=120.0):
    """``module.main(argv)`` (``argv`` holding ``--http 0``) on a daemon
    thread; yields the bound port, shuts the server down after."""
    created = {}
    real = module.make_http_server

    def capture(port, classify, info, **kw):
        created["srv"] = real(port, classify, info, **kw)
        return created["srv"]

    monkeypatch.setattr(module, "make_http_server", capture)
    th = threading.Thread(target=module.main, args=(argv,), daemon=True)
    th.start()
    deadline = time.monotonic() + wait_s
    while "srv" not in created and time.monotonic() < deadline:
        time.sleep(0.02)
    assert "srv" in created, "the server did not start"
    try:
        yield created["srv"].server_address[1]
    finally:
        created["srv"].shutdown()
        th.join(timeout=30)
        assert not th.is_alive()


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A config (f32, t_bucket 4), the JAX-written ``.pth`` and three
    mp4s: 4 and 12 frames at 32x32, 4 frames at 40x48."""
    tmp = tmp_path_factory.mktemp("http")
    cfg = {"model_name": NAME, "num_classes": 13, "criterion": "CE",
           "use_autocast": False, "batch_size": 4,
           "effective_batch_size": 4, "video_paths": "",
           "data_backend": "synthetic", "t_bucket": 4, "max_frames": 16}
    cfg_path = tmp / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    pth = str(tmp / "w.pth")
    save_pth(pth, _perturb_batchnorm(JaxSmall3D(13).init(0),
                                     np.random.RandomState(4)),
             reverse_map=build_reverse_map(
                 MobileNetSmall3D(13).state_dict().keys(),
                 key_map_for(NAME)),
             rank_map=export_rank_for(NAME))
    clips = {"short": _write_mp4(tmp / "s.mp4", (32, 32), 4, seed=1),
             "long": _write_mp4(tmp / "l.mp4", (32, 32), 12, seed=1),
             "wide": _write_mp4(tmp / "w.mp4", (48, 40), 4, seed=2)}
    return str(cfg_path), pth, clips


def _same(got, want):
    assert (got["pred"], got["label"]) == (want["pred"], want["label"])
    assert abs(got["confidence"] - want["confidence"]) <= CONF_TOL


def test_serve_http_matches_jax_server(setup, monkeypatch):
    """Each clip POSTed to both servers alone: the same answer; GET / the
    same info; /healthz the same counters."""
    cfg, pth, clips = setup
    argv = [cfg, "--checkpoint", pth, "--http", "0", "--batch", "4"]
    answers = {}
    for label, module, extra in (("jax", jax_serve, []),
                                 ("port", serve, ["--device", "cpu"])):
        with http_serve(module, argv + extra, monkeypatch) as port:
            answers[label] = {name: _post(port, body)
                              for name, body in clips.items()}
            answers[label]["info"] = _get(port, "/")
            answers[label]["health"] = _get(port, "/healthz")
        monkeypatch.undo()
    for name in clips:
        assert answers["port"][name][0] == answers["jax"][name][0] == 200
        _same(answers["port"][name][1], answers["jax"][name][1])
    assert answers["port"]["info"] == answers["jax"]["info"] == {
        "mode": "checkpoint", "model_name": NAME, "num_classes": 13,
        "criterion": "CE"}
    assert answers["port"]["health"] == answers["jax"]["health"] == {
        "status": "ok", "requests": 3, "errors": 0}


def test_serve_http_concurrent_batched(setup, monkeypatch):
    """8 concurrent POSTs (the three clips in turn) coalesce through the
    batcher, keyed by T bucket and frame size; each answer is the JAX
    server's for its clip alone, and a bad body gets 400."""
    cfg, pth, clips = setup
    names = [list(clips)[i % 3] for i in range(8)]
    with http_serve(jax_serve, [cfg, "--checkpoint", pth, "--http", "0"],
                    monkeypatch) as port:
        want = {n: _post(port, clips[n])[1] for n in clips}
    monkeypatch.undo()
    with http_serve(serve, [cfg, "--checkpoint", pth, "--http", "0",
                            "--batch", "8", "--batch-window", "300",
                            "--device", "cpu"], monkeypatch) as port:
        recs = [None] * 8

        def post(i):
            recs[i] = _post(port, clips[names[i]], timeout=120)

        ts = [threading.Thread(target=post, args=(i,)) for i in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        bad = _post(port, b"not a video")
        health = _get(port, "/healthz")
    assert all(r is not None and r[0] == 200 for r in recs), recs
    for name, (_, rec) in zip(names, recs):
        _same(rec, want[name])
    assert bad[0] == 400 and "error" in bad[1]
    assert health == {"status": "ok", "requests": 9, "errors": 1}


def test_serve_http_mixed_lengths(setup, monkeypatch):
    """Clips of different lengths land in different T-bucket batches:
    co-batched, each gets its answer alone."""
    cfg, pth, clips = setup
    with http_serve(serve, [cfg, "--checkpoint", pth, "--http", "0",
                            "--batch", "4", "--batch-window", "300",
                            "--device", "cpu"], monkeypatch) as port:
        alone = {n: _post(port, clips[n])[1] for n in ("short", "long")}
        results = {}

        def worker(key, name):
            results[key] = _post(port, clips[name])

        ts = [threading.Thread(target=worker, args=(k, n))
              for k, n in (("s1", "short"), ("l1", "long"),
                           ("s2", "short"), ("l2", "long"))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    assert all(r[0] == 200 for r in results.values()), results
    for key, (_, rec) in results.items():
        _same(rec, alone["short" if key[0] == "s" else "long"])


# --------------------------------------------------------------------------
# --ema and the checkpoint kinds
# --------------------------------------------------------------------------

def _lines(capsys):
    return [json.loads(l) for l in capsys.readouterr().out.splitlines()
            if l.startswith("{")]


@pytest.fixture(scope="module")
def ema_run(tmp_path_factory):
    """A tiny port run with ema_decay 0.5: its final snapshot and the
    config it ran."""
    tmp = tmp_path_factory.mktemp("ema")
    cfg = {"model_name": NAME, "num_classes": 13, "criterion": "CE",
           "use_autocast": False, "learning_rate": 1e-2, "batch_size": 2,
           "effective_batch_size": 2, "max_iters": 1,
           "data_backend": "synthetic", "synthetic_len": 4,
           "synthetic_shape": [4, 32, 32], "t_bucket": 4, "max_frames": 4,
           "num_workers": 1, "optimizer": "adamw", "ema_decay": 0.5,
           "checkpoint_dir": str(tmp / "ck"), "log_dir": str(tmp / "runs"),
           "video_paths": ""}
    cfg_path = tmp / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    with contextlib.chdir(tmp):
        loop.train(Config(**cfg).validate(), device="cpu")
    snap = ckpt.latest_checkpoint(
        str(tmp / "ck" / f"{Config(**cfg).run_name()}_finished"))
    return str(cfg_path), snap, tmp


def test_serve_ema_equals_the_ema_weights_loaded_by_hand(ema_run, capsys):
    """``serve --ema`` on the snapshot gives the lines of a ``.pth`` that
    holds its EMA weights over its BatchNorm statistics, and other
    weights than the live ones."""
    cfg, snap, tmp = ema_run
    payload = ckpt.load_checkpoint(snap)
    model = MobileNetSmall3D(13)
    model.load_state_dict(payload["model"])
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(payload["ema"][name])
    pth = str(tmp / "ema.pth")
    torch.save(model.state_dict(), pth)
    assert sum(not torch.equal(payload["ema"][n], payload["model"][n])
               for n in payload["ema"]) > 50
    base = [cfg, "--csv", "x", "--limit", "4", "--batch", "2",
            "--device", "cpu"]
    assert serve.main(base + ["--checkpoint", snap, "--ema"]) == 0
    got = _lines(capsys)
    assert serve.main(base + ["--checkpoint", pth]) == 0
    assert got == _lines(capsys) and len(got) == 5
    # without --ema the snapshot serves its live weights
    assert serve.main(base + ["--checkpoint", snap]) == 0
    live = _lines(capsys)
    assert len(live) == 5


def test_serve_ema_rejects_pth(ema_run):
    """The JAX server's refusal: a .pth holds one weight set."""
    cfg, _, _ = ema_run
    with pytest.raises(SystemExit, match="EMA"):
        serve.main([cfg, "--checkpoint", "donor.pth", "--ema", "x.mp4",
                    "--device", "cpu"])


def test_serve_ema_rejects_a_snapshot_without_ema(ema_run, tmp_path):
    cfg, _, _ = ema_run
    model = MobileNetSmall3D(13)
    path = str(tmp_path / "snap")
    torch.save(ckpt.snapshot(model, AdamW(model.parameters()), None, 0,
                             [0, 0], [float("inf")] * 2 + [0]), path)
    with pytest.raises(SystemExit, match="no EMA weights.*ema_decay"):
        serve.main([cfg, "--checkpoint", path, "--ema", "x.mp4",
                    "--device", "cpu"])


def test_serve_refuses_an_orbax_directory(ema_run, tmp_path):
    cfg, _, _ = ema_run
    with pytest.raises(NotImplementedError, match="picklebot_tpu.convert"):
        serve.main([cfg, "--checkpoint", str(tmp_path), "x.mp4",
                    "--device", "cpu"])


# --------------------------------------------------------------------------
# the JAX server's refusals
# --------------------------------------------------------------------------

@pytest.mark.parametrize("flags,message", [
    (["--http", "0"], "--stream does not support --http"),
    (["--data-parallel", "2"], "--stream does not support --data-parallel"),
    (["--http", "0", "--csv", "x"],
     "--stream does not support --http, --csv"),
], ids=["http", "data_parallel", "http_csv"])
def test_serve_stream_rejects_server_flags(setup, capsys, flags, message):
    cfg, pth, _ = setup
    rc = serve.main([cfg, "--checkpoint", pth, "--stream", "x.mp4",
                     "--device", "cpu"] + flags)
    assert rc == 1
    assert message in capsys.readouterr().err


def test_serve_data_parallel_names_the_cards_it_found(setup, capsys):
    """More cards than the machine has (at least 2): a non-zero exit
    naming the count found, never a serve on fewer."""
    cfg, pth, _ = setup
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = max(found + 1, 2)
    rc = serve.main([cfg, "--checkpoint", pth, "--data-parallel", str(n),
                     "--csv", "x"])
    assert rc == 1
    assert f"--data-parallel {n} needs {n} CUDA cards; found {found}" in \
        capsys.readouterr().err


def test_serve_data_parallel_on_cpu_replicas_matches_one(setup, capsys):
    """--data-parallel 3 --device cpu: a batch of 4 (ragged over 3
    replicas) gives the records of the unsharded server."""
    cfg, pth, _ = setup
    outs = []
    for extra in ([], ["--data-parallel", "3"]):
        assert serve.main([cfg, "--checkpoint", pth, "--csv", "x",
                           "--limit", "4", "--batch", "4", "--device",
                           "cpu"] + extra) == 0
        outs.append([json.loads(line) for line in
                     capsys.readouterr().out.strip().splitlines()])
    one, sharded = outs
    assert len(one) == len(sharded) == 5
    for a, b in zip(one, sharded):
        assert a.keys() == b.keys()
        for key in a:
            if isinstance(a[key], float):
                assert abs(a[key] - b[key]) <= 1e-5, key
            else:
                assert a[key] == b[key], key


def test_serve_data_parallel_refuses_the_stream_model(tmp_path, capsys):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"model_name": "MoViNetA2Stream",
                               "num_classes": 13}))
    rc = serve.main([str(cfg), "--checkpoint", "w.pth", "--data-parallel",
                     "2", "x.mp4", "--device", "cpu"])
    assert rc == 1
    assert "--data-parallel does not support MoViNetA2Stream" in \
        capsys.readouterr().err


def test_serve_needs_a_config_and_a_checkpoint(capsys):
    assert serve.main(["x.mp4", "--device", "cpu"]) == 1
    assert "need <config> and --checkpoint (or --exported)" in \
        capsys.readouterr().err
