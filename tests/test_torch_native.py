"""Port: the native data cores (``data/native.py``): the C++ collate and
the libav decode backend, built from the port's own copies of the sources
into ``picklebot_tpu_torch/_build/``, against the JAX package's
``pad_collate`` and decoders on the same seeded inputs.

``tests/data/clip_10x32x48.mp4`` is a 10-frame 48x32 mp4v clip written
with cv2 (30 fps; frame t = RandomState(1234).rand(32, 48, 3) * 80 + 10 t,
as uint8); ``clip_10x32x48_rgb.npy`` holds its frames as OpenCV decodes
them (RGB), so a machine without cv2 has an exact reference."""

import os
import re

import numpy as np
import pytest

from picklebot_tpu.data import dataset as jax_data
from picklebot_tpu.data import native as jax_native
from picklebot_tpu.data.loader import DataLoader as JaxLoader
from picklebot_tpu_torch.data import dataset as port_data
from picklebot_tpu_torch.data import native
from picklebot_tpu_torch.data.loader import DataLoader
from picklebot_tpu_torch.utils import build

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FIXTURE = os.path.join(DATA, "clip_10x32x48.mp4")
FIXTURE_RGB = os.path.join(DATA, "clip_10x32x48_rgb.npy")


def _needs_ffmpeg():
    if not native.ffmpeg_available():
        pytest.skip("libav* dev libraries not installed")


def _clips(rng, lengths, hw=(6, 10)):
    return [rng.randint(0, 255, (t,) + hw + (3,)).astype(np.uint8)
            for t in lengths]


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("lengths,t_bucket,max_frames", [
    ((3, 7, 5), 8, 32),            # ragged T, padded to one bucket
    ((20, 33, 40, 9), 8, 32),      # T past max_frames: heads kept
    ((1,), 4, 4),                  # one clip
])
def test_native_collate_matches_numpy_and_jax(rng, lengths, t_bucket,
                                              max_frames, threads):
    clips = _clips(rng, lengths)
    t_out = port_data.bucket_frames(max(lengths), t_bucket, max_frames)
    dst = np.zeros((len(clips), t_out) + clips[0].shape[1:], np.uint8)
    before = native.COLLATES["native"]
    assert native.native_collate(dst, clips, num_threads=threads)
    assert native.COLLATES["native"] == before + 1
    numpy_batch, _ = port_data.pad_collate(clips, list(range(len(clips))),
                                           t_bucket, max_frames,
                                           native=False)
    jax_batch, _ = jax_data.pad_collate(clips, list(range(len(clips))),
                                        t_bucket, max_frames, native=False)
    assert dst.tobytes() == numpy_batch.tobytes() == jax_batch.tobytes()


def test_pad_collate_counts_its_path(rng):
    clips = _clips(rng, (5, 12, 2))
    labels = [4, 1, 9]
    n0 = dict(native.COLLATES)
    got, got_labels = port_data.pad_collate(clips, labels, 8, 16)
    assert native.COLLATES == {"native": n0["native"] + 1,
                               "numpy": n0["numpy"]}
    plain, _ = port_data.pad_collate(clips, labels, 8, 16, native=False)
    assert native.COLLATES["numpy"] == n0["numpy"] + 1
    want, want_labels = jax_data.pad_collate(clips, labels, 8, 16)
    assert got.tobytes() == plain.tobytes() == want.tobytes()
    assert got_labels.dtype == np.int64
    np.testing.assert_array_equal(got_labels, want_labels)


def test_collate_falls_back_to_numpy_without_the_library(rng, monkeypatch):
    """Where the library cannot be built the batch is numpy's, the same
    bytes, and the counter says which path ran."""
    monkeypatch.setattr(native, "get_lib", lambda: None)
    clips = _clips(rng, (3, 6))
    n0 = dict(native.COLLATES)
    got, _ = port_data.pad_collate(clips, [0, 1], 4, 8)
    assert native.COLLATES == {"native": n0["native"],
                               "numpy": n0["numpy"] + 1}
    want, _ = jax_data.pad_collate(clips, [0, 1], 4, 8, native=False)
    assert got.tobytes() == want.tobytes()


def test_library_lands_in_build_under_its_hash(monkeypatch):
    assert native.get_lib() is not None
    src, flags = native.LIBRARIES["collate"]
    path = build.host_library_path(src, flags)
    assert path.parent == build.BUILD_DIR
    assert path.exists()
    assert re.fullmatch(r"collate-[0-9a-f]{16}\.so", path.name)
    # the hash covers the flags (and the source): other flags, other file
    assert build.host_library_path(src, flags + ("-g",)) != path
    # and the host: a tree copied to another machine builds anew there
    monkeypatch.setattr(build.platform, "node", lambda: "another-host")
    assert build.host_library_path(src, flags) != path
    # the sources are the port's own copies
    assert src.parent == native.SRC_DIR
    assert "picklebot_tpu_torch" in str(src)


def test_build_host_raises_with_the_compiler_output(tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="broken.cpp.*g\\+\\+ exit"):
        build.build_host(bad, ("-shared", "-fPIC"))
    assert not build.host_library_path(bad, ("-shared", "-fPIC")).exists()


@pytest.mark.parametrize("backend", ["ffmpeg", "opencv", "npy"])
def test_clip_dataset_accepts_every_video_backend(tmp_path, backend):
    csv = tmp_path / "ann.csv"
    csv.write_text("filename,zone\nclip.mp4,3\n")
    ds = port_data.ClipDataset(str(csv), str(tmp_path), backend=backend)
    assert ds.backend == backend and list(ds.labels) == [3]


def test_unknown_backend_is_refused(tmp_path):
    with pytest.raises(ValueError, match="unknown data backend"):
        port_data.ClipDataset("", "", backend="torchvision")


def test_ffmpeg_unavailable_raises_the_jax_message(monkeypatch):
    monkeypatch.setattr(native, "get_videodec_lib", lambda: None)
    monkeypatch.setattr(jax_native, "get_videodec_lib", lambda: None)
    with pytest.raises(RuntimeError) as got:
        port_data.decode_ffmpeg(FIXTURE)
    with pytest.raises(RuntimeError) as want:
        jax_data.decode_ffmpeg(FIXTURE)
    assert str(got.value) == str(want.value)
    assert "libavformat" in str(got.value)
    assert not native.ffmpeg_available()


def test_fixture_is_opencv_decode_of_the_clip():
    pytest.importorskip("cv2")
    want = np.load(FIXTURE_RGB)
    assert want.shape == (10, 32, 48, 3) and want.dtype == np.uint8
    np.testing.assert_array_equal(port_data.decode_opencv(FIXTURE), want)


def test_fixture_decodes_byte_exact_through_ffmpeg():
    _needs_ffmpeg()
    want = np.load(FIXTURE_RGB)
    got = native.decode_video_ffmpeg(FIXTURE)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    # the JAX package's core, from its own copy of the same source
    if jax_native.ffmpeg_available():
        np.testing.assert_array_equal(jax_native.decode_video_ffmpeg(
            FIXTURE), got)
    np.testing.assert_array_equal(
        native.decode_video_ffmpeg(FIXTURE, max_frames=4), want[:4])


def test_ffmpeg_backend_matches_opencv(tmp_path, rng):
    """The libavcodec core must reproduce the OpenCV backend's frames on
    the same mp4s: both decode through libavcodec, so parity is exact."""
    cv2 = pytest.importorskip("cv2")
    _needs_ffmpeg()
    name = "clip.mp4"
    w = cv2.VideoWriter(str(tmp_path / name),
                        cv2.VideoWriter_fourcc(*"mp4v"), 30, (48, 32))
    assert w.isOpened()
    for t in range(10):  # I frame + P frames (mp4v GOP spans this clip)
        frame = ((rng.rand(32, 48, 3) * 80) + t * 10).astype(np.uint8)
        w.write(frame)
    w.release()
    csv = tmp_path / "ann.csv"
    csv.write_text(f"filename,zone\n{name},5\n")

    ds_cv = port_data.ClipDataset(str(csv), str(tmp_path), backend="opencv")
    ds_ff = port_data.ClipDataset(str(csv), str(tmp_path), backend="ffmpeg")
    ds_jax = jax_data.ClipDataset(str(csv), str(tmp_path), backend="ffmpeg")
    clip_cv, label_cv = ds_cv[0]
    clip_ff, label_ff = ds_ff[0]
    assert label_cv == label_ff == 5
    assert clip_ff.shape == clip_cv.shape == (10, 32, 48, 3)
    assert clip_ff.dtype == np.uint8
    np.testing.assert_array_equal(clip_ff, clip_cv)
    np.testing.assert_array_equal(clip_ff, ds_jax[0][0])


@pytest.mark.parametrize("sample_fps", [10.0, 12.0])
def test_ffmpeg_sample_fps_picks_opencv_frames(tmp_path, rng, sample_fps):
    """25 fps at sample_fps 10 is a half-integer ratio (2.5 -> stride 3,
    round half up in both backends); 12 gives 2.08 -> 2."""
    cv2 = pytest.importorskip("cv2")
    _needs_ffmpeg()
    path = tmp_path / "c25.mp4"
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 25,
                        (32, 24))
    for t in range(11):
        w.write(((rng.rand(24, 32, 3) * 60) + t * 15).astype(np.uint8))
    w.release()
    got = port_data.decode_ffmpeg(str(path), sample_fps)
    want = port_data.decode_opencv(str(path), sample_fps)
    stride = port_data.sample_stride(25.0, sample_fps)
    assert stride == {10.0: 3, 12.0: 2}[sample_fps]
    assert got.shape[0] == -(-11 // stride)
    np.testing.assert_array_equal(got, want)


def test_ffmpeg_backend_through_loader(tmp_path, rng):
    """backend='ffmpeg' drives the loader (threaded decode workers and
    the C++ collate), selected by config data_backend, and gives the JAX
    loader's batch."""
    cv2 = pytest.importorskip("cv2")
    _needs_ffmpeg()
    rows = []
    for i, t in enumerate((5, 7)):
        name = f"clip{i}.mp4"
        w = cv2.VideoWriter(str(tmp_path / name),
                            cv2.VideoWriter_fourcc(*"mp4v"), 30, (32, 24))
        assert w.isOpened()
        for _ in range(t):
            w.write(rng.randint(0, 255, (24, 32, 3)).astype(np.uint8))
        w.release()
        rows.append((name, i))
    csv = tmp_path / "ann.csv"
    csv.write_text("filename,zone\n" +
                   "\n".join(f"{n},{z}" for n, z in rows) + "\n")

    from picklebot_tpu_torch.utils.config import Config
    cfg = Config(data_backend="ffmpeg").validate()   # accepted by config
    ds = port_data.ClipDataset(str(csv), str(tmp_path),
                               backend=cfg.data_backend)
    n0 = dict(native.COLLATES)
    (feats, labels), = list(DataLoader(ds, batch_size=2, num_workers=2,
                                       t_bucket=8, max_frames=16))
    assert native.COLLATES["native"] == n0["native"] + 1
    assert native.COLLATES["numpy"] == n0["numpy"]
    assert feats.shape == (2, 8, 24, 32, 3)
    assert list(labels) == [0, 1]
    assert feats[0, :5].sum() > 0 and feats[0, 5:].sum() == 0
    jds = jax_data.ClipDataset(str(csv), str(tmp_path), backend="opencv")
    (want, _), = list(JaxLoader(jds, batch_size=2, num_workers=2,
                                t_bucket=8, max_frames=16))
    np.testing.assert_array_equal(feats, want)


@pytest.mark.parametrize("corruption", ["truncated", "zero_byte"])
def test_bad_clip_raises_with_filename(tmp_path, rng, corruption):
    cv2 = pytest.importorskip("cv2")
    _needs_ffmpeg()
    w = cv2.VideoWriter(str(tmp_path / "good.mp4"),
                        cv2.VideoWriter_fourcc(*"mp4v"), 30, (32, 24))
    for _ in range(8):
        w.write(rng.randint(0, 255, (24, 32, 3)).astype(np.uint8))
    w.release()
    bad = tmp_path / "bad.mp4"
    data = (tmp_path / "good.mp4").read_bytes()
    bad.write_bytes(data[: len(data) // 3] if corruption == "truncated"
                    else b"")
    csv = tmp_path / "ann.csv"
    csv.write_text("filename,zone\ngood.mp4,0\nbad.mp4,1\n")
    ds = port_data.ClipDataset(str(csv), str(tmp_path), backend="ffmpeg")
    assert ds[0][0].shape == (8, 24, 32, 3)
    with pytest.raises((OSError, RuntimeError), match="bad.mp4"):
        ds[1]
    skipping = port_data.ClipDataset(str(csv), str(tmp_path),
                                     backend="ffmpeg", skip_bad_clips=True)
    assert skipping[1][1] == 0 and skipping.bad_clips == 1


def test_serve_reads_the_fixture_through_ffmpeg(tmp_path, capsys):
    """serve --csv takes its backend from config.data_backend: the mp4
    through the libav core gives the records of its stored frames served
    from .npy, on a MobileNetSmall3D resized in the predictor."""
    _needs_ffmpeg()
    import json

    import torch

    from picklebot_tpu_torch import serve
    from picklebot_tpu_torch.models.registry import initialize_model
    from picklebot_tpu_torch.utils.config import Config

    np.save(tmp_path / "clip.npy", np.load(FIXTURE_RGB))
    pth = tmp_path / "w.pth"
    torch.save(initialize_model(Config(model_name="MobileNetSmall3D",
                                       num_classes=13)).state_dict(), pth)
    records = {}
    for backend, name, video_dir in (
            ("ffmpeg", os.path.basename(FIXTURE), DATA),
            ("npy", "clip.npy", str(tmp_path))):
        csv = tmp_path / f"{backend}.csv"
        csv.write_text(f"filename,zone\n{name},5\n")
        cfg = tmp_path / f"{backend}.json"
        cfg.write_text(json.dumps({
            "model_name": "MobileNetSmall3D", "num_classes": 13,
            "use_autocast": False, "data_backend": backend,
            "video_paths": video_dir, "input_size": 32}))
        assert serve.main([str(cfg), "--checkpoint", str(pth), "--csv",
                           str(csv), "--device", "cpu"]) == 0
        lines = [json.loads(l) for l in
                 capsys.readouterr().out.splitlines() if l.startswith("{")]
        assert lines[-1]["evaluated"] == 1
        records[backend] = {k: v for k, v in lines[0].items()
                            if k != "clip"}
    assert records["ffmpeg"] == records["npy"]
