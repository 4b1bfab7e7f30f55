"""Port: the streaming path of MoViNet-A2 (``CausalConv3d``,
``MoViNetA2Stream``) and ``serve --stream``, against the JAX package.

Weights move from the JAX package's ``init`` (BatchNorm statistics
perturbed) through ``state_dict_from_jax``, or leaf by leaf for a single
conv; inputs come from a numpy seed and go to both. Everything runs on the
CPU, MoViNet at 32x32 with T = 8.

Bounds. ``CausalConv3d`` in f32: 1e-5 of max|ref| (one f32 conv summed in
another order). Model logits, chunk by chunk: f32 1e-4, bf16 5% of
max|logit|, as for the offline model. Causality: bit-equal.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from picklebot_tpu.core.module import DtypePolicy
from picklebot_tpu.models.movinet import MoViNetA2Stream as JaxStream
from picklebot_tpu.ops.conv import CausalConv3d as JaxCausalConv3d
from picklebot_tpu_torch import cli
from picklebot_tpu_torch import serve as port_serve
from picklebot_tpu_torch.convert import load_pth
from picklebot_tpu_torch.core.policy import DtypePolicy as TorchPolicy
from picklebot_tpu_torch.models.movinet import MoViNetA2, MoViNetA2Stream
from picklebot_tpu_torch.ops.conv import CausalConv3d
from picklebot_tpu_torch.train.loop import train
from picklebot_tpu_torch.utils.config import Config
from test_torch_mobilenet2d import (_close, _t, check_stream_lines_match_jax,
                                    write_stream_setup)
from test_torch_mobilenet3d import _perturb_batchnorm
from test_torch_mobilenet_small3d import (check_serve_matches_jax_serve,
                                          check_state_dict_equals_jax_export,
                                          port_from_jax, write_config)

NAME = "MoViNetA2Stream"
CLIP = (8, 32, 32, 3)


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
# CausalConv3d
# --------------------------------------------------------------------------

@pytest.mark.parametrize("with_buffer", [False, True],
                         ids=["zero_pad", "buffer"])
@pytest.mark.parametrize("kernel,stride", [
    ((3, 3, 3), (1, 1, 1)), ((5, 3, 3), (1, 2, 2)), ((1, 5, 5), (1, 2, 2))],
    ids=["k333", "k533s2", "k155s2"])
def test_causal_conv_matches_jax(rng, kernel, stride, with_buffer):
    """The depthwise causal conv, as MoViNet's blocks use it: T left-padded
    with zeros, or a buffer of the last kT - 1 frames put in front (and
    the new buffer returned; with kT = 1 the given one)."""
    c = 6
    jm = JaxCausalConv3d(c, c, kernel, stride=stride, groups=c)
    v = jm.init(0)
    port = CausalConv3d(c, c, kernel, stride=stride, groups=c)
    with torch.no_grad():
        port.weight.copy_(_t(v["params"]["conv"]["w"]).permute(4, 3, 0, 1, 2))
    assert port.t_context == kernel[0] - 1
    x = rng.randn(2, 4, 11, 10, c).astype(np.float32)
    if with_buffer:
        buf = rng.randn(2, kernel[0] - 1, 11, 10, c).astype(np.float32)
        (want, want_buf), _ = jm.apply(v, jnp.asarray(x), jnp.asarray(buf),
                                       policy=DtypePolicy.f32())
        with torch.no_grad():
            got, got_buf = port(_t(x), _t(buf))
        assert got_buf.shape == want_buf.shape
        np.testing.assert_array_equal(got_buf.numpy(), np.asarray(want_buf))
    else:
        want, _ = jm.apply(v, jnp.asarray(x), policy=DtypePolicy.f32())
        with torch.no_grad():
            got = port(_t(x))
    assert got.shape == want.shape
    _close(got.numpy(), want, 1e-5)


# --------------------------------------------------------------------------
# MoViNetA2Stream
# --------------------------------------------------------------------------

def test_parameter_count_and_keys_are_the_offline_models():
    m = MoViNetA2Stream(num_classes=13)
    assert sum(p.numel() for p in m.parameters()) == 3_992_289
    assert m.state_dict().keys() == MoViNetA2(13).state_dict().keys()
    blocks = m.blocks()
    assert len(blocks) == 26 and all(
        isinstance(b.conv, CausalConv3d) for b in blocks)
    assert sorted({b.conv.t_context for b in blocks}) == [0, 2, 4]


def test_offline_pth_loads_strictly_into_the_stream_model_and_back(tmp_path):
    offline = MoViNetA2(13, seed=3)
    path = str(tmp_path / "w.pth")
    torch.save(offline.state_dict(), path)
    stream = load_pth(path, MoViNetA2Stream(13))
    for key, value in offline.state_dict().items():
        assert torch.equal(stream.state_dict()[key], value), key
    torch.save(MoViNetA2Stream(13, seed=4).state_dict(), path)
    load_pth(path, MoViNetA2(13))


def test_state_dict_from_jax_equals_jax_export():
    check_state_dict_equals_jax_export(NAME, JaxStream(13),
                                       MoViNetA2Stream(13))


@pytest.mark.parametrize("height,width", [(32, 32), (33, 35)])
def test_init_stream_matches_jax(height, width):
    """One zero buffer per block, ceil-divided spatial sizes (odd frames
    included), and the f32 pool carry."""
    want_bufs, (want_sum, want_count) = JaxStream(13).init_stream(
        2, height, width)
    bufs, (pool_sum, count) = MoViNetA2Stream(13).init_stream(
        2, height, width, torch.bfloat16)
    assert [tuple(b.shape) for b in bufs] == [b.shape for b in want_bufs]
    assert all(b.dtype == torch.bfloat16 and not b.any() for b in bufs)
    assert pool_sum.shape == want_sum.shape == (2, 640)
    assert pool_sum.dtype == count.dtype == torch.float32
    assert count.shape == () and float(count) == float(want_count) == 0.0


@pytest.fixture(scope="module")
def pair():
    """The JAX stream model, its variables and the port from them."""
    jm = JaxStream(13)
    v = _perturb_batchnorm(jm.init(0), np.random.RandomState(5))
    return jm, v, port_from_jax(NAME, v, MoViNetA2Stream(13)).eval()


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_eval_logits_match_jax(rng, pair, bf16):
    """Two chunks (5 frames, then 3) from a zero carry in both packages:
    the logits after each, the carried buffers and the pool sum."""
    jm, v, port = pair
    x = rng.rand(2, *CLIP).astype(np.float32)
    policy = DtypePolicy.bf16() if bf16 else DtypePolicy.f32()
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                           torch.float32)
    step = jax.jit(lambda v, x, c: jm.apply(v, x, c, train=False,
                                            policy=policy)[0])
    carry = jm.init_stream(2, 32, 32, dtype=jdt)
    tcarry = port.init_stream(2, 32, 32, tdt)
    tol = 0.05 if bf16 else 1e-4
    for s, e in ((0, 5), (5, 8)):
        want, carry = step(v, jnp.asarray(x[:, s:e], jdt), carry)
        with torch.inference_mode(), (TorchPolicy.bf16() if bf16
                                      else TorchPolicy.f32()).precision():
            got, tcarry = port(_t(x[:, s:e]).to(tdt), tcarry)
        assert got.dtype == tdt and got.shape == (2, 13)
        _close(got.float().numpy(), want, tol)
    _close(tcarry[1][0].numpy(), carry[1][0], tol)
    assert float(tcarry[1][1]) == float(carry[1][1]) == 8.0
    for g, w in zip(tcarry[0], carry[0]):
        assert g.shape == w.shape and g.dtype == tdt
    if not bf16:
        for g, w in zip(tcarry[0], carry[0]):
            if g.numel():
                _close(g.numpy(), w, 1e-4)


@pytest.fixture(scope="module")
def calibrated(tmp_path_factory):
    """The port with every BatchNorm's running statistics set to its
    input's on one whole clip (the variance at least 1e-2, so that no
    near-constant channel amplifies f32 rounding), so that activations
    stay O(1) through the 26 blocks as in a trained model, and the JAX
    model with the same weights (through a ``.pth``); a jitted JAX stream
    step; another clip; the ``.pth``."""
    from picklebot_tpu.train.checkpoint import load_pth as jax_load_pth
    from picklebot_tpu.train.key_maps import key_map_for
    from picklebot_tpu_torch.ops.norm import BatchNorm

    port = MoViNetA2Stream(13, seed=1).eval()
    rng = np.random.RandomState(6)

    def hook(mod, args):
        v = args[0].float()
        dims = tuple(range(v.dim() - 1))
        mod.running_mean.copy_(v.mean(dims))
        mod.running_var.copy_(v.var(dims, unbiased=False).clamp_min(1e-2))
    hooks = [m.register_forward_pre_hook(hook) for m in port.modules()
             if isinstance(m, BatchNorm)]
    with torch.inference_mode():
        port(_t(rng.rand(2, *CLIP)))
    for h in hooks:
        h.remove()
    path = str(tmp_path_factory.mktemp("calibrated") / "w.pth")
    torch.save(port.state_dict(), path)
    jm = JaxStream(13)
    v = jax_load_pth(path, jm.init(0), key_map=key_map_for(NAME))
    step = jax.jit(lambda v, x, c: jm.apply(v, x, c, train=False,
                                            policy=DtypePolicy.f32())[0])
    return jm, v, step, port, rng.rand(2, *CLIP).astype(np.float32), path


@pytest.mark.parametrize("chunk", [1, 3, 4, 8])
def test_chunked_stream_matches_jax(calibrated, chunk):
    """T = 8 in chunks of 1, 4, 3 (a ragged tail of 2) and 8 (the whole
    clip in one chunk, what the server runs without --stream), in both
    packages from zero carries: the logits after every chunk, f32.

    Only the 2-D models' chunks give the whole clip's logits: the SE blocks
    of both packages' MoViNetA2Stream pool over the frames of the chunk at
    hand, so here the chunked logits move far from the whole clip's (by
    about twice max|logit| on an H100 at 224x224, PERF.md) and are
    held to the JAX package's chunked logits instead."""
    jm, v, step, port, x, _ = calibrated
    carry = jm.init_stream(2, 32, 32)
    tcarry = port.init_stream(2, 32, 32)
    for s in range(0, 8, chunk):
        want, carry = step(v, jnp.asarray(x[:, s:s + chunk]), carry)
        with torch.inference_mode():
            got, tcarry = port(_t(x[:, s:s + chunk]), tcarry)
        _close(got.numpy(), want, 1e-4)
    if chunk == 8:
        with torch.inference_mode():
            assert torch.equal(port(_t(x)), got)


def test_stream_clip_runs_a_ragged_tail_frame_by_frame(calibrated):
    """serve's per-clip loop on 8 uint8 frames at --chunk 3: two chunks,
    then frames 6 and 7 one by one, as the JAX server runs them; one
    record per chunk and one at frame 8, each record's logits the JAX
    package's after the same pieces (f32 1e-4). At these weights the tail
    as one 2-frame piece lands far from that (the SE blocks pool the
    piece's frames), so a one-piece tail would fail here."""
    jm, v, step, port, _, _ = calibrated
    frames = np.random.RandomState(8).randint(0, 256, (8, 32, 32, 3),
                                              np.uint8)
    records = list(port_serve.stream_clip(port, frames, 3, TorchPolicy.f32(),
                                          "cpu", "CE", 13))
    assert [r["frame"] for r, _ in records] == [3, 6, 8]
    x = frames[None].astype(np.float32) / 255.0
    carry = jm.init_stream(1, 32, 32)
    wants = []
    for s, e in ((0, 3), (3, 6), (6, 7), (7, 8)):
        want, carry = step(v, jnp.asarray(x[:, s:e]), carry)
        wants.append(np.asarray(want))
        if s == 3:
            tail_carry = carry
    for (rec, got), want in zip(records, [wants[0], wants[1], wants[3]]):
        _close(got, want, 1e-4)
        assert rec["pred"] == int(want.argmax())
    one_piece, _ = step(v, jnp.asarray(x[:, 6:8]), tail_carry)
    assert np.abs(np.asarray(one_piece) - wants[3]).max() > \
        1e-2 * np.abs(wants[3]).max()


def test_causal_offline_form_is_the_whole_clip_stream(pair):
    """``MoViNetA2(causal=True)``, the stream model's blocks without a
    carry, runs a whole clip from zero left context: with the stream
    model's weights it gives the stream model's whole-clip logits (the
    global pool against the running mean, f32 1e-5)."""
    _, _, port = pair
    offline = MoViNetA2(13, causal=True).eval()
    offline.load_state_dict(port.state_dict())
    x = _t(np.random.RandomState(9).rand(2, *CLIP))
    with torch.inference_mode():
        _close(offline(x).numpy(), port(x).numpy(), 1e-5)


def test_streaming_is_causal(rng, pair):
    """The first chunk's logits do not depend on the frames after it."""
    _, _, port = pair
    head = rng.rand(1, 3, 32, 32, 3)
    firsts = []
    for _ in range(2):
        x = _t(np.concatenate([head, rng.rand(1, 5, 32, 32, 3)], axis=1))
        with torch.inference_mode():
            firsts.append(port(x[:, :3], port.init_stream(1, 32, 32))[0])
    assert torch.equal(firsts[0], firsts[1])


# --------------------------------------------------------------------------
# serve and train
# --------------------------------------------------------------------------

def test_whole_clip_serve_matches_jax_serve(tmp_path, capsys):
    """Without --stream: a zero carry per batch and the whole (padded)
    clip in one chunk, in both servers."""
    check_serve_matches_jax_serve(tmp_path, capsys, NAME, JaxStream(13),
                                  MoViNetA2Stream(13))


@pytest.mark.parametrize("chunk,frames", [(2, [2, 4, 6]), (4, [4, 6])],
                         ids=["chunk2", "ragged"])
def test_serve_stream_matches_jax_serve(tmp_path, capsys, calibrated, chunk,
                                        frames):
    """``--stream --chunk N`` on a 6-frame 32x32 mp4 from the calibrated
    ``.pth``: both servers run a ragged tail frame by frame, and the lines
    agree. (The last line is not the whole-clip server's: see
    ``test_chunked_stream_matches_jax``.)"""
    cfg, pth, vid = write_stream_setup(tmp_path, NAME, JaxStream(13),
                                       MoViNetA2Stream(13), 32,
                                       pth=calibrated[-1])
    check_stream_lines_match_jax(
        capsys, [cfg, "--checkpoint", pth, "--stream", "--chunk",
                 str(chunk), vid], frames)


@pytest.mark.parametrize("model,extra,message", [
    ("MobileNetSmall3D", ["clip.mp4"], "--stream needs one of"),
    (NAME, [], "no clips given"),
    (NAME, ["--csv", "x"], "--stream does not support --csv"),
], ids=["offline_model", "no_clips", "csv"])
def test_serve_stream_refusals(tmp_path, capsys, model, extra, message):
    """rc 1 with the JAX server's message, before any clip is read."""
    cfg = write_config(tmp_path, model)
    pth = str(tmp_path / "w.pth")
    torch.save({}, pth)
    rc = port_serve.main([cfg, "--checkpoint", pth, "--stream",
                          "--device", "cpu"] + extra)
    assert rc == 1
    assert message in capsys.readouterr().err


def test_trainer_refuses_the_stream_model_by_name(tmp_path):
    """Neither package trains MoViNetA2Stream (the JAX train step passes
    no carry): ``train()`` and the CLI refuse it before any dataset is
    built (the annotation files do not exist)."""
    cfg = Config(model_name=NAME, num_classes=13,
                 train_annotations_file=str(tmp_path / "none.csv"),
                 val_annotations_file=str(tmp_path / "none.csv"),
                 checkpoint_dir=str(tmp_path / "ck")).validate()
    with pytest.raises(ValueError, match="MoViNetA2Stream.*MoViNetA2"):
        train(cfg, device="cpu")
    with pytest.raises(ValueError, match="MoViNetA2Stream"):
        cli.main([write_config(tmp_path, NAME), "--device", "cpu"])
    assert not (tmp_path / "ck").exists()
