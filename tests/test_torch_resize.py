"""Port: the in-graph resize (``ops/resize.py``, ``config.input_size``)
against the JAX package.

Inputs come from a numpy seed and go to both packages, on the CPU.

Bounds. ``resize_frames`` in f32: 1e-5 absolute on [0, 1] pixels (the
weight matrices agree to the last f32 bit or so); in bf16: 2^-8 of
max|ref| (both round the matrix and the value between the two
contractions to bf16, in the same order). ``preprocess``: the same. The
train step at ``input_size``: the bounds of ``test_torch_train_step.py``.
The serve lines: pred and label equal, confidence within 1e-4 (the
rounding unit of both servers' 4 decimals).
"""

import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from picklebot_tpu import serve as jax_serve
from picklebot_tpu.core.module import DtypePolicy
from picklebot_tpu.models.mobilenet3d import MobileNetSmall3D as JaxSmall3D
from picklebot_tpu.models.movinet import MoViNetA2Stream as JaxStream
from picklebot_tpu.ops.resize import resize_frames as jax_resize
from picklebot_tpu.train import losses as jax_losses
from picklebot_tpu.train.checkpoint import build_reverse_map, save_pth
from picklebot_tpu.train.key_maps import export_rank_for, key_map_for
from picklebot_tpu.train.step import preprocess as jax_preprocess
from picklebot_tpu_torch import serve as port_serve
from picklebot_tpu_torch.convert import state_dict_from_jax
from picklebot_tpu_torch.core.policy import DtypePolicy as TorchPolicy
from picklebot_tpu_torch.data.dataset import pad_collate
from picklebot_tpu_torch.models.mobilenet3d import MobileNetSmall3D
from picklebot_tpu_torch.models.movinet import MoViNetA2Stream
from picklebot_tpu_torch.ops.resize import resize_frames, weight_matrix
from picklebot_tpu_torch.train.optim import AdamW
from picklebot_tpu_torch.train.step import make_train_step, preprocess
from test_torch_mobilenet2d import (check_stream_lines_match_jax,
                                    json_lines, write_stream_setup)
from test_torch_mobilenet3d import _perturb_batchnorm
from test_torch_mobilenet_small3d import (check_train_mode_batchnorm_statistics,
                                          check_train_step, port_from_jax)
from test_torch_train_step import A, B, LR, WD, _no_dropout
from picklebot_tpu.core.module import flatten_dict

INPUT_SIZE = 32


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
# resize_frames and preprocess
# --------------------------------------------------------------------------

@pytest.mark.parametrize("h,w", [(72, 128), (40, 40), (20, 24), (128, 72),
                                 (32, 48), (32, 32)],
                         ids=["down_wide", "down_square", "up", "down_tall",
                              "one_axis", "identity"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_resize_frames_matches_jax(rng, h, w, bf16):
    """(A, B, T, H, W, C) -> (A, B, T, 32, 32, C), leading dims untouched."""
    x = rng.rand(2, 2, 3, h, w, 3).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                           torch.float32)
    want = np.asarray(jax_resize(jnp.asarray(x, jdt), INPUT_SIZE)
                      .astype(jnp.float32))
    got = resize_frames(torch.from_numpy(x).to(tdt), INPUT_SIZE)
    assert got.dtype == tdt
    assert tuple(got.shape) == want.shape == (2, 2, 3, INPUT_SIZE,
                                              INPUT_SIZE, 3)
    tol = 2.0 ** -8 * np.abs(want).max() if bf16 else 1e-5
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def test_resize_is_the_identity_at_size():
    x = torch.rand(2, 3, INPUT_SIZE, INPUT_SIZE, 3)
    assert resize_frames(x, INPUT_SIZE) is x


@pytest.mark.parametrize("n_in,n_out", [(72, 32), (40, 32), (20, 32),
                                        (1280, 224), (100, 224)])
def test_weight_matrix_columns(n_in, n_out):
    """A bilinear matrix: every output sample's weights sum to 1, and on
    upscale no sample reads more than two input pixels."""
    w = weight_matrix(n_in, n_out)
    assert w.shape == (n_in, n_out) and w.dtype == np.float32
    np.testing.assert_allclose(w.sum(0), 1.0, rtol=0, atol=1e-6)
    if n_out > n_in:
        assert ((w > 0).sum(0) <= 2).all()


@pytest.mark.parametrize("standardize", [False, True],
                         ids=["plain", "mean_std"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_preprocess_with_input_size_matches_jax(rng, standardize, bf16):
    """/255 in the compute dtype, the resize, then mean/std."""
    feats = rng.randint(0, 256, (2, 4, 48, 40, 3)).astype(np.uint8)
    mean, std = ((0.45, 0.4, 0.35), (0.25, 0.2, 0.3)) if standardize \
        else (None, None)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                           torch.float32)
    want = np.asarray(jax_preprocess(jnp.asarray(feats), jdt, mean, std,
                                     input_size=INPUT_SIZE)
                      .astype(jnp.float32))
    got = preprocess(torch.from_numpy(feats), tdt, mean, std, INPUT_SIZE)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    tol = 2.0 ** -8 * np.abs(want).max() if bf16 else 1e-5
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def test_pad_collate_refuses_mixed_resolutions():
    """As the JAX collate: a batch must share one (H, W), whatever
    input_size does after it."""
    clips = [np.zeros((4, 32, 32, 3), np.uint8),
             np.zeros((4, 48, 32, 3), np.uint8)]
    with pytest.raises(ValueError, match="mixed frame shapes.*input_size"):
        pad_collate(clips, [0, 1])


# --------------------------------------------------------------------------
# a train step at input_size
# --------------------------------------------------------------------------

NATIVE = (8, 80, 72, 3)


def _jax_step_resized(jm, variables, feats, labels):
    """The JAX reference step of ``test_torch_train_step`` with
    ``preprocess(input_size=64)``."""
    from picklebot_tpu.train import optim as jax_optim

    policy = DtypePolicy.f32()

    def micro(params, state, x_u8, lbl):
        logits, new_state = jm.apply(
            {"params": params, "state": state},
            jax_preprocess(x_u8, jnp.float32, input_size=64), train=True,
            rng=jax.random.key(0), policy=policy)
        return jax_losses.cross_entropy(
            logits, jax_losses.prepare_labels("CE", lbl)), new_state

    value_and_grad = jax.jit(jax.value_and_grad(micro, has_aux=True))
    params, state = variables["params"], variables["state"]
    losses, grads = [], None
    for i in range(A):
        (loss, state), g = value_and_grad(params, state, feats[i], labels[i])
        losses.append(float(loss))
        grads = g if grads is None else jax.tree_util.tree_map(jnp.add,
                                                               grads, g)
    opt = jax_optim.AdamW(weight_decay=WD)
    opt.update(grads, opt.init(params), params, jnp.float32(LR))
    return losses, grads, state


@pytest.fixture(scope="module")
def step():
    """One f32 MobileNetSmall3D train step on (A, B, 8, 80, 72, 3) uint8
    clips resized in the step to 64 x 64, in both packages from the same
    weights; the seed is the Small3D test's (clear of hardswish's kinks)."""
    name = "MobileNetSmall3D"
    jm, port = JaxSmall3D(13), MobileNetSmall3D(13)
    rng = np.random.RandomState(7)
    v = _perturb_batchnorm(jm.init(0), rng)
    port_from_jax(name, v, port)
    _no_dropout(jm, port)
    feats = rng.randint(0, 256, (A, B) + NATIVE).astype(np.uint8)
    labels = rng.randint(0, 13, (A, B))
    losses, grads, state = _jax_step_resized(jm, v, feats, labels)
    want = {"grads": state_dict_from_jax(flatten_dict(grads), {}, name),
            "state": state_dict_from_jax({}, flatten_dict(state), name),
            "losses": losses}
    metrics = make_train_step(
        port, AdamW(port.parameters(), weight_decay=WD), "CE",
        lambda epoch: LR, TorchPolicy.f32(), device="cpu",
        input_size=64)(0, feats, labels)
    return want, port, metrics


def test_train_step_at_input_size_matches_jax(step):
    check_train_step(*step)


def test_train_step_at_input_size_batchnorm_statistics(step):
    check_train_mode_batchnorm_statistics(step[0], step[1])


# --------------------------------------------------------------------------
# serve at input_size
# --------------------------------------------------------------------------

def _write_mp4(path, w, h, frames, seed):
    cv2 = pytest.importorskip("cv2")
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30,
                         (w, h))
    r = np.random.RandomState(seed)
    for _ in range(frames):
        vw.write(r.randint(0, 255, (h, w, 3)).astype(np.uint8))
    vw.release()
    return str(path)


def test_serve_stream_at_input_size_matches_jax(tmp_path, capsys):
    """``--stream --chunk 2`` of MoViNetA2Stream on a 6-frame 40x48 mp4
    with input_size 32: both servers resize each chunk in the step and
    size the stream carry at 32 x 32; the lines agree."""
    name = "MoViNetA2Stream"
    cfg, pth, _ = write_stream_setup(tmp_path, name, JaxStream(13),
                                     MoViNetA2Stream(13), 32)
    with open(cfg) as f:
        config = json.load(f)
    config["input_size"] = INPUT_SIZE
    with open(cfg, "w") as f:
        json.dump(config, f)
    vid = _write_mp4(tmp_path / "wide.mp4", 48, 40, 6, seed=3)
    check_stream_lines_match_jax(
        capsys, [cfg, "--checkpoint", pth, "--stream", "--chunk", "2", vid],
        [2, 4, 6])


def test_serve_mixed_resolution_clips_match_jax(tmp_path, capsys):
    """The counterpart of the JAX ``test_serve_mixed_resolution_clips``:
    a 96x64 and a 64x48 clip in one call of each server (same-(H, W)
    groups, each resized in the predictor to 32): the lines agree, and a
    clip served alone gets the same line."""
    name = "MobileNetSmall3D"
    cfg = {"model_name": name, "num_classes": 13, "criterion": "CE",
           "use_autocast": False, "batch_size": 2,
           "effective_batch_size": 2, "video_paths": "",
           "data_backend": "opencv", "t_bucket": 4, "max_frames": 8,
           "input_size": INPUT_SIZE}
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    pth = str(tmp_path / "w.pth")
    save_pth(pth, _perturb_batchnorm(JaxSmall3D(13).init(0),
                                     np.random.RandomState(2)),
             reverse_map=build_reverse_map(
                 MobileNetSmall3D(13).state_dict().keys(),
                 key_map_for(name)),
             rank_map=export_rank_for(name))
    a = _write_mp4(tmp_path / "a.mp4", 96, 64, 4, seed=1)
    b = _write_mp4(tmp_path / "b.mp4", 64, 48, 4, seed=2)
    args = [str(cfg_path), "--checkpoint", pth, a, b]
    assert jax_serve.main(args) == 0
    want = json_lines(capsys)
    assert port_serve.main(args + ["--device", "cpu"]) == 0
    got = json_lines(capsys)
    assert [l["clip"] for l in got] == [l["clip"] for l in want] == [a, b]
    for g, w in zip(got, want):
        assert (g["pred"], g["label"]) == (w["pred"], w["label"])
        assert abs(g["confidence"] - w["confidence"]) <= 1e-4
    assert port_serve.main([str(cfg_path), "--checkpoint", pth, a,
                            "--device", "cpu"]) == 0
    assert json_lines(capsys) == got[:1]
