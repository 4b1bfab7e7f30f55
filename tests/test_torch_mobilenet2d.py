"""Port: MobileNetLarge2D and MobileNetSmall2D, with their ops (``Conv2d``,
``LSTM``, ``AvgPool2d``, ``Bottleneck2D``), against the JAX package.

Weights move from the JAX package's ``init`` (BatchNorm statistics
perturbed) to the port through ``state_dict_from_jax``, or leaf by leaf for
a single op; inputs come from a numpy seed and go to both. Everything runs
on the CPU. The reference's AvgPool2d(7) needs 7x7 maps, so the models see
224x224 frames (B = 1, T = 3 for the logits).

Bounds. Ops in f32: 1e-5 of max|ref| (the same f32 arithmetic, summed in
another order). The LSTM in bf16: 2^-6 of max|ref| (each step rounds h
and c to bf16 in both packages, at slightly different places). Model
logits: f32 1e-4, bf16 5% of max|logit|, as for the 3-D models. Chunked
against whole-clip logits in the port: f32 1e-4 of max|logit| (the same
arithmetic, the LSTM state passed through the carry). The train step's
bounds are those of ``test_torch_mobilenet_small3d.py``.
"""

import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from picklebot_tpu import serve as jax_serve
from picklebot_tpu.core.module import DtypePolicy
from picklebot_tpu.models import mobilenet2d_lstm as jax_m2d
from picklebot_tpu.ops import activations as jax_act
from picklebot_tpu.ops.bottleneck import Bottleneck2D as JaxBottleneck2D
from picklebot_tpu.ops.conv import Conv2d as JaxConv2d
from picklebot_tpu.ops.linear import LSTM as JaxLSTM
from picklebot_tpu.ops.linear import AvgPool2d as JaxAvgPool2d
from picklebot_tpu.train.checkpoint import build_reverse_map, save_pth
from picklebot_tpu.train.key_maps import export_rank_for, key_map_for
from picklebot_tpu_torch import serve as port_serve
from picklebot_tpu_torch.core.policy import DtypePolicy as TorchPolicy
from picklebot_tpu_torch.models.mobilenet2d_lstm import (MobileNetLarge2D,
                                                         MobileNetSmall2D)
from picklebot_tpu_torch.ops import activations as act
from picklebot_tpu_torch.ops.bottleneck import Bottleneck2D
from picklebot_tpu_torch.ops.conv import Conv2d
from picklebot_tpu_torch.ops.linear import LSTM, AvgPool2d
from test_torch_mobilenet3d import _perturb_batchnorm
from test_torch_mobilenet_small3d import (
    check_cli_trains_and_both_packages_load_the_pth,
    check_state_dict_equals_jax_export,
    check_train_mode_batchnorm_statistics, check_train_step, port_from_jax,
    train_step_against_jax)

MODELS = {"MobileNetLarge2D": (jax_m2d.MobileNetLarge2D, MobileNetLarge2D,
                               3_119_531),
          "MobileNetSmall2D": (jax_m2d.MobileNetSmall2D, MobileNetSmall2D,
                               1_244_251)}
FRAME = (224, 224, 3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel worker
    processes, and torch's OpenMP threads slow every worker once they
    outnumber the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rel * np.abs(want).max())


def _t(x):
    return torch.from_numpy(np.array(x, np.float32, copy=True))


# --------------------------------------------------------------------------
# ops
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cin,cout,k,stride,pad,groups,bias", [
    (3, 16, 3, 2, 1, 1, True),         # the stem
    (24, 24, 5, 2, 2, 24, False),      # a k5 s2 depthwise conv
    (16, 40, 1, 1, 0, 1, False),       # a 1x1 (matmul) conv
], ids=["stem", "depthwise", "pointwise"])
def test_conv2d_matches_jax(rng, cin, cout, k, stride, pad, groups, bias):
    jm = JaxConv2d(cin, cout, k, stride=stride, padding=pad, groups=groups,
                   bias=bias)
    v = jm.init(0)
    port = Conv2d(cin, cout, k, stride=stride, padding=pad, groups=groups,
                  bias=bias)
    with torch.no_grad():
        port.weight.copy_(_t(v["params"]["w"]).permute(3, 2, 0, 1))
        if bias:
            port.bias.copy_(_t(v["params"]["b"]))
    x = rng.rand(2, 15, 13, cin).astype(np.float32)
    want, _ = jm.apply(v, jnp.asarray(x), policy=DtypePolicy.f32())
    with torch.no_grad():
        got = port(_t(x))
    assert got.shape == want.shape
    _close(got.numpy(), want, 1e-5)


def test_avgpool2d_matches_jax(rng):
    x = rng.rand(3, 9, 8, 5).astype(np.float32)
    want, _ = JaxAvgPool2d(7, 1).apply({"params": {}, "state": {}},
                                       jnp.asarray(x))
    got = AvgPool2d(7, 1)(_t(x))
    assert got.shape == want.shape == (3, 3, 2, 5)
    _close(got.numpy(), want, 1e-5)


def _lstm_pair(layers=3, d=12, h=8):
    jm = JaxLSTM(d, h, num_layers=layers)
    v = jm.init(0)
    port = LSTM(d, h, num_layers=layers)
    p = v["params"]
    port.load_state_dict({
        f"{kind}_{name}": (_t(p[f"{leaf}_{name}"]).t() if kind == "weight"
                           else _t(p[f"{leaf}_{name}"]))
        for name in (f"{g}_l{l}" for l in range(layers) for g in ("ih", "hh"))
        for kind, leaf in (("weight", "w"), ("bias", "b"))}, strict=True)
    return jm, v, port


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_lstm_matches_jax(rng, bf16):
    """Three layers from a given (h, c), the final state returned."""
    jm, v, port = _lstm_pair()
    x = rng.randn(2, 5, 12).astype(np.float32)
    h0 = rng.randn(3, 2, 8).astype(np.float32) * 0.5
    c0 = rng.randn(3, 2, 8).astype(np.float32) * 0.5
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                           torch.float32)
    policy = DtypePolicy.bf16() if bf16 else DtypePolicy.f32()
    (seq, (h, c)), _ = jm.apply(v, jnp.asarray(x, jdt),
                                initial=(jnp.asarray(h0), jnp.asarray(c0)),
                                return_state=True, policy=policy)
    with torch.no_grad():
        got, (gh, gc) = port(_t(x).to(tdt), initial=(_t(h0), _t(c0)),
                             return_state=True)
    assert got.dtype == gh.dtype == gc.dtype == tdt
    assert got.shape == (2, 5, 8) and gh.shape == gc.shape == (3, 2, 8)
    tol = 2 ** -6 if bf16 else 1e-5
    for g, w in ((got, seq), (gh, h), (gc, c)):
        _close(g.float().numpy(), np.asarray(w, np.float32), tol)


def test_lstm_chunked_equals_whole_run(rng):
    _, _, port = _lstm_pair()
    x = _t(rng.randn(2, 7, 12))
    with torch.no_grad():
        whole, (h, c) = port(x, return_state=True)
        carry, parts = None, []
        for s in range(0, 7, 3):
            part, carry = port(x[:, s:s + 3], initial=carry,
                               return_state=True)
            parts.append(part)
    _close(torch.cat(parts, 1).numpy(), whole.numpy(), 1e-5)
    _close(carry[0].numpy(), h.numpy(), 1e-5)
    _close(carry[1].numpy(), c.numpy(), 1e-5)


@pytest.mark.parametrize("k,stride,se", [(3, 2, True), (5, 1, False)],
                         ids=["k3s2se", "k5s1"])
def test_bottleneck2d_matches_jax(rng, k, stride, se):
    jm = JaxBottleneck2D(8, 16, 24, stride=stride, use_se=se, kernel_size=k,
                         nonlinearity=jax_act.relu)
    v = _perturb_batchnorm(jm.init(0), rng)
    port = port_from_jax("MobileNetSmall2D", v, Bottleneck2D(
        8, 16, 24, stride=stride, use_se=se, kernel_size=k,
        nonlinearity=act.relu)).eval()
    if se:
        assert port.squeeze_excite.se["1"].weight.shape == (6, 24, 1, 1)
    x = rng.rand(2, 14, 14, 8).astype(np.float32)
    want, _ = jm.apply(v, jnp.asarray(x), train=False,
                       policy=DtypePolicy.f32())
    with torch.inference_mode():
        got = port(_t(x))
    assert got.shape == want.shape
    _close(got.numpy(), want, 2e-5)


# --------------------------------------------------------------------------
# the two models
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", MODELS)
def test_parameter_count_and_reference_keys(name):
    _, make, count = MODELS[name]
    m = make(13)
    assert sum(p.numel() for p in m.parameters()) == count
    keys = set(m.state_dict())
    assert {"block1.0.weight", "block1.0.bias", "block1.1.running_mean",
            "lstm.weight_ih_l0", "lstm.weight_hh_l0", "lstm.bias_ih_l0",
            "lstm.bias_hh_l0", "classifier.0.weight",
            "block3.0.squeeze_excite.se.1.weight"} <= keys
    head = ({"block6.0.weight", "block6.0.bias", "block6.1.running_var",
             "lstm.weight_ih_l4"} if name == "MobileNetLarge2D" else
            {"block4.0.weight", "block4.1.se.3.weight", "block4.2.weight"})
    assert head <= keys


@pytest.mark.parametrize("name", MODELS)
def test_state_dict_from_jax_equals_jax_export(name):
    make_jax, make, _ = MODELS[name]
    check_state_dict_equals_jax_export(name, make_jax(13), make(13))


def _jax_logits(jm, v, x, bf16, carry=None):
    policy = DtypePolicy.bf16() if bf16 else DtypePolicy.f32()
    dt = jnp.bfloat16 if bf16 else jnp.float32

    @jax.jit
    def fwd(v, x, carry):
        if carry is None:
            return jm.apply(v, x, train=False, policy=policy)[0]
        return jm.apply(v, x, carry, train=False, policy=policy)[0][0]
    return np.asarray(fwd(v, jnp.asarray(x, dt), carry), np.float32)


@pytest.fixture(scope="module", params=list(MODELS))
def pair(request):
    """(name, JAX model, its variables, the port from them in eval)."""
    name = request.param
    make_jax, make, _ = MODELS[name]
    jm = make_jax(13)
    v = _perturb_batchnorm(jm.init(0), np.random.RandomState(5))
    return name, jm, v, port_from_jax(name, v, make(13)).eval()


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_eval_logits_match_jax(rng, pair, bf16):
    _, jm, v, port = pair
    x = rng.rand(1, 3, *FRAME).astype(np.float32)
    want = _jax_logits(jm, v, x, bf16)
    xt = _t(x).bfloat16() if bf16 else _t(x)
    with torch.inference_mode(), (TorchPolicy.bf16() if bf16
                                  else TorchPolicy.f32()).precision():
        got = port(xt)
    assert got.dtype == xt.dtype and got.shape == (1, 13)
    _close(got.float().numpy(), want, 0.05 if bf16 else 1e-4)


def test_stream_logits_match_jax(rng, pair):
    """One chunk from a given LSTM state, in both packages: logits and
    the carried (h, c)."""
    _, jm, v, port = pair
    x = rng.rand(1, 2, *FRAME).astype(np.float32)
    h0, c0 = (rng.randn(*port.init_stream(1)[0].shape).astype(np.float32)
              * 0.5 for _ in range(2))
    policy = DtypePolicy.f32()
    (want, (wh, wc)), _ = jax.jit(lambda v, x, c: jm.apply(
        v, x, c, train=False, policy=policy))(v, jnp.asarray(x),
                                              (jnp.asarray(h0),
                                               jnp.asarray(c0)))
    with torch.inference_mode():
        got, (gh, gc) = port(_t(x), (_t(h0), _t(c0)))
    for g, w in ((got, want), (gh, wh), (gc, wc)):
        _close(g.numpy(), w, 1e-4)


@pytest.mark.parametrize("chunk", [1, 2, 3])
def test_chunked_equals_whole_clip(rng, pair, chunk):
    """T = 5 in chunks of 1, 2 (a ragged tail of 1) and 3 (tail 2)."""
    _, _, _, port = pair
    x = _t(rng.rand(1, 5, *FRAME))
    with torch.inference_mode():
        whole = port(x)
        carry = port.init_stream(1)
        for s in range(0, 5, chunk):
            logits, carry = port(x[:, s:s + chunk], carry)
    _close(logits.numpy(), whole.numpy(), 1e-4)


def test_init_stream_is_the_zero_lstm_state(pair):
    """(h, c) zeros of (layers, batch, hidden) in the given dtype; the
    frame size, which MoViNetA2Stream's buffers need, is taken and not
    used, so that the server builds every stream model's carry alike."""
    name, _, _, port = pair
    layers, hidden = {"MobileNetLarge2D": (5, 32),
                      "MobileNetSmall2D": (1, 64)}[name]
    for carry in (port.init_stream(2, 224, 224, torch.bfloat16),
                  port.init_stream(2, dtype=torch.bfloat16)):
        assert len(carry) == 2
        for t in carry:
            assert t.shape == (layers, 2, hidden)
            assert t.dtype == torch.bfloat16 and not t.any()


def test_streaming_is_causal(rng, pair):
    """The first chunk's logits do not depend on the frames after it:
    two clips that share their first 2 frames give bit-equal logits."""
    _, _, _, port = pair
    head = rng.rand(1, 2, *FRAME)
    firsts = []
    for _ in range(2):
        x = _t(np.concatenate([head, rng.rand(1, 2, *FRAME)], axis=1))
        with torch.inference_mode():
            firsts.append(port(x[:, :2], port.init_stream(1))[0])
    assert torch.equal(firsts[0], firsts[1])


# --------------------------------------------------------------------------
# train, CLI and serve (MobileNetSmall2D)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def step():
    return train_step_against_jax("MobileNetSmall2D",
                                  jax_m2d.MobileNetSmall2D(13),
                                  MobileNetSmall2D(13), clip=(2,) + FRAME)


def test_train_step_loss_and_grads_match_jax(step):
    check_train_step(*step)


def test_train_mode_batchnorm_statistics_match_jax(step):
    """BatchNorm statistics over all B*T frames of each microbatch."""
    check_train_mode_batchnorm_statistics(step[0], step[1])


def test_cli_trains_on_cpu_and_both_packages_load_the_pth(tmp_path):
    check_cli_trains_and_both_packages_load_the_pth(
        tmp_path, "MobileNetSmall2D", jax_m2d.MobileNetSmall2D(13),
        synthetic_shape=[3, 224, 224], t_bucket=3, max_frames=3)


def write_stream_setup(tmp_path, name, jax_model, port, size, frames=6,
                       seed=0, pth=None):
    """A config (f32, t_bucket = the clip's length), a ``.pth`` (``pth``
    if given, else written by the JAX package from its init with perturbed
    BatchNorm statistics) and a ``frames``-frame mp4 of random pixels
    written with cv2. Returns (config path, .pth path, clip path)."""
    cv2 = pytest.importorskip("cv2")
    cfg = {"model_name": name, "num_classes": 13, "criterion": "CE",
           "use_autocast": False, "batch_size": 1,
           "effective_batch_size": 1, "video_paths": str(tmp_path),
           "data_backend": "synthetic", "synthetic_len": 2,
           "synthetic_shape": [frames, size, size], "t_bucket": frames,
           "max_frames": frames}
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    if pth is None:
        pth = str(tmp_path / "w.pth")
        save_pth(pth, _perturb_batchnorm(jax_model.init(0),
                                         np.random.RandomState(seed)),
                 reverse_map=build_reverse_map(port.state_dict().keys(),
                                               key_map_for(name)),
                 rank_map=export_rank_for(name))
    vid = tmp_path / "c.mp4"
    w = cv2.VideoWriter(str(vid), cv2.VideoWriter_fourcc(*"mp4v"), 30,
                        (size, size))
    rng = np.random.RandomState(seed)
    for _ in range(frames):
        w.write(rng.randint(0, 255, (size, size, 3)).astype(np.uint8))
    w.release()
    return str(cfg_path), pth, str(vid)


def json_lines(capsys):
    return [json.loads(l) for l in capsys.readouterr().out.splitlines()
            if l.startswith("{")]


def check_stream_lines_match_jax(capsys, args, frames):
    """``serve ... --stream`` in both packages: the same lines, the
    confidence (rounded to 4 decimals by both) within one unit of the last
    digit."""
    assert jax_serve.main(args) == 0
    want = json_lines(capsys)
    assert port_serve.main(args + ["--device", "cpu"]) == 0
    got = json_lines(capsys)
    assert [l["frame"] for l in got] == [l["frame"] for l in want] == frames
    for g, w in zip(got, want):
        assert {k: g[k] for k in g if k != "confidence"} == \
            {k: w[k] for k in w if k != "confidence"}
        assert abs(g["confidence"] - w["confidence"]) <= 1e-4
    return got


def test_serve_stream_matches_jax_serve(tmp_path, capsys):
    """``--stream --chunk 2`` on a 6-frame 224x224 mp4; the last line's
    prediction is the whole-clip server's."""
    name = "MobileNetSmall2D"
    cfg, pth, vid = write_stream_setup(
        tmp_path, name, jax_m2d.MobileNetSmall2D(13), MobileNetSmall2D(13),
        224)
    got = check_stream_lines_match_jax(
        capsys, [cfg, "--checkpoint", pth, "--stream", "--chunk", "2", vid],
        [2, 4, 6])
    assert port_serve.main([cfg, "--checkpoint", pth, vid,
                            "--device", "cpu"]) == 0
    whole = json_lines(capsys)[-1]
    assert whole["pred"] == got[-1]["pred"]
    assert abs(whole["confidence"] - got[-1]["confidence"]) <= 1e-4
