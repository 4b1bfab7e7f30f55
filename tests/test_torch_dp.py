"""Port: data parallelism (``parallel/mesh.py``, the DP path of
``train/step.py``, the trainer's ranks) against the JAX package's.

Ranks are subprocesses that join a ``gloo`` group on a port the OS picks
(``spawn_ranks``; each one's ``communicate`` has a timeout, so a hung
rendezvous fails its own test). The JAX side runs in this process on its
8 virtual CPU devices (``tests/conftest.py``).

  * The DP step at 2 ranks, accumulation 2 and ``max_grad_norm`` against
    the JAX ``make_train_step(mesh=make_mesh(data=2))`` on the same
    global batch (rank r takes the r-th half of each microbatch, as the
    mesh's 'data' axis does), 3 f32 steps of MobileNetLarge3D (perturbed
    BatchNorm statistics, 8x64x64 clips, 2 clips per rank) and of a tiny
    model without BatchNorm, dropout p set to 0 on both sides. Bounds,
    those of ``test_torch_train_step.py``: losses within 2e-4, the BatchNorm
    running statistics within 1e-4, the parameters within its one-step
    bound 2 * lr per step taken (a gradient at noise level, such as a bias
    straight before a train-mode BatchNorm, may flip Adam's step of about
    lr * sign(g) at each step); correct counts exact; the two ranks'
    parameters bit-equal.
  * ``ClipDataset(shard, num_shards)`` element for element against the
    JAX one; ``make_sharded_predict_fn`` on two CPU replicas at a ragged
    batch against the JAX sharded predictor and the port's unsharded one;
    the autotuner's broadcast and its -1 sentinel at 2 ranks.
  * ``train()`` at 2 ranks on a synthetic config, ZeRO 0, 1 and 3: the
    ranks end with identical weights, rank 0 alone writes snapshots,
    TensorBoard events and the ``.pth``, the eval counts each val clip of
    a ragged val set once, the snapshot holds full leaves and serves; a
    ZeRO-1 snapshot resumes at 2 ranks with stage 3 exactly as the ZeRO-1
    run continues, and at 1 rank with its moments resharded exactly;
    ``dcn_data_parallel=2`` at 2 ranks equals 1.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from picklebot_tpu.core.module import DtypePolicy, flatten_dict
from picklebot_tpu.models.mobilenet3d import MobileNetLarge3D as JaxLarge3D
from picklebot_tpu.parallel.mesh import make_mesh
from picklebot_tpu.train import optim as jax_optim
from picklebot_tpu.train.step import (create_train_state,
                                      make_train_step as jax_train_step)
from picklebot_tpu_torch.convert import state_dict_from_jax
from test_torch_mobilenet3d import _perturb_batchnorm
from test_torch_train_step import _no_dropout
from test_train_step import TinyNoBNNet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR, WD = 1e-3, 5e-4
# global-norm clips that the first step exceeds (so that it is exercised)
MAX_NORM = {"large3d": 1.0, "tiny": 0.5}
STEPS, A = 3, 2
RANK_TIMEOUT = 300


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(tmp_path, source: str, args=(), world: int = 2,
                timeout: float = RANK_TIMEOUT):
    """Run ``source`` as ``world`` processes, argv = [rank, world, port,
    *args], each with a ``communicate`` timeout (every rank is killed if
    one hangs). Returns their outputs; fails on a non-zero exit."""
    script = tmp_path / f"rank_worker_{abs(hash(source)) % 10**8}.py"
    script.write_text(source)
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world), str(port),
         *map(str, args)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=env, text=True, cwd=str(tmp_path)) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    return outs


# --------------------------------------------------------------------------
# the train step at 2 ranks: the worker runs every job of a job file
# --------------------------------------------------------------------------

STEP_WORKER = r"""
import os, sys
import torch
torch.set_num_threads(1)
rank, world, port, job_path, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                        sys.argv[3], sys.argv[4], sys.argv[5])
from picklebot_tpu_torch.core.policy import DtypePolicy
from picklebot_tpu_torch.models.mobilenet3d import MobileNetLarge3D
from picklebot_tpu_torch.ops.conv import Conv3d
from picklebot_tpu_torch.ops.linear import (ChannelDropout, Dropout,
                                            GlobalAvgPool, Linear)
from picklebot_tpu_torch.parallel import mesh, zero as Z
from picklebot_tpu_torch.train import checkpoint as ckpt
from picklebot_tpu_torch.train.optim import OPTIMIZERS
from picklebot_tpu_torch.train.step import make_train_step

mesh.init_distributed(f"localhost:{port}", backend="gloo", device="cpu",
                      rank=rank, world_size=world)


class Tiny(torch.nn.Module):
    # tests/test_train_step.py TinyNoBNNet: conv, hardswish, pool, dense
    def __init__(self):
        super().__init__()
        self.conv = Conv3d(3, 8, 3, stride=2, padding=1)
        self.pool = GlobalAvgPool()
        self.fc = Linear(8, 13)

    def forward(self, x):
        x = self.conv(x)
        x = x * (torch.clamp(x + 3.0, 0.0, 6.0) * (1.0 / 6.0))
        return self.fc(self.pool(x))


jobs = torch.load(job_path, weights_only=False)
for name, job in jobs.items():
    model = Tiny() if job["model"] == "tiny" else MobileNetLarge3D(13)
    model.load_state_dict(job["weights"])
    for m in model.modules():
        if isinstance(m, (Dropout, ChannelDropout)):
            m.p = 0.0
    cls, kw = OPTIMIZERS[job["optimizer"]], dict(job["opt_kw"])
    lay = None
    if job["zero"]:
        lay = Z.ZeroLayout(model, world, rank, job["zero"])
        opt = Z.zero_optimizer(cls, lay, **kw)
    else:
        opt = cls(model.parameters(), **kw)
    policy = (DtypePolicy.bf16() if job.get("bf16") else DtypePolicy.f32())
    step = make_train_step(model, opt, "CE", lambda e: job["lr"], policy,
                           max_grad_norm=job["max_grad_norm"], device="cpu",
                           zero=lay)
    feats, labels = job["feats"], job["labels"]
    b = feats.shape[2] // world
    out = {"loss": [], "correct": [], "grad_norm": [], "samples": []}
    mesh.reset_counts()
    for s in range(feats.shape[0]):
        m = step(0, feats[s][:, rank * b:(rank + 1) * b],
                 labels[s][:, rank * b:(rank + 1) * b], s * feats.shape[1])
        out["loss"].append(m["loss"].numpy().copy())
        out["correct"].append(m["correct"].numpy().copy())
        out["samples"].append(m["samples"])
        if "grad_norm" in m:
            out["grad_norm"].append(float(m["grad_norm"]))
        if job.get("every_step"):
            out.setdefault("states", []).append(
                {k: v.clone() for k, v in model.state_dict().items()})
    out["counts"] = mesh.counts()
    snap = ckpt.snapshot(model, opt, None, 0, [0, 0], [0, 0, 0], zero=lay)
    out["model"], out["optimizer"] = snap["model"], snap["optimizer"]
    torch.save(out, os.path.join(out_dir, f"{name}_{rank}.pt"))
print(f"RANK{rank} STEPS OK")
"""


def run_step_jobs(tmp_path, jobs, world=2):
    """Each job at ``world`` gloo ranks (one spawn for all): {name: [rank
    0's results, rank 1's, ...]}."""
    job_path = tmp_path / "jobs.pt"
    torch.save(jobs, job_path)
    outs = spawn_ranks(tmp_path, STEP_WORKER, (job_path, tmp_path), world)
    for r, out in enumerate(outs):
        assert f"RANK{r} STEPS OK" in out, out[-2000:]
    return {name: [torch.load(tmp_path / f"{name}_{r}.pt",
                              weights_only=False) for r in range(world)]
            for name in jobs}


def tiny_torch_weights(params) -> dict:
    """TinyNoBNNet's JAX params -> the worker's ``Tiny`` state dict."""
    p = {k: np.asarray(v) for k, v in flatten_dict(params).items()}
    return {"conv.weight": torch.tensor(np.transpose(p["conv.w"],
                                                     (4, 3, 0, 1, 2))),
            "conv.bias": torch.tensor(p["conv.b"]),
            "fc.weight": torch.tensor(p["fc.w"].T.copy()),
            "fc.bias": torch.tensor(p["fc.b"])}


def large3d_variables(rng):
    jm = JaxLarge3D(13)
    v = _perturb_batchnorm(jm.init(0), rng)
    return jm, v


def jax_dp_steps(jm, variables, feats, labels, opt, zero_degree=0,
                 zero_stage=1, max_grad_norm=None):
    """The JAX sharded step over ``make_mesh(data=2)``, ``len(feats)``
    steps: per step (loss, correct, grad norm or None, params, model
    state, optimizer state), params full (stage-3 rank stacks unsharded)."""
    from picklebot_tpu.parallel import zero as jz
    mesh = make_mesh(data=2, devices=jax.devices()[:2])
    state = create_train_state(jm, opt, 0, zero_degree=zero_degree)
    state = state._replace(params=variables["params"],
                           model_state=variables["state"])
    specs = tmpl = None
    if zero_degree > 1:
        if zero_stage == 3:
            tmpl = jz.param_templates(state.params)
            specs = jz.zero3_state_specs(state)
            state = state._replace(
                params=jz.zero3_shard_params(state.params, zero_degree))
        else:
            specs = jz.zero_state_specs(state)
    step = jax_train_step(jm, opt, "CE",
                          lambda e: jnp.asarray(LR, jnp.float32),
                          policy=DtypePolicy.f32(), mesh=mesh, donate=False,
                          state_specs=specs, zero_degree=zero_degree,
                          zero_stage=zero_stage, zero3_templates=tmpl,
                          max_grad_norm=max_grad_norm)
    out = []
    for s in range(len(feats)):
        state, m = step(state, jnp.asarray(feats[s]),
                        jnp.asarray(labels[s], jnp.int32),
                        jax.random.key(s))
        params = jax.device_get(state.params)
        if zero_stage == 3 and zero_degree > 1:
            params = jz.zero3_unshard_params(params, tmpl)
        out.append((np.asarray(m["loss"]), np.asarray(m["correct"]),
                    float(m["grad_norm"]) if "grad_norm" in m else None,
                    params, jax.device_get(state.model_state),
                    jax.device_get(state.opt_state)))
    return out


def _is_stat(key):
    return key.endswith(("running_mean", "running_var",
                         "num_batches_tracked"))


def one_process_emulation(weights, feats, labels, max_grad_norm, world=2):
    """The DP step's semantics in one process (the port's plain f32 path):
    each rank's microbatches in turn, from its own copy of the BatchNorm
    buffers; then the gradients summed over the ranks / world, the
    buffers averaged, the losses averaged, one clip and one AdamW update.
    Per step: (losses, the state dict)."""
    from picklebot_tpu_torch.core.policy import DtypePolicy as TorchPolicy
    from picklebot_tpu_torch.models.mobilenet3d import MobileNetLarge3D
    from picklebot_tpu_torch.train.optim import AdamW
    from picklebot_tpu_torch.train.step import make_train_step
    model = MobileNetLarge3D(13)
    model.load_state_dict(weights)
    _no_dropout(jax_model_stub(), model)
    opt = AdamW(model.parameters(), weight_decay=WD)
    params = [p for p in model.parameters()]
    stats = [k for k, _ in model.named_buffers() if _is_stat(k)]
    buffers = [{k: b.clone() for k, b in model.named_buffers()}
               for _ in range(world)]
    noop = type("NoUpdate", (), {"step": lambda self, lr: None})()
    local = make_train_step(model, noop, "CE", lambda e: LR,
                            TorchPolicy.f32(), device="cpu")
    b = feats.shape[2] // world
    out = []
    for s in range(len(feats)):
        grads, losses = None, None
        for r in range(world):
            model.load_state_dict(buffers[r], strict=False)
            m = local(0, feats[s][:, r * b:(r + 1) * b],
                      labels[s][:, r * b:(r + 1) * b], s * feats.shape[1])
            buffers[r] = {k: v.clone() for k, v in model.named_buffers()}
            g = [p.grad.clone() for p in params]
            grads = g if grads is None else [x + y for x, y in zip(grads, g)]
            losses = m["loss"] if losses is None else losses + m["loss"]
        with torch.no_grad():
            for p, g in zip(params, grads):
                p.grad = g / world
            norm = torch.sqrt(sum(p.grad.pow(2).sum() for p in params))
            scale = torch.clamp(max_grad_norm / (norm + 1e-6), max=1.0)
            for p in params:
                p.grad.mul_(scale)
            opt.step(LR)
            merged = {k: (sum(bf[k] for bf in buffers) / world
                          if not k.endswith("num_batches_tracked")
                          else buffers[0][k]) for k in stats}
            buffers = [dict(merged) for _ in range(world)]
            model.load_state_dict(merged, strict=False)
        out.append((losses / world,
                    {k: v.clone() for k, v in model.state_dict().items()}))
    return out


def jax_model_stub():
    """An empty JAX-side module for ``_no_dropout`` (port side only)."""
    from picklebot_tpu.core.module import Module
    return Module()


@pytest.fixture(scope="module")
def dp_steps(tmp_path_factory):
    """The JAX references and the port's 2-rank runs of both models."""
    tmp = tmp_path_factory.mktemp("dp_steps")
    rng = np.random.RandomState(1234)
    jm, v = large3d_variables(rng)
    _no_dropout(jm, torch.nn.Module())
    large_feats = rng.randint(0, 256, (STEPS, A, 4, 8, 64, 64, 3)
                              ).astype(np.uint8)
    large_labels = rng.randint(0, 13, (STEPS, A, 4))
    tiny = TinyNoBNNet()
    tv = tiny.init(jax.random.key(0))
    tiny_feats = rng.randint(0, 256, (STEPS, A, 8, 4, 16, 16, 3)
                             ).astype(np.uint8)
    tiny_labels = rng.randint(0, 13, (STEPS, A, 8))
    large_sd = state_dict_from_jax(flatten_dict(v["params"]),
                                   flatten_dict(v["state"]),
                                   "MobileNetLarge3D")
    runs = {"large3d": (jm, v, large_feats, large_labels, large_sd),
            "tiny": (tiny, tv, tiny_feats, tiny_labels,
                     tiny_torch_weights(tv["params"]))}
    want, jobs = {}, {}
    for name, (model, variables, feats, labels, sd) in runs.items():
        steps = jax_dp_steps(model, variables, feats, labels,
                             jax_optim.AdamW(weight_decay=WD),
                             max_grad_norm=MAX_NORM[name])
        want[name] = []
        for loss, correct, norm, params, state, _ in steps:
            if name == "large3d":
                msd = state_dict_from_jax(flatten_dict(params),
                                          flatten_dict(state),
                                          "MobileNetLarge3D")
            else:
                msd = tiny_torch_weights(params)
            want[name].append({"loss": loss, "correct": correct,
                               "grad_norm": norm, "model": msd})
        jobs[name] = dict(model=name, weights=sd, optimizer="adamw",
                          opt_kw={"weight_decay": WD}, zero=0, lr=LR,
                          max_grad_norm=MAX_NORM[name], feats=feats,
                          labels=labels, every_step=True)
    emulated = one_process_emulation(large_sd, large_feats, large_labels,
                                     MAX_NORM["large3d"])
    return want, run_step_jobs(tmp, jobs), emulated


@pytest.mark.parametrize("name", ["large3d", "tiny"])
def test_dp_step_losses_and_corrects_match_jax(dp_steps, name):
    """Every step's losses for the model without BatchNorm; the first
    step's for Large3D, whose later steps carry Adam's sign noise through
    batch-2 train-mode BatchNorms (held to the one-process emulation
    below instead)."""
    want, got, _ = dp_steps
    held = STEPS if name == "tiny" else 1
    for r in range(2):
        res = got[name][r]
        np.testing.assert_allclose(
            np.stack(res["loss"][:held]),
            np.stack([w["loss"] for w in want[name][:held]]),
            rtol=2e-4, atol=2e-4)
        np.testing.assert_array_equal(
            np.stack(res["correct"][:held]),
            np.stack([w["correct"] for w in want[name][:held]]))
        # the global batch's samples, every rank's share counted
        b = 4 if name == "large3d" else 8
        assert res["samples"] == [float(A * b)] * STEPS
    # the first step's global norm, within the train-step test's gradient
    # bound (1e-3 of the largest); the clip was exercised
    np.testing.assert_allclose(got[name][0]["grad_norm"][0],
                               want[name][0]["grad_norm"], rtol=1e-3)
    assert want[name][0]["grad_norm"] > MAX_NORM[name]


@pytest.mark.parametrize("name", ["large3d", "tiny"])
def test_dp_step_weights_match_jax_and_ranks_agree(dp_steps, name):
    """The ranks' states bit-equal after every step; the parameters within
    2 * lr of JAX after the first step and within 2 * lr * 3 after the
    third."""
    want, got, _ = dp_steps
    for s in range(STEPS):
        r0, r1 = got[name][0]["states"][s], got[name][1]["states"][s]
        assert r0.keys() == r1.keys()
        for key in r0:
            assert torch.equal(r0[key], r1[key]), (s, key)
    params = [k for k in want[name][0]["model"] if not _is_stat(k)]
    assert params
    for s in (0, STEPS - 1):
        for key in params:
            np.testing.assert_allclose(
                got[name][0]["states"][s][key].numpy(),
                want[name][s]["model"][key].numpy(), rtol=0,
                atol=2 * LR * (s + 1), err_msg=f"step {s + 1} {key}")


def test_dp_step_batchnorm_statistics_match_jax(dp_steps):
    """The averaged running statistics after the first step (computed from
    the identical initial weights) within 1e-4 of the JAX pmean."""
    want, got, _ = dp_steps
    r0 = got["large3d"][0]["states"][0]
    stats = [k for k in want["large3d"][0]["model"]
             if k.endswith(("running_mean", "running_var"))]
    assert stats
    for key in stats:
        np.testing.assert_allclose(r0[key].numpy(),
                                   want["large3d"][0]["model"][key].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=key)
        tracked = key.rsplit(".", 1)[0] + ".num_batches_tracked"
        assert int(r0[tracked]) == A


def test_dp_step_equals_the_one_process_emulation(dp_steps):
    """Large3D's three 2-rank steps against the same semantics run in one
    process: losses, weights and BatchNorm buffers bit-equal."""
    _, got, emulated = dp_steps
    res = got["large3d"][0]
    for s, (losses, state) in enumerate(emulated):
        assert torch.equal(torch.as_tensor(res["loss"][s]), losses), s
        for key, value in state.items():
            assert torch.equal(res["states"][s][key], value), (s, key)


# --------------------------------------------------------------------------
# ClipDataset shards
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backend,n,shards", [
    ("synthetic", 11, 2), ("synthetic_learnable", 13, 3),
    ("synthetic", 8, 4)])
def test_clip_dataset_shards_match_jax(backend, n, shards):
    from picklebot_tpu.data.dataset import ClipDataset as JaxClipDataset
    from picklebot_tpu_torch.data.dataset import ClipDataset
    kw = dict(backend=backend, synthetic_shape=(5, 8, 8), synthetic_len=n,
              synthetic_classes=4)
    seen = []
    for r in range(shards):
        got = ClipDataset("", "", shard=r, num_shards=shards, **kw)
        want = JaxClipDataset("", "", shard=r, num_shards=shards, **kw)
        assert len(got) == len(want) == n // shards
        assert got.filenames == want.filenames
        for i in range(len(got)):
            (gc, gl), (wc, wl) = got[i], want[i]
            assert gl == wl
            np.testing.assert_array_equal(gc, wc)
        seen += got.filenames
    assert len(set(seen)) == len(seen)


# --------------------------------------------------------------------------
# the sharded predictor
# --------------------------------------------------------------------------

def test_sharded_predict_matches_jax_and_the_unsharded_predictor():
    from picklebot_tpu.train.step import \
        make_sharded_predict_fn as jax_sharded
    from picklebot_tpu_torch.core.policy import DtypePolicy as TorchPolicy
    from picklebot_tpu_torch.models.mobilenet3d import MobileNetLarge3D
    from picklebot_tpu_torch.ops import fused_bottleneck as fb
    from picklebot_tpu_torch.train.step import (make_predict_fn,
                                                make_sharded_predict_fn)
    rng = np.random.RandomState(5)
    jm, v = large3d_variables(rng)
    port = MobileNetLarge3D(13)
    port.load_state_dict(state_dict_from_jax(
        flatten_dict(v["params"]), flatten_dict(v["state"]),
        "MobileNetLarge3D"))
    feats = rng.randint(0, 256, (5, 8, 32, 32, 3)).astype(np.uint8)
    fb.LAUNCHES.update(dict.fromkeys(fb.LAUNCHES, 0))
    got = make_sharded_predict_fn(port, ["cpu", "cpu"], TorchPolicy.f32())(
        feats)
    assert fb.LAUNCHES == {"pool": 0, "main": 0, "dw_stencil": 0,
                           "dw_dgrad": 0, "dw_wgrad": 0}   # CPU: no kernel
    assert got.shape == (5, 13)
    single = make_predict_fn(port, TorchPolicy.f32(), device="cpu")(feats)
    np.testing.assert_allclose(got, single, rtol=1e-5, atol=1e-5)
    # the JAX sharded predictor over 2 devices, the batch padded to 6
    mesh = make_mesh(data=2, devices=jax.devices()[:2])
    padded = np.concatenate([feats, np.zeros_like(feats[:1])])
    want = np.asarray(jax_sharded(jm, mesh, DtypePolicy.f32())(
        v, jnp.asarray(padded)))[:5]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------
# the autotuner's broadcast
# --------------------------------------------------------------------------

AUTOTUNE_WORKER = r"""
import sys
import torch
rank, world, port, mode = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
from picklebot_tpu_torch.parallel import mesh
from picklebot_tpu_torch.utils import autotune as at
from picklebot_tpu_torch.utils.config import Config
mesh.init_distributed(f"localhost:{port}", backend="gloo", device="cpu",
                      rank=rank, world_size=world)
calls = []


def fake(config, mode="train", device="cuda", **kw):
    calls.append(1)
    if sys.argv[4] == "fail":
        raise RuntimeError("every candidate failed")
    return True


at.autotune = fake
at.candidates = lambda: [False, True]
cfg = Config(model_name="MobileNetSmall3D", autotune=True).validate()
try:
    tuned, flag = at.autotune_config(cfg, "train", device="cpu")
except RuntimeError as e:
    print(f"RANK{rank} RAISED {e} calls={len(calls)}")
else:
    assert tuned.autotune is False
    print(f"RANK{rank} FLAG {flag} calls={len(calls)}")
"""


@pytest.mark.parametrize("mode", ["ok", "fail"])
def test_autotune_broadcasts_rank_zeros_winner(tmp_path, mode):
    outs = spawn_ranks(tmp_path, AUTOTUNE_WORKER, (mode,), timeout=120)
    if mode == "ok":
        # rank 1 applies rank 0's winner and measures nothing itself
        assert "RANK0 FLAG True calls=1" in outs[0], outs[0][-2000:]
        assert "RANK1 FLAG True calls=0" in outs[1], outs[1][-2000:]
    else:
        # the -1 sentinel: rank 0 raises its own error, rank 1 a RuntimeError
        assert "RANK0 RAISED every candidate failed calls=1" in outs[0], \
            outs[0][-2000:]
        assert "RANK1 RAISED autotune failed on rank 0" in outs[1], \
            outs[1][-2000:]


# --------------------------------------------------------------------------
# train() at 2 ranks
# --------------------------------------------------------------------------

LOOP_WORKER = r"""
import dataclasses, json, os, sys
import torch
torch.set_num_threads(1)
rank, world, port, cfg_path, tag = (int(sys.argv[1]), int(sys.argv[2]),
                                    sys.argv[3], sys.argv[4], sys.argv[5])
no_dropout = sys.argv[6:] == ["no_dropout"]
from picklebot_tpu_torch.ops.linear import ChannelDropout, Dropout
from picklebot_tpu_torch.parallel import mesh
from picklebot_tpu_torch.parallel import zero as zero_mod
from picklebot_tpu_torch.train import loop
from picklebot_tpu_torch.train.loop import train
from picklebot_tpu_torch.utils.config import load_config

# the run's model and ZeRO layout, kept to read this rank's final weights
made = {}
real_model, real_layout = loop.initialize_model, loop.zero_mod.ZeroLayout


def model_(c):
    made["model"] = real_model(c)
    for m in made["model"].modules():
        if no_dropout and isinstance(m, (Dropout, ChannelDropout)):
            m.p = 0.0
    return made["model"]


loop.initialize_model = model_
loop.zero_mod.ZeroLayout = lambda *a, **k: made.setdefault(
    "zero", real_layout(*a, **k))
if world > 1:
    mesh.init_distributed(f"localhost:{port}", backend="gloo", device="cpu",
                          rank=rank, world_size=world)
cfg = load_config(cfg_path)
root = os.path.abspath(f"{tag}_rank{rank}")
os.makedirs(root, exist_ok=True)
os.chdir(root)
cfg = dataclasses.replace(cfg, checkpoint_dir=os.path.join(root, "ck"),
                          log_dir=os.path.join(root, "runs"))
summary = train(cfg, device="cpu")
with zero_mod.gathered(made.get("zero")):
    torch.save({k: v.clone() for k, v in made["model"].state_dict().items()},
               os.path.join(root, "final_weights.pt"))
with open(os.path.join(root, "summary.json"), "w") as f:
    json.dump({k: summary[k] for k in ("val_samples", "global_step",
                                       "train_losses", "val_losses")}, f)
print(f"RANK{rank} LOOP OK")
"""

LOOP_CFG = {"model_name": "MobileNetLarge3D", "num_classes": 13,
            "criterion": "CE", "use_autocast": False, "batch_size": 2,
            "effective_batch_size": 4, "max_iters": 2, "eval_interval": 1,
            "data_backend": "synthetic", "synthetic_len": 22,
            "synthetic_shape": [8, 32, 32], "t_bucket": 4, "max_frames": 8,
            "num_workers": 1, "optimizer": "adamw", "learning_rate": 1e-3,
            "weight_decay": 5e-4, "seed": 3}


def run_loop(tmp_path, tag, world=2, **extra):
    """train() at ``world`` ranks on LOOP_CFG + ``extra``, each rank in
    its own directory (``<tag>_rank<r>``, with its own checkpoint_dir and
    log_dir, so that what each rank writes can be told apart)."""
    cfg = tmp_path / f"{tag}.json"
    cfg.write_text(json.dumps({**LOOP_CFG, **extra}))
    outs = spawn_ranks(tmp_path, LOOP_WORKER, (cfg, tag), world=world)
    for r, out in enumerate(outs):
        assert f"RANK{r} LOOP OK" in out, out[-3000:]
    return outs


def _snapshot_path(tmp_path, tag, name):
    return (tmp_path / f"{tag}_rank0" / "ck" / "MobileNetLarge3D" / name)


def _finished(tmp_path, tag, rank=0):
    return (tmp_path / f"{tag}_rank{rank}" / "ck"
            / "MobileNetLarge3D_CrossEntropyLoss()_finished" / "step_2")


@pytest.fixture(scope="module")
def loops(tmp_path_factory):
    """2-rank train() at ZeRO 0, 1 and 3, each rank saving its final
    weights beside the run."""
    tmp = tmp_path_factory.mktemp("dp_loops")
    outs = {z: run_loop(tmp, f"zero{z}", zero_sharding=z) for z in (0, 1, 3)}
    return tmp, outs


def _final_weights(tmp, tag):
    from picklebot_tpu_torch.train import checkpoint as ckpt
    return ckpt.load_checkpoint(str(_finished(tmp, tag)))["model"]


@pytest.mark.parametrize("zero", [0, 1, 3])
def test_loop_rank0_alone_writes_and_eval_counts_every_clip(loops, zero):
    tmp, _ = loops
    tag = f"zero{zero}"
    r0, r1 = tmp / f"{tag}_rank0", tmp / f"{tag}_rank1"
    snaps = sorted(os.listdir(r0 / "ck" / "MobileNetLarge3D"))
    assert snaps == ["step_0", "step_1"]
    assert os.listdir(r0 / "runs" / "MobileNetLarge3D_CrossEntropyLoss()")
    assert (r0 / "ck" / "MobileNetLarge3D_CrossEntropyLoss()_finished.pth"
            ).exists()
    assert (r0 / "statistics").is_dir()
    # rank 1 writes nothing: no snapshot, events, .pth or statistics
    assert not os.path.exists(r1 / "ck" / "MobileNetLarge3D")
    assert not os.path.exists(r1 / "runs")
    assert not os.path.exists(r1 / "statistics")
    for r in (r0, r1):
        s = json.loads((r / "summary.json").read_text())
        # 22 val clips, 11 per rank in batches of 2, the last one padded:
        # the whole set once
        assert s["val_samples"] == 22.0
        # 11 train clips per rank: 5 whole batches, 2 optimizer steps of 2
        # microbatches per epoch
        assert s["global_step"] == 8
    s0, s1 = (json.loads((r / "summary.json").read_text()) for r in (r0, r1))
    assert s0["train_losses"] == s1["train_losses"]
    assert s0["val_losses"] == s1["val_losses"]


def test_loop_ranks_end_with_identical_weights(loops):
    """Each rank's own final weights (gathered at ZeRO-3) are bit-equal,
    equal to rank 0's final snapshot, and ZeRO-1 and ZeRO-3 train the
    same weights as plain DP in f32, bit for bit."""
    tmp, _ = loops
    w = {}
    for z in (0, 1, 3):
        ranks = [torch.load(tmp / f"zero{z}_rank{r}" / "final_weights.pt")
                 for r in (0, 1)]
        snap = _final_weights(tmp, f"zero{z}")
        for key in snap:
            assert torch.equal(ranks[0][key], ranks[1][key]), (z, key)
            assert torch.equal(ranks[0][key], snap[key]), (z, key)
        w[z] = snap
    for z in (1, 3):
        assert w[z].keys() == w[0].keys()
        for key in w[0]:
            assert torch.equal(w[z][key], w[0][key]), (z, key)


@pytest.mark.parametrize("zero", [1, 3])
def test_loop_snapshot_holds_full_leaves_and_serves(loops, zero, capsys):
    from picklebot_tpu_torch import serve
    from picklebot_tpu_torch.models.mobilenet3d import MobileNetLarge3D
    from picklebot_tpu_torch.parallel.zero import zero_degree_of
    from picklebot_tpu_torch.train import checkpoint as ckpt
    tmp, _ = loops
    path = _snapshot_path(tmp, f"zero{zero}", "step_1")
    payload = ckpt.load_checkpoint(str(path))
    model = MobileNetLarge3D(13)
    model.load_state_dict(payload["model"], strict=True)
    assert zero_degree_of(payload["optimizer"]) == 2
    cfg = tmp / f"zero{zero}.json"
    rc = serve.main([str(cfg), "--checkpoint", str(path), "--csv", "x",
                     "--limit", "4", "--batch", "2", "--device", "cpu"])
    assert rc == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last)["evaluated"] == 4


def test_loop_zero1_snapshot_resumes_at_stage3_and_at_one_rank(loops):
    """ZeRO-1's epoch-0 snapshot resumed at 2 ranks with stage 3 ends bit
    for bit where the ZeRO-1 run ended (the optimizer state resharded
    nowhere, the parameters sharded and gathered exactly); at 1 rank the
    moments are resharded to the replicated layout exactly (f32) and the
    run goes on from them."""
    from picklebot_tpu_torch.parallel.zero import zero_reshard
    from picklebot_tpu_torch.train import checkpoint as ckpt
    from picklebot_tpu_torch.train.optim import AdamW
    tmp, _ = loops
    start = str(_snapshot_path(tmp, "zero1", "step_0"))
    run_loop(tmp, "resume3", zero_sharding=3, checkpoint=start)
    a = ckpt.load_checkpoint(str(_finished(tmp, "zero1")))
    b = ckpt.load_checkpoint(str(_finished(tmp, "resume3")))
    for key in a["model"]:
        assert torch.equal(a["model"][key], b["model"][key]), key
    for part in ("m", "v"):
        for x, y in zip(a["optimizer"][part], b["optimizer"][part]):
            assert torch.equal(x, y)
    assert a["optimizer"]["steps"] == b["optimizer"]["steps"] == 4

    outs = run_loop(tmp, "resume1", world=1, zero_sharding=1,
                    checkpoint=start)
    assert "Resharding optimizer state: ZeRO degree 2 -> 0" in outs[0]
    saved = ckpt.load_checkpoint(start)["optimizer"]
    flat = zero_reshard(AdamW([]), saved, 0)
    for x, shape, full in zip(saved["m"], saved["shapes"], flat["m"]):
        n = int(np.prod(shape))
        assert torch.equal(x.reshape(-1)[:n], full.reshape(-1))
    c = ckpt.load_checkpoint(str(_finished(tmp, "resume1")))
    # 2 saved + epoch 1 at one rank: 22 clips, 11 batches, 5 steps
    assert c["optimizer"]["steps"] == 2 + 5
    assert [tuple(m.shape) for m in c["optimizer"]["m"]] == \
        [tuple(s) for s in c["optimizer"]["shapes"]]


def test_loop_dcn_data_parallel_2_equals_1(loops):
    tmp, _ = loops
    run_loop(tmp, "dcn2", dcn_data_parallel=2, data_parallel=2)
    a, b = _final_weights(tmp, "zero0"), _final_weights(tmp, "dcn2")
    for key in a:
        assert torch.equal(a[key], b[key]), key


def test_loop_refuses_a_data_parallel_other_than_the_world():
    from picklebot_tpu_torch.train.loop import train
    from picklebot_tpu_torch.utils.config import Config
    with pytest.raises(ValueError, match="data_parallel=2 but the process "
                                         "group has 1 rank"):
        train(Config(model_name="MobileNetLarge3D", data_parallel=2),
              device="cpu")


# --------------------------------------------------------------------------
# slow: the port's 2-rank loop against the JAX package's 2-process loop
# --------------------------------------------------------------------------

JAX_LOOP_WORKER = r"""
import json, os, sys
import jax
jax.config.update("jax_platforms", "cpu")
rank, world, port, cfg_path, out = (int(sys.argv[1]), int(sys.argv[2]),
                                    sys.argv[3], sys.argv[4], sys.argv[5])
jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                           num_processes=world, process_id=rank)
from picklebot_tpu.ops import linear
from picklebot_tpu.train import loop
from picklebot_tpu.train.loop import train
from picklebot_tpu.utils.config import load_config

real_model = loop.initialize_model


def model_(c):
    # dropout p 0, as the port's side (the two draw different masks)
    model = real_model(c)
    todo = [model]
    while todo:
        m = todo.pop()
        if isinstance(m, (linear.Dropout, linear.ChannelDropout)):
            m.p = 0.0
        todo.extend(m.named_children().values())
    return model


loop.initialize_model = model_
os.chdir(os.path.dirname(cfg_path))
summary = train(load_config(cfg_path))
if rank == 0:
    with open(out, "w") as f:
        json.dump(summary["train_losses"], f)
print(f"RANK{rank} JAXLOOP OK")
"""


@pytest.mark.slow
def test_port_two_rank_loop_matches_the_jax_two_process_loop(tmp_path,
                                                             monkeypatch):
    """Loss for loss, one device per process on both sides: the JAX loop
    at ``--xla_force_host_platform_device_count=1`` per process (as
    ``tests/test_multihost.py`` builds it) and the port's at 2 gloo ranks,
    from the same initial weights (the JAX loop's seed-0 init, written as
    a .pth warm start for both), dropout p set to 0 on both sides."""
    jm = JaxLarge3D(13)
    v = jm.init(0)
    sd = state_dict_from_jax(flatten_dict(v["params"]),
                             flatten_dict(v["state"]), "MobileNetLarge3D")
    pth = tmp_path / "init.pth"
    torch.save(sd, pth)
    cfg = dict(LOOP_CFG, max_iters=1, checkpoint=str(pth), warm_start=True,
               optimizer="adamw", checkpoint_dir=str(tmp_path / "jck"),
               log_dir=str(tmp_path / "jruns"))
    path = tmp_path / "jax.json"
    path.write_text(json.dumps(cfg))
    monkeypatch.setenv("XLA_FLAGS",
                       "--xla_force_host_platform_device_count=1")
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    spawn_ranks(tmp_path, JAX_LOOP_WORKER, (path, tmp_path / "jax_losses"),
                timeout=900)
    want = json.loads((tmp_path / "jax_losses").read_text())
    port_cfg = tmp_path / "port.json"
    port_cfg.write_text(json.dumps(cfg))
    spawn_ranks(tmp_path, LOOP_WORKER, (port_cfg, "port", "no_dropout"))
    got = json.loads((tmp_path / "port_rank0" / "summary.json").read_text())
    np.testing.assert_allclose(got["train_losses"], want, rtol=2e-4,
                               atol=2e-4)
