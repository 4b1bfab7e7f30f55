"""Port: tensor parallelism (``parallel/megatron.py``, the 'model' axis of
``parallel/mesh.py``, MobileViT's sharded FeedForward, the TP step, its
snapshots and ``.pth``) against the JAX package's sharded functions.

Ranks are gloo subprocesses on the CPU (``test_torch_dp.spawn_ranks``),
laid out as the JAX mesh (``mesh.init_mesh``: data-major, 'model'
innermost), so rank r holds what device r of ``make_mesh`` holds. The JAX
side runs in this process on its 8 virtual CPU devices
(``tests/conftest.py``), with the same seeded numpy inputs and the same
weights (JAX ``init``, carried across by the key map of the JAX tests'
``TinyTransformer`` or ``state_dict_from_jax``, then cut by
``shard_state_dict``). Each spawn runs a job file (``LAYOUT_WORKER``), so
a handful of spawns serve every case.

Tolerances are the JAX tests' own (``tests/test_tensor_parallel.py``):
losses rtol/atol 1e-5 (8-bit 5e-4), parameters after Adam steps rtol 1e-4
atol 3e-3 (8-bit 1e-3 / 5e-3; Adam's 1/(sqrt(v)+eps) amplifies reduction-
order noise where v ~ 0), gradients rtol 1e-5 atol 1e-6, eval loss 1e-5
and the correct count exact. Clipping is on in every train step.
"""

import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from picklebot_tpu.core.module import DtypePolicy, Module, flatten_dict
from picklebot_tpu.models.mobilevit import (MobileViT as JaxMobileViT,
                                            TransformerStack as JaxStack)
from picklebot_tpu.ops.linear import Dense
from picklebot_tpu.parallel.mesh import (MOBILEVIT_TP_RULES, make_mesh,
                                         param_specs, train_state_specs)
from picklebot_tpu.train.optim import AdamW, AdamW8bit, cosine_annealing_lr
from picklebot_tpu.train.step import (create_train_state, make_eval_step,
                                      make_train_step)
from picklebot_tpu_torch.convert import state_dict_from_jax
from test_sequence_parallel import TinyTransformer as JaxTiny
from test_torch_dp import spawn_ranks
from test_torch_train_step import _no_dropout

LR, WD = 1e-3, 1e-4
MAX_NORM = 0.05       # below the first step's global norm: the clip engages
VIT_ARCH = dict(dims=[16, 16, 16],
                channels=[8, 8, 8, 8, 16, 16, 16, 16, 16, 16, 32],
                depths=(1, 1, 1))
VIT_CLIP = (8, 64, 64, 3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------------------
# the rank worker: every job of a job file, at the file's mesh
# --------------------------------------------------------------------------

LAYOUT_WORKER = r"""
import os, sys
import numpy as np
import torch
torch.set_num_threads(1)
rank, world, port, job_path, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                        sys.argv[3], sys.argv[4], sys.argv[5])
from picklebot_tpu_torch.convert import shard_state_dict
from picklebot_tpu_torch.core.policy import DtypePolicy
from picklebot_tpu_torch.models.mobilevit import MobileViT, TransformerStack
from picklebot_tpu_torch.ops.linear import ChannelDropout, Dropout, Linear
from picklebot_tpu_torch.ops.ring_attention import ring_attention
from picklebot_tpu_torch.parallel import mesh
from picklebot_tpu_torch.parallel.megatron import (gather_tensor, layout,
                                                   tp_copy_in, tp_reduce_out)
from picklebot_tpu_torch.train.checkpoint import full_state_dict
from picklebot_tpu_torch.train.losses import cross_entropy
from picklebot_tpu_torch.train.optim import OPTIMIZERS, cosine_annealing_lr
from picklebot_tpu_torch.train.step import make_eval_step, make_train_step

mesh.init_distributed(f"localhost:{port}", backend="gloo", device="cpu",
                      rank=rank, world_size=world)
spec = torch.load(job_path, weights_only=False)
shape = mesh.init_mesh(**spec["mesh"])
MP, SP, ND = shape["model"], shape["seq"], shape["data"]
MR, SR, DR = (mesh.axis_index(a) for a in ("model", "seq", "data"))
MA = "model" if MP > 1 else None
SA = "seq" if SP > 1 else None


class Tiny(torch.nn.Module):
    # the JAX tests' TinyTransformer: embed, TransformerStack, mean, head
    def __init__(self, width=32, heads=4, dim_head=8, depth=2,
                 backend="xla", dropout=0.0, tokens_in=48):
        super().__init__()
        self.tokens_in = tokens_in
        self.embed = Linear(tokens_in, width)
        self.transformer = TransformerStack(width, depth, heads, dim_head,
                                            64, dropout, backend, MA, SA)
        self.head = Linear(width, 13)

    def forward(self, x):
        tokens = x.reshape(x.shape[0], -1, self.tokens_in)
        return self.head(self.transformer(self.embed(tokens)).mean(dim=1))


def build(job):
    if job["model"] == "mobilevit":
        m = MobileViT(num_classes=13, attention_backend="xla",
                      model_axis=MA, sequence_axis=SA, **job["arch"])
        for mod in m.modules():
            if isinstance(mod, (Dropout, ChannelDropout)):
                mod.p = 0.0
    else:
        m = Tiny(**job.get("arch", {}))
    m.load_state_dict(shard_state_dict(job["weights"], MR, MP))
    return m


def mine(a, axis):
    # this replica's share of the global batch on ``axis``
    b = a.shape[axis] // ND
    return np.take(a, range(DR * b, (DR + 1) * b), axis=axis)


def engaged(m):
    return [n for n, mod in m.named_modules()
            if getattr(mod, "sp_engaged", False)]


def run_step(job):
    m = build(job)
    opt = OPTIMIZERS[job["optimizer"]](m.parameters(), weight_decay=job["wd"],
                                       **job.get("opt_kw", {}))
    step = make_train_step(m, opt, "CE", cosine_annealing_lr(job["lr"], 10),
                           DtypePolicy.f32(),
                           max_grad_norm=job.get("max_grad_norm"),
                           device="cpu")
    feats, labels = mine(job["feats"], 2), mine(job["labels"], 2)
    out = {"loss": [], "grad_norm": [], "counts": [], "states": []}
    for s in range(feats.shape[0]):
        mesh.reset_counts()
        met = step(0, feats[s], labels[s], s * feats.shape[1])
        out["counts"].append(mesh.counts())
        out["loss"].append(met["loss"].numpy().copy())
        if "grad_norm" in met:
            out["grad_norm"].append(float(met["grad_norm"]))
        out["states"].append({k: v.clone()
                              for k, v in full_state_dict(m).items()})
        if s == 0 and job.get("record_grads"):
            # the step's reduced gradients, the shards gathered
            lay = layout(m)
            out["grads"] = {n: (gather_tensor(p.grad, lay[n][1], lay[n][0])
                                if n in lay else p.grad).clone()
                            for n, p in m.named_parameters()}
    out["engaged"] = engaged(m)
    out["local_numel"] = sum(p.numel() for p in m.parameters())
    return out


def run_q8_snapshot(job):
    from picklebot_tpu_torch.parallel.megatron import (
        gather_optimizer_state, local_optimizer_state)
    m = build(job)
    opt = OPTIMIZERS["adamw8bit"](m.parameters(), weight_decay=job["wd"],
                                  min_8bit_size=8)
    step = make_train_step(m, opt, "CE", cosine_annealing_lr(job["lr"], 10),
                           DtypePolicy.f32(), device="cpu")
    step(0, mine(job["feats"], 2)[0], mine(job["labels"], 2)[0], 0)
    snap = gather_optimizer_state(opt, m)
    return {"snap": snap, "local": opt.state_dict(),
            "back": local_optimizer_state(snap, opt, m)}


def run_grads(job):
    m = build(job)
    m.eval()
    logits = m(torch.tensor(job["x"]))
    cross_entropy(logits, torch.tensor(job["labels"])).backward()
    return {n: p.grad.clone() for n, p in m.named_parameters()}


def run_eval(job):
    m = build(job)
    ev = make_eval_step(m, "CE", DtypePolicy.f32(), device="cpu")
    o = ev(mine(job["feats"], 0), mine(job["labels"], 0),
           np.ones(job["feats"].shape[0] // ND, np.float32))
    sums = torch.tensor([o["loss_sum"], o["correct"], o["samples"]],
                        dtype=torch.float64)
    mesh.all_reduce_sum_(sums, "data")
    return {"loss": float(sums[0] / sums[2]), "correct": float(sums[1])}


def run_fg(job):
    x = torch.tensor(job["x"], requires_grad=True)
    w1 = torch.tensor(job["w1"]).chunk(MP, dim=1)[MR].clone()
    w2 = torch.tensor(job["w2"]).chunk(MP, dim=0)[MR].clone()
    w1.requires_grad_(True)
    w2.requires_grad_(True)
    h = torch.nn.functional.silu(tp_copy_in(x) @ w1)
    out = tp_reduce_out(h @ w2)
    (out * torch.tensor(job["c"])).sum().backward()
    return {"out": out.detach(), "dx": x.grad, "dw1": w1.grad,
            "dw2": w2.grad}


def run_ring(job):
    n = job["q"].shape[-2] // SP
    blk = slice(SR * n, (SR + 1) * n)
    q, k, v = (torch.tensor(job[t][..., blk, :], requires_grad=True)
               for t in "qkv")
    mesh.reset_counts()
    out = ring_attention(q, k, v, "seq", job["scale"])
    (out * torch.tensor(job["w"][..., blk, :])).sum().backward()
    return {"out": out.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad,
            "counts": mesh.counts()}


RUN = {"step": run_step, "grads": run_grads, "eval": run_eval,
       "fg": run_fg, "ring": run_ring, "q8snap": run_q8_snapshot}
for name, job in spec["jobs"].items():
    torch.save(RUN[job["kind"]](job),
               os.path.join(out_dir, f"{name}_{rank}.pt"))
print(f"RANK{rank} LAYOUT OK")
"""


def run_layout_jobs(tmp_path, mesh_shape, jobs):
    """Every job at ``mesh_shape`` ({'model': m, 'seq': s}, with 'data' as
    many as the world leaves), one spawn: {name: [rank 0's result, ...]}.
    The world is data * seq * model with ``data`` from ``mesh_shape``."""
    world = (mesh_shape.get("data", 1) * mesh_shape.get("model", 1)
             * mesh_shape.get("seq", 1))
    job_path = tmp_path / "layout_jobs.pt"
    torch.save({"mesh": {k: v for k, v in mesh_shape.items()
                         if k != "data"}, "jobs": jobs}, job_path)
    outs = spawn_ranks(tmp_path, LAYOUT_WORKER, (job_path, tmp_path), world)
    for r, out in enumerate(outs):
        assert f"RANK{r} LAYOUT OK" in out, out[-3000:]
    return {name: [torch.load(tmp_path / f"{name}_{r}.pt",
                              weights_only=False) for r in range(world)]
            for name in jobs}


# --------------------------------------------------------------------------
# JAX side
# --------------------------------------------------------------------------

class JaxPacked(JaxTiny):
    """tests/test_tensor_parallel.py's PackedTransformer: 128 wide, one
    layer, the head-packed flash attention."""

    def __init__(self, model_axis=None):
        Module.__init__(self)
        self.embed = Dense(4 * 4 * 3, 128)
        self.transformer = JaxStack(128, depth=1, heads=8, dim_head=16,
                                    ffw_dim=64, backend="packed",
                                    model_axis=model_axis)
        self.head = Dense(128, 13)


def tiny_torch_weights(params) -> dict:
    """A JAX TinyTransformer's params -> the worker's ``Tiny`` state dict
    (Dense (I, O) -> Linear (O, I))."""
    out = {}
    for path, v in flatten_dict(params).items():
        v = np.asarray(v)
        parts = path.split(".")
        if parts[0] in ("embed", "head"):
            key = f"{parts[0]}.{'weight' if parts[1] == 'w' else 'bias'}"
        else:
            i, name = parts[2], parts[3]
            key = "transformer.layers." + {
                "to_qkv": f"{i}.0.to_qkv.weight",
                "to_out": f"{i}.0.to_out.0.weight",
                "fc1": f"{i}.1.net.0.weight",
                "fc2": f"{i}.1.net.3.weight"}[name]
        out[key] = torch.tensor(v.T.copy() if v.ndim == 2 else v.copy())
    return out


def jax_params_as_torch(params, kind):
    if kind == "mobilevit":
        return {k: v for k, v in state_dict_from_jax(
            {k: np.asarray(v) for k, v in flatten_dict(params).items()},
            {}, "MobileViT").items()}
    return tiny_torch_weights(params)


def _put(mesh, tree, specs):
    if specs is None:
        return jax.device_put(tree, NamedSharding(mesh, P()))
    return jax.device_put(tree, jax.tree_util.tree_map(
        lambda s: NamedSharding(mesh, s), specs,
        is_leaf=lambda x: isinstance(x, P)))


def jax_sharded_steps(model, variables, opt, feats, labels, data=1, model_ax=1,
                      seq=1, max_grad_norm=MAX_NORM, eightbit_shards=False):
    """The JAX step under ``make_mesh(data, model, seq)`` for len(feats)
    steps from ``variables``: [(losses, grad_norm, params)] per step."""
    n = data * model_ax * seq
    mesh = make_mesh(data=data, model=model_ax, seq=seq,
                     devices=jax.devices()[:n])
    tp = model_ax > 1
    state = create_train_state(
        model, opt, 0, tp_rules=MOBILEVIT_TP_RULES if eightbit_shards
        else None, tp_degree=model_ax if eightbit_shards else 1)
    state = state._replace(params=variables["params"],
                           model_state=variables["state"])
    specs = train_state_specs(state, MOBILEVIT_TP_RULES) if tp else None
    state = _put(mesh, state, specs)
    step = make_train_step(model, opt, "CE", cosine_annealing_lr(LR, 10),
                           policy=DtypePolicy.f32(), mesh=mesh, donate=False,
                           state_specs=specs, max_grad_norm=max_grad_norm)
    out = []
    for s in range(len(feats)):
        state, m = step(
            state, jax.device_put(jnp.asarray(feats[s]),
                                  NamedSharding(mesh, P(None, "data"))),
            jax.device_put(jnp.asarray(labels[s], jnp.int32),
                           NamedSharding(mesh, P(None, "data"))),
            jax.device_put(jax.random.key(5), NamedSharding(mesh, P())))
        out.append((np.asarray(m["loss"]),
                    float(m["grad_norm"]) if "grad_norm" in m else None,
                    jax.device_get(state.params)))
    return out


def tiny_data(seed, steps=2, batch=8, clip=(2, 8, 8, 3)):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 255, (steps, 1, batch) + clip).astype(np.uint8),
            rng.randint(0, 13, (steps, 1, batch)).astype(np.int32))


def step_job(kind, variables, feats, labels, optimizer="adamw", opt_kw=None,
             arch=None, **extra):
    """A train-step job of ``kind`` ('tiny' or 'mobilevit') from JAX
    ``variables``, 'data'-sharded ``feats`` (steps, A, B, ...)."""
    if kind == "mobilevit":
        weights = state_dict_from_jax(
            {k: np.asarray(v) for k, v in
             flatten_dict(variables["params"]).items()},
            {k: np.asarray(v) for k, v in
             flatten_dict(variables["state"]).items()}, "MobileViT")
        arch = arch or VIT_ARCH
    else:
        weights = tiny_torch_weights(variables["params"])
    job = {"kind": "step", "model": kind, "weights": weights,
           "optimizer": optimizer, "opt_kw": opt_kw or {}, "lr": LR,
           "wd": WD, "max_grad_norm": MAX_NORM, "feats": feats,
           "labels": labels, **extra}
    if arch:
        job["arch"] = arch
    return job


def assert_step_matches(port, ref, kind="tiny", loss_tol=1e-5,
                        rtol=1e-4, atol=3e-3):
    """Every rank's losses, clip norm and (gathered) parameters after each
    step against the JAX sharded step's; the ranks bit-equal."""
    for r, got in enumerate(port):
        for s, (loss, norm, params) in enumerate(ref):
            np.testing.assert_allclose(got["loss"][s], loss, rtol=loss_tol,
                                       atol=loss_tol)
            np.testing.assert_allclose(got["grad_norm"][s], norm, rtol=1e-5)
            want = jax_params_as_torch(params, kind)
            for key, w in want.items():
                np.testing.assert_allclose(
                    got["states"][s][key].numpy(), w.numpy(), rtol=rtol,
                    atol=atol, err_msg=f"rank {r} step {s} {key}")
        for s, st in enumerate(got["states"]):
            for key, v in st.items():
                assert torch.equal(v, port[0]["states"][s][key]), (r, key)


# --------------------------------------------------------------------------
# data 1 x model 2
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    """Every data-1 x model-2 job in one spawn, with the JAX inputs."""
    tmp = tmp_path_factory.mktemp("tp2")
    rng = np.random.RandomState(1234)
    tiny = JaxTiny()
    tv = tiny.init(0)
    feats, labels = tiny_data(7)
    x8 = rng.randint(0, 255, (8, 2, 8, 8, 3)).astype(np.float32) / 255
    l8 = rng.randint(0, 13, (8,)).astype(np.int64)
    packed = JaxPacked()
    pv = packed.init(0)
    vit = JaxMobileViT(num_classes=13, attention_backend="xla", **VIT_ARCH)
    _no_dropout(vit, torch.nn.Module())
    vv = vit.init(0)
    vfeats = rng.randint(0, 256, (1, 1, 2) + VIT_CLIP).astype(np.uint8)
    vlabels = rng.randint(0, 13, (1, 1, 2)).astype(np.int32)
    fg = {"x": rng.randn(4, 6).astype(np.float32),
          "w1": rng.randn(6, 8).astype(np.float32),
          "w2": rng.randn(8, 5).astype(np.float32),
          "c": rng.randn(4, 5).astype(np.float32)}
    eval_feats = rng.randint(0, 255, (8, 2, 8, 8, 3)).astype(np.uint8)
    eval_labels = rng.randint(0, 13, (8,)).astype(np.int64)
    jobs = {
        "fg": {"kind": "fg", **fg},
        "f32": step_job("tiny", tv, feats, labels),
        "q8": step_job("tiny", tv, feats, labels, "adamw8bit",
                       {"min_8bit_size": 8}),
        "grads": {"kind": "grads", "model": "tiny",
                  "weights": tiny_torch_weights(tv["params"]), "x": x8,
                  "labels": l8},
        "eval": {"kind": "eval", "model": "tiny",
                 "weights": tiny_torch_weights(tv["params"]),
                 "feats": eval_feats, "labels": eval_labels},
        "q8snap": dict(step_job("tiny", tv, feats, labels), kind="q8snap"),
        "packed": step_job("tiny", pv, feats[:1], labels[:1],
                           arch={"width": 128, "heads": 8, "dim_head": 16,
                                 "depth": 1, "backend": "packed"}),
        "vit": step_job("mobilevit", vv, vfeats, vlabels),
    }
    port = run_layout_jobs(tmp, {"model": 2}, jobs)
    inputs = dict(tiny=(tiny, tv, feats, labels), x8=x8, l8=l8, fg=fg,
                  packed=(packed, pv, feats[:1], labels[:1]),
                  vit=(vit, vv, vfeats, vlabels),
                  eval=(eval_feats, eval_labels))
    return port, inputs


def test_tp_f_and_g_match_jax(tp2):
    """Megatron's f and g alone, forward and backward, against
    ``tp_copy_in`` / ``tp_reduce_out`` under shard_map at model 2 (fc1
    column-sharded, fc2 row-sharded)."""
    from jax import shard_map
    from picklebot_tpu.parallel.megatron import tp_copy_in, tp_reduce_out
    port, inputs = tp2
    fg = inputs["fg"]
    mesh = make_mesh(data=1, model=2, devices=jax.devices()[:2])

    def local(x, w1, w2, c):
        def loss(x, w1, w2):
            h = jax.nn.silu(tp_copy_in(x, "model") @ w1)
            out = tp_reduce_out(h @ w2, "model")
            return jnp.sum(out * c), out
        (_, out), grads = jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True)(x, w1, w2)
        return (out,) + grads

    fn = jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(None, "model"), P("model", None), P()),
        out_specs=(P(), P(), P(None, "model"), P("model", None)),
        check_vma=False))
    out, dx, dw1, dw2 = (np.asarray(a) for a in fn(
        *(jnp.asarray(fg[k]) for k in ("x", "w1", "w2", "c"))))
    got = port["fg"]
    for r in range(2):
        np.testing.assert_allclose(got[r]["out"].numpy(), out, rtol=1e-5,
                                   atol=1e-5)
        # the replicated input's gradient: the sum of both shards', once
        np.testing.assert_allclose(got[r]["dx"].numpy(), dx, rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(
        np.concatenate([got[r]["dw1"].numpy() for r in range(2)], 1), dw1,
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        np.concatenate([got[r]["dw2"].numpy() for r in range(2)], 0), dw2,
        rtol=1e-5, atol=1e-6)


def test_tp_matches_jax_sharded_step(tp2):
    """2 f32 AdamW steps with the clip on, data 1 x model 2, against the
    JAX TP step (the counterpart of test_tp_matches_single_device)."""
    port, inputs = tp2
    tiny, tv, feats, labels = inputs["tiny"]
    ref = jax_sharded_steps(JaxTiny(model_axis="model"), tv,
                            AdamW(weight_decay=WD), feats, labels,
                            model_ax=2)
    assert ref[0][1] > MAX_NORM      # the clip engaged
    assert_step_matches(port["f32"], ref)


def test_tp_8bit_optimizer_matches_jax(tp2):
    """AdamW8bit with per-shard blocks (each rank quantizes its own
    shard): 2 steps against the JAX TP step with ``model_shards``."""
    port, inputs = tp2
    tiny, tv, feats, labels = inputs["tiny"]
    ref = jax_sharded_steps(JaxTiny(model_axis="model"), tv,
                            AdamW8bit(weight_decay=WD, min_8bit_size=8),
                            feats, labels, model_ax=2, eightbit_shards=True)
    assert_step_matches(port["q8"], ref, loss_tol=5e-4, rtol=1e-3,
                        atol=5e-3)


def test_tp_eval_matches_jax(tp2):
    """The eval step keeps the FFN shards (replicated shards would double
    every FFN sum): loss and correct count against the JAX TP eval."""
    port, inputs = tp2
    tiny, tv, _, _ = inputs["tiny"]
    feats, labels = inputs["eval"]
    mesh = make_mesh(data=1, model=2, devices=jax.devices()[:2])
    jm = JaxTiny(model_axis="model")
    state = create_train_state(jm, AdamW(), 0)
    specs = train_state_specs(state, MOBILEVIT_TP_RULES)
    ev = make_eval_step(jm, "CE", policy=DtypePolicy.f32(), mesh=mesh,
                        state_specs=specs)
    out = ev(_put(mesh, state, specs), jnp.asarray(feats),
             jnp.asarray(labels, jnp.int32), jnp.ones((8,), jnp.float32))
    for got in port["eval"]:
        np.testing.assert_allclose(got["loss"], float(out["loss"]),
                                   rtol=1e-5, atol=1e-5)
        assert got["correct"] == float(out["correct"])


def test_tp_gradients_match_dense(tp2):
    """The sharded FFN gradients assemble to the dense gradient (1x, not
    the axis size) and every replicated gradient is the dense one on
    each rank (the counterpart of test_tp_gradients_match_dense)."""
    from picklebot_tpu.train.losses import cross_entropy
    port, inputs = tp2
    tiny, tv, _, _ = inputs["tiny"]
    x8, l8 = inputs["x8"], inputs["l8"]

    def dense_loss(params):
        out, _ = tiny.apply({"params": params, "state": tv["state"]},
                            jnp.asarray(x8), train=False,
                            policy=DtypePolicy.f32())
        return cross_entropy(out, jnp.asarray(l8, jnp.int32))

    dense = tiny_torch_weights(jax.grad(dense_loss)(tv["params"]))
    got = port["grads"]
    for key, want in dense.items():
        if key.endswith("net.0.weight"):
            full = torch.cat([got[0][key], got[1][key]], 0)
        elif key.endswith("net.3.weight"):
            full = torch.cat([got[0][key], got[1][key]], 1)
        else:
            for r in range(2):
                np.testing.assert_allclose(got[r][key].numpy(), want.numpy(),
                                           rtol=1e-5, atol=1e-6,
                                           err_msg=f"rank {r} {key}")
            continue
        np.testing.assert_allclose(full.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=key)


def test_tp_with_packed_attention_matches_jax(tp2):
    """The head-packed attention (its plain version on the CPU; the JAX
    side's Pallas kernel in interpret mode) inside the TP step: loss and
    parameters against the JAX TP step."""
    port, inputs = tp2
    jm, pv, feats, labels = inputs["packed"]
    ref = jax_sharded_steps(JaxPacked(model_axis="model"), pv,
                            AdamW(weight_decay=WD), feats, labels,
                            model_ax=2)
    assert_step_matches(port["packed"], ref)


def test_tp_collective_counts_from_shapes(tp2):
    """Per step at data 1 x model 2 (batch 8, N = 8 tokens, width 32, two
    layers, f32): f and g all-reduce each FFN's (8, 8, 32) activations
    forward and their gradient backward, 4 x 8192 bytes, and the clip
    sums the 4 sharded leaves' squares in one all-reduce of 4 f32; no
    data reduction (one replica). This stands in for the slow TP case of
    tests/test_collective_bytes.py."""
    port, _ = tp2
    act = 8 * 8 * 32 * 4
    want = {"all-reduce": {"count": 2 * 2 + 1, "bytes": 2 * 2 * act + 16}}
    for got in port["f32"]:
        for counts in got["counts"]:
            assert {k: v for k, v in counts.items() if v["count"]} == want


def test_mobilevit_tp_step_matches_jax(tp2):
    """The slice as a whole: MobileViT at a small width (dims 16, depth
    1 per stage, 8x64x64 clips, batch 2) at model 2, one f32 step with the
    clip, against the JAX sharded step."""
    port, inputs = tp2
    vit, vv, feats, labels = inputs["vit"]
    jm = JaxMobileViT(num_classes=13, attention_backend="xla",
                      model_axis="model", **VIT_ARCH)
    _no_dropout(jm, torch.nn.Module())
    ref = jax_sharded_steps(jm, vv, AdamW(weight_decay=WD), feats, labels,
                            model_ax=2)
    assert_step_matches(port["vit"], ref, kind="mobilevit")


def test_tp_8bit_snapshot_layout_and_reslice(tp2):
    """The snapshot's AdamW8bit moments in the JAX TP layout (each rank
    quantizes its own shard: codes (shards * blocks_local, 256), the
    JAX test's shape, stacked by model rank; f32 moments and replicated
    leaves whole), cut back exactly for each rank, and at one process
    decoded and quantized again per the full tensor."""
    from picklebot_tpu_torch.parallel.megatron import local_optimizer_state
    from picklebot_tpu_torch.train.optim import (AdamW8bit,
                                                 dequantize_signed)
    port, _ = tp2
    snaps = [r["snap"] for r in port["q8snap"]]
    snap = snaps[0]
    assert snap["model_parallel"] == 2
    dims = snap["tp_dims"]
    assert sum(d is not None for d in dims) == 4
    for r, got in enumerate(port["q8snap"]):
        for part in ("m", "v"):
            for a, b in zip(got["back"][part], got["local"][part]):
                a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
                assert all(torch.equal(x, y) for x, y in zip(a, b))
        for part in ("m", "v"):     # the ranks write the same snapshot
            for a, b in zip(got["snap"][part], snap[part]):
                a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
                assert all(torch.equal(x, y) for x, y in zip(a, b))
    for i, (shape, dim) in enumerate(zip(snap["shapes"], dims)):
        if dim is None:
            continue
        local = int(np.prod(shape)) // 2
        blocks_local = -(-local // 256)
        codes, scales = snap["m"][i]
        assert codes.shape == (2 * blocks_local, 256)
        assert scales.shape == (2 * blocks_local, 1)
    # one process: the full tensors' own blocks, the values kept
    params = torch.nn.ParameterList(
        [torch.nn.Parameter(torch.zeros(s)) for s in snap["shapes"]])
    opt = AdamW8bit(params.parameters(), min_8bit_size=8)
    one = local_optimizer_state(snap, opt, params)
    for i, (shape, dim) in enumerate(zip(snap["shapes"], dims)):
        if dim is None:
            continue
        codes, scales = one["m"][i]
        assert codes.shape == (-(-int(np.prod(shape)) // 256), 256)
        half = list(shape)
        half[dim] //= 2
        bl = snap["m"][i][0].shape[0] // 2
        want = torch.cat([dequantize_signed(
            snap["m"][i][0][k * bl:(k + 1) * bl],
            snap["m"][i][1][k * bl:(k + 1) * bl], tuple(half))
            for k in range(2)], dim=dim)
        got = dequantize_signed(codes, scales, tuple(shape))
        # one more pass of the codec: within its 1/16 of a block's absmax
        assert (got - want).abs().max() <= want.abs().max() / 16


# --------------------------------------------------------------------------
# data 2 x model 2 (4 ranks)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tp4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp4")
    tiny = JaxTiny()
    tv = tiny.init(0)
    feats, labels = tiny_data(11)
    jobs = {"f32": step_job("tiny", tv, feats, labels),
            "q8": step_job("tiny", tv, feats, labels, "adamw8bit",
                           {"min_8bit_size": 8})}
    return run_layout_jobs(tmp, {"data": 2, "model": 2}, jobs), (tv, feats,
                                                                  labels)


@pytest.mark.parametrize("optimizer", ["adamw", "adamw8bit"])
def test_tp_data2_model2_matches_jax(tp4, optimizer):
    """4 ranks as the mesh data 2 x model 2: each data replica its half of
    the batch, gradients averaged over 'data' only, f32 AdamW and
    AdamW8bit, 2 steps with the clip on, against the JAX sharded step."""
    port, (tv, feats, labels) = tp4
    if optimizer == "adamw":
        ref = jax_sharded_steps(JaxTiny(model_axis="model"), tv,
                                AdamW(weight_decay=WD), feats, labels,
                                data=2, model_ax=2)
        assert_step_matches(port["f32"], ref)
    else:
        ref = jax_sharded_steps(JaxTiny(model_axis="model"), tv,
                                AdamW8bit(weight_decay=WD, min_8bit_size=8),
                                feats, labels, data=2, model_ax=2,
                                eightbit_shards=True)
        assert_step_matches(port["q8"], ref, loss_tol=5e-4, rtol=1e-3,
                            atol=5e-3)


def test_tp_data2_collective_counts_from_shapes(tp4):
    """At data 2 x model 2 (4 clips per replica): the 4 FFN all-reduces
    over 'model' of (4, 8, 32) f32, the clip's, and over 'data' the
    metrics (loss and correct, 2 f32) and the f32 gradient bucket of the
    rank's parameters (FFN halves included)."""
    port, _ = tp4
    local = (48 * 32 + 32) + (32 * 13 + 13) + 2 * (
        96 * 32 + 32 * 32 + 32 * 32 + 32 * 32)
    want = {"all-reduce": {"count": 4 + 1 + 2,
                           "bytes": 4 * 4 * 8 * 32 * 4 + 16 + 8
                           + 4 * local}}
    for got in port["f32"]:
        assert got["local_numel"] == local
        for counts in got["counts"]:
            assert {k: v for k, v in counts.items() if v["count"]} == want


# --------------------------------------------------------------------------
# train() at model 2: snapshot, resume, .pth served in one process
# --------------------------------------------------------------------------

TP_LOOP = {"model_name": "MobileViT", "model_parallel": 2,
           "attention_backend": "xla", "dims": VIT_ARCH["dims"],
           "channels": VIT_ARCH["channels"], "synthetic_len": 12,
           "synthetic_shape": [8, 32, 32], "max_frames": 8, "t_bucket": 8}


@pytest.fixture(scope="module")
def tp_loop(tmp_path_factory):
    from test_torch_dp import run_loop
    tmp = tmp_path_factory.mktemp("tp_loop")
    run_loop(tmp, "tp", **TP_LOOP)
    return tmp


def _tp_snapshot(tmp, tag, *names):
    return tmp.joinpath(f"{tag}_rank0", "ck", *names)


def test_tp_train_snapshot_resumes_bit_equal(tp_loop):
    """train() at 2 ranks with model_parallel 2: rank 0 alone writes
    snapshots of full leaves (weights and AdamW moments gathered, the
    layout recorded); the epoch-0 snapshot resumed at 2 ranks ends bit
    for bit where the uninterrupted run ended."""
    from test_torch_dp import run_loop
    from picklebot_tpu_torch.models.mobilevit import MobileViT
    from picklebot_tpu_torch.train import checkpoint as ckpt
    tmp = tp_loop
    start = _tp_snapshot(tmp, "tp", "MobileViT", "step_0")
    payload = ckpt.load_checkpoint(str(start))
    full = MobileViT(num_classes=13, **{k: VIT_ARCH[k] for k in
                                        ("dims", "channels")})
    full.load_state_dict(payload["model"], strict=True)
    assert payload["optimizer"]["model_parallel"] == 2
    assert [tuple(m.shape) for m in payload["optimizer"]["m"]] == \
        [tuple(s) for s in payload["optimizer"]["shapes"]]
    assert not tmp.joinpath("tp_rank1", "ck", "MobileViT").exists()
    run_loop(tmp, "resume", checkpoint=str(start), **TP_LOOP)
    finished = ("MobileViT_CrossEntropyLoss()_finished", "step_2")
    a = ckpt.load_checkpoint(str(_tp_snapshot(tmp, "tp", *finished)))
    b = ckpt.load_checkpoint(str(_tp_snapshot(tmp, "resume", *finished)))
    for key in a["model"]:
        assert torch.equal(a["model"][key], b["model"][key]), key
    for part in ("m", "v"):
        for x, y in zip(a["optimizer"][part], b["optimizer"][part]):
            assert torch.equal(x, y)


def test_tp_train_pth_serves_in_one_process(tp_loop, capsys):
    """The .pth of the model-parallel run holds full leaves: one-process
    serve (``replicated_equivalent`` drops model_parallel) loads it and
    predicts."""
    from picklebot_tpu_torch import serve
    tmp = tp_loop
    pth = _tp_snapshot(tmp, "tp", "MobileViT_CrossEntropyLoss()_finished.pth")
    rc = serve.main([str(tmp / "tp.json"), "--checkpoint", str(pth),
                     "--csv", "x", "--limit", "4", "--batch", "2",
                     "--device", "cpu"])
    assert rc == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last)["evaluated"] == 4


# --------------------------------------------------------------------------
# no process needed
# --------------------------------------------------------------------------

def test_shard_state_dict_round_trip_and_layout():
    """``shard_state_dict`` cuts net.0 rows and net.3 columns (the JAX
    rule's fc1 column / fc2 row for torch's (O, I) layout) and
    ``unshard_state_dicts`` puts them back exactly."""
    from picklebot_tpu_torch.convert import (shard_state_dict,
                                             unshard_state_dicts)
    from picklebot_tpu_torch.models.mobilevit import MobileViT
    from picklebot_tpu.core.module import flatten_dict as fd
    jm = JaxMobileViT(num_classes=13, **VIT_ARCH)
    v = jm.init(0)
    specs = fd(param_specs(v["params"], MOBILEVIT_TP_RULES))
    sd = MobileViT(num_classes=13, **VIT_ARCH).state_dict()
    shards = [shard_state_dict(sd, r, 2) for r in range(2)]
    back = unshard_state_dicts(shards)
    assert back.keys() == sd.keys()
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    n_sharded = sum(1 for s in specs.values() if s != P())
    cut = [k for k in sd if shards[0][k].shape != sd[k].shape]
    assert len(cut) == n_sharded == 6
    for k in cut:
        dim = 0 if ".net.0." in k else 1
        assert shards[0][k].shape[dim] * 2 == sd[k].shape[dim]


def test_tp_model_seeded_weights_are_the_one_process_models():
    """A MobileViT built with model_axis draws the whole FFN weights from
    its seed and keeps its slice: rank r's state dict is
    ``shard_state_dict`` of the one-process model's."""
    from picklebot_tpu_torch.convert import shard_state_dict
    from picklebot_tpu_torch.models.mobilevit import MobileViT
    from picklebot_tpu_torch.parallel import mesh
    full = MobileViT(num_classes=13, seed=3, **VIT_ARCH).state_dict()
    saved = dict(mesh._MESH), mesh._MESH_SHAPE
    try:
        for r in range(2):
            mesh._MESH["model"] = mesh._Axis(2, r, [0, 1])
            tp = MobileViT(num_classes=13, seed=3, model_axis="model",
                           **VIT_ARCH).state_dict()
            want = shard_state_dict(full, r, 2)
            for k in want:
                assert torch.equal(tp[k], want[k]), (r, k)
    finally:
        mesh._MESH.clear()
        mesh._MESH.update(saved[0])
        mesh._MESH_SHAPE = saved[1]


def test_registry_and_loop_take_model_parallel():
    """The port no longer refuses model_parallel: not in ``UNPORTED``, and
    the registry builds it once the mesh has the axis (without one it
    says so), as it does pipeline_parallel since A20.3."""
    from picklebot_tpu_torch.models.registry import initialize_model
    from picklebot_tpu_torch.train.loop import UNPORTED, check_world
    from picklebot_tpu_torch.utils.config import Config
    assert "model_parallel" not in UNPORTED
    assert "sequence_parallel" not in UNPORTED
    cfg = Config(model_name="MobileViT", model_parallel=2,
                 dims=VIT_ARCH["dims"],
                 channels=VIT_ARCH["channels"]).validate()
    with pytest.raises(ValueError, match="init_mesh"):
        initialize_model(cfg)
    with pytest.raises(ValueError, match="needs a multiple of 2"):
        check_world(cfg, 3)
    assert check_world(cfg, 4) == 2
    with pytest.raises(ValueError, match="init_mesh"):
        initialize_model(Config(model_name="MobileViT", pipeline_parallel=2,
                                dims=VIT_ARCH["dims"],
                                channels=VIT_ARCH["channels"]).validate())
