"""Port: pipeline parallelism (``parallel/pipeline.py``, the 'pipe' axis of
``parallel/mesh.py``, ``TransformerStack`` with ``pipeline_axis``, the PP
step) against the JAX package's, and the rank worker that
``test_torch_moe.py`` shares.

Ranks are gloo subprocesses on the CPU (``test_torch_dp.spawn_ranks``)
laid out as the JAX mesh (``mesh.init_mesh``), each running a job file
(``MESH_WORKER``), so a few spawns serve every case. The JAX side runs in
this process on its 8 virtual CPU devices with the same seeded numpy
inputs and the same weights. The one-process reference of the port runs
here, on the same ``Tiny`` model (``TINY_SRC``, which the worker runs
too).

Tolerances: the JAX tests' own (``tests/test_pipeline_parallel.py``):
losses rtol/atol 1e-5, parameters after Adam steps rtol 1e-4 atol 3e-3;
first-step gradients within 1e-5 of each tensor's max|ref|.

The JAX PP step's gradients are not the one-process ones (its exit's
``psum`` transposes to a second sum of the replicated cotangent, and only
stage 0 reads the stack's input): ``test_jax_pp_gradient_factor_beside_
the_ports`` records the factors beside the port's. Adam divides a
per-tensor factor out, which is why the JAX package's own test, which
compares weights after AdamW steps, passes, and why the port's steps are
held to the JAX PP step after AdamW steps without the global-norm clip
(the clip would see JAX's inflated norm) and to the JAX unsharded
gradients directly.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from picklebot_tpu.core.module import DtypePolicy, flatten_dict
from picklebot_tpu.models.mobilevit import MobileViT as JaxMobileViT
from picklebot_tpu.parallel.mesh import (MOBILEVIT_TP_RULES, make_mesh,
                                         train_state_specs)
from picklebot_tpu.train.losses import cross_entropy
from picklebot_tpu.train.optim import AdamW, cosine_annealing_lr
from picklebot_tpu.train.step import create_train_state, make_train_step
from picklebot_tpu_torch.convert import state_dict_from_jax
from test_pipeline_parallel import TinyTransformer as JaxTinyPP
from test_torch_dp import spawn_ranks
from test_torch_tp import VIT_ARCH, tiny_data
from test_torch_train_step import _no_dropout

LR, WD = 1e-3, 1e-4
MAX_NORM = 0.05
GRAD_REL = 1e-5
VIT_PP_ARCH = dict(VIT_ARCH, depths=(2, 2, 1))   # stage 3 falls back


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------------------
# the tiny model (the JAX tests' TinyTransformer / TinyMoE) and the worker
# --------------------------------------------------------------------------

TINY_SRC = r"""
import torch
from picklebot_tpu_torch.models.mobilevit import TransformerStack
from picklebot_tpu_torch.ops.linear import Linear


class Tiny(torch.nn.Module):
    # embed, TransformerStack (width 32, 4 heads of 8, FFN 64), token
    # mean, head; a (B, 2, 8, 8, 3) clip is 8 tokens of 48
    def __init__(self, depth=2, dropout=0.0, microbatches=None, experts=0,
                 dispatch="replicated", axes=None):
        super().__init__()
        axes = axes or {}
        self.embed = Linear(48, 32)
        self.transformer = TransformerStack(
            32, depth, 4, 8, 64, dropout, "xla", axes.get("model"),
            axes.get("seq"), axes.get("pipe"), microbatches, experts, 2,
            1.25, axes.get("expert"), dispatch)
        self.head = Linear(32, 13)

    def forward(self, x):
        tokens = x.reshape(x.shape[0], -1, 48)
        return self.head(self.transformer(self.embed(tokens)).mean(dim=1))
"""

MESH_WORKER = r"""
import os, sys, warnings
import numpy as np
import torch
torch.set_num_threads(1)
rank, world, port, job_path, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                        sys.argv[3], sys.argv[4], sys.argv[5])
from picklebot_tpu_torch.convert import local_state_dict
from picklebot_tpu_torch.core.policy import DtypePolicy
from picklebot_tpu_torch.models.mobilevit import MobileViT
from picklebot_tpu_torch.ops.linear import ChannelDropout, Dropout
from picklebot_tpu_torch.ops.moe import MoEFeedForward
from picklebot_tpu_torch.parallel import mesh
from picklebot_tpu_torch.parallel.megatron import (gather_tensor, layout,
                                                   shard_tensor)
from picklebot_tpu_torch.parallel.pipeline import gpipe_apply, pp_sync_grads
from picklebot_tpu_torch.train.checkpoint import full_state_dict
from picklebot_tpu_torch.train.optim import OPTIMIZERS, cosine_annealing_lr
from picklebot_tpu_torch.train.step import make_train_step

mesh.init_distributed(f"localhost:{port}", backend="gloo", device="cpu",
                      rank=rank, world_size=world)
spec = torch.load(job_path, weights_only=False)
shape = mesh.init_mesh(**spec["mesh"])
ND, DR = shape["data"], mesh.axis_index("data")
AXES = {a: a for a in ("model", "seq", "pipe", "expert") if shape[a] > 1}
exec(spec["tiny_src"])


def build(job):
    if job.get("model") == "mobilevit":
        m = MobileViT(num_classes=13, attention_backend="xla",
                      model_axis=AXES.get("model"),
                      pipeline_axis=AXES.get("pipe"),
                      expert_axis=AXES.get("expert"), **job["arch"])
        for mod in m.modules():
            if isinstance(mod, (Dropout, ChannelDropout)):
                mod.p = 0.0
    else:
        m = Tiny(axes=AXES, **job.get("arch", {}))
    m.load_state_dict(local_state_dict(job["weights"]))
    return m


def mine(a, axis):
    # this replica's share of the global batch on ``axis``
    b = a.shape[axis] // ND
    return np.take(a, range(DR * b, (DR + 1) * b), axis=axis)


def full_grads(m):
    lay = layout(m)
    return {n: (gather_tensor(p.grad, lay[n][1], lay[n][0]) if n in lay
                else p.grad).clone() for n, p in m.named_parameters()}


def flags(m, flag):
    return [n for n, mod in m.named_modules() if getattr(mod, flag, False)]


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
        if s == 0:
            out["grads"] = full_grads(m)
    out["pp_engaged"] = flags(m, "pp_engaged")
    out["sp_engaged"] = flags(m, "sp_engaged")
    out["local_numel"] = sum(p.numel() for p in m.parameters())
    if job.get("q8snap"):
        from picklebot_tpu_torch.parallel.megatron import (
            gather_optimizer_state, local_optimizer_state)
        out["snap"] = gather_optimizer_state(opt, m)
        out["local"] = opt.state_dict()
        out["back"] = local_optimizer_state(out["snap"], opt, m)
    return out


def run_square_grads(job):
    # d sum(out^2) / d params, the step's gradient sum over 'pipe' applied
    m = build(job)
    (m(torch.tensor(job["x"])) ** 2).sum().backward()
    pp_sync_grads(m)
    return full_grads(m)


def run_gpipe(job):
    ws = [torch.tensor(w, requires_grad=True) for w in job["ws"]]
    x = torch.tensor(job["x"], requires_grad=True)
    mesh.reset_counts()
    out = gpipe_apply(lambda w, li, mi, h: torch.tanh(h @ w), ws, x, "pipe",
                      job["microbatches"])
    (out * torch.tensor(job["cot"])).sum().backward()
    counts = mesh.counts()
    grads = torch.stack([torch.zeros_like(w) if w.grad is None else w.grad
                         for w in ws])
    mesh.all_reduce_sum_(grads, "pipe")
    return {"out": out.detach(), "dx": x.grad, "dws": grads,
            "counts": counts}


def run_moe(job):
    ep = AXES.get("expert")
    mod = MoEFeedForward(job["d"], job["h"], job["e"], job["top_k"],
                         job["cf"], expert_axis=ep, dispatch=job["dispatch"])
    weights = dict(job["weights"])
    if ep:
        for k in ("w1", "w2"):
            weights[k] = shard_tensor(weights[k], 2, mesh.axis_index(ep),
                                      shape["expert"])
    mod.load_state_dict(weights)
    x = torch.tensor(job["x"], requires_grad=True)
    mesh.reset_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = mod(x)
    aux = mod.aux_loss
    ((out * torch.tensor(job["c"])).sum() + 0.01 * aux).backward()
    counts = mesh.counts()
    return {"out": out.detach(), "aux": aux.item(), "dx": x.grad,
            "grads": full_grads(mod), "counts": counts,
            "warned": [str(w.message) for w in caught]}


RUN = {"step": run_step, "square_grads": run_square_grads,
       "gpipe": run_gpipe, "moe": run_moe}
for name, job in spec["jobs"].items():
    torch.save(RUN[job["kind"]](job),
               os.path.join(out_dir, f"{name}_{rank}.pt"))
print(f"RANK{rank} MESH OK")
"""

_TINY = {}
exec(TINY_SRC, _TINY)
Tiny = _TINY["Tiny"]


def run_mesh_jobs(tmp_path, mesh_shape, jobs):
    """Every job at ``mesh_shape`` ({axis: size}, 'data' as many as the
    world leaves: the world is the product), one spawn: {name: [rank 0's
    result, ...]}."""
    world = int(np.prod(list(mesh_shape.values())))
    job_path = tmp_path / "mesh_jobs.pt"
    torch.save({"mesh": {k: v for k, v in mesh_shape.items()
                         if k != "data"}, "jobs": jobs,
                "tiny_src": TINY_SRC}, job_path)
    outs = spawn_ranks(tmp_path, MESH_WORKER, (job_path, tmp_path), world)
    for r, out in enumerate(outs):
        assert f"RANK{r} MESH OK" in out, out[-3000:]
    return {name: [torch.load(tmp_path / f"{name}_{r}.pt",
                              weights_only=False) for r in range(world)]
            for name in jobs}


# --------------------------------------------------------------------------
# weights, the JAX steps and the one-process port step
# --------------------------------------------------------------------------

def tiny_weights(params) -> dict:
    """A JAX TinyTransformer's / TinyMoE's params -> ``Tiny``'s state
    dict: Dense (I, O) -> Linear (O, I); an MoE router (d, E) -> (E, d),
    its banks (E, ., .) with every axis reversed."""
    out = {}
    for path, v in flatten_dict(params).items():
        v = np.asarray(v)
        parts = path.split(".")
        if parts[0] in ("embed", "head"):
            key = f"{parts[0]}.{'weight' if parts[1] == 'w' else 'bias'}"
        elif parts[3] in ("router", "w1", "w2"):
            key = f"transformer.ffs.{parts[2]}.{parts[3]}"
        else:
            i, name = parts[2], parts[3]
            key = "transformer.layers." + {
                "to_qkv": f"{i}.0.to_qkv.weight",
                "to_out": f"{i}.0.to_out.0.weight",
                "fc1": f"{i}.1.net.0.weight",
                "fc2": f"{i}.1.net.3.weight"}[name]
        out[key] = torch.tensor(np.ascontiguousarray(
            v.T if v.ndim >= 2 else v))
    return out


def vit_weights(variables) -> dict:
    return state_dict_from_jax(
        {k: np.asarray(v) for k, v in
         flatten_dict(variables["params"]).items()},
        {k: np.asarray(v) for k, v in
         flatten_dict(variables["state"]).items()}, "MobileViT")


def step_job(weights, feats, labels, optimizer="adamw", opt_kw=None,
             arch=None, model="tiny", max_grad_norm=None, **extra):
    job = {"kind": "step", "model": model, "weights": weights,
           "optimizer": optimizer, "opt_kw": opt_kw or {}, "lr": LR,
           "wd": WD, "max_grad_norm": max_grad_norm, "feats": feats,
           "labels": labels, **extra}
    if arch:
        job["arch"] = arch
    return job


def _put(mesh, tree, specs):
    if specs is None:
        return jax.device_put(tree, NamedSharding(mesh, P()))
    return jax.device_put(tree, jax.tree_util.tree_map(
        lambda s: NamedSharding(mesh, s), specs,
        is_leaf=lambda x: isinstance(x, P)))


def jax_mesh_steps(model, variables, opt, feats, labels, mesh_kw,
                   max_grad_norm=None, rules=None, shard_degree=1):
    """The JAX step under ``make_mesh(**mesh_kw)`` for len(feats) steps
    from ``variables``: [(losses, grad_norm, params)] per step.
    ``rules``: the sharded leaves' rules (their 8-bit moments laid out
    per shard of ``shard_degree``)."""
    n = int(np.prod(list(mesh_kw.values())))
    mesh = make_mesh(**mesh_kw, devices=jax.devices()[:n])
    state = create_train_state(model, opt, 0, tp_rules=rules,
                               tp_degree=shard_degree)
    state = state._replace(params=variables["params"],
                           model_state=variables["state"])
    specs = train_state_specs(state, rules) if rules else None
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


def jax_grads(model, variables, feats, labels):
    """The JAX unsharded gradient of the first microbatch's CE loss (the
    step's preprocessing: /255), in ``Tiny``'s keys."""
    x = jnp.asarray(feats[0, 0].astype(np.float32) / 255.0)
    lbl = jnp.asarray(labels[0, 0], jnp.int32)

    def loss(params):
        out, _ = model.apply({"params": params, "state": variables["state"]},
                             x, train=False, policy=DtypePolicy.f32())
        return cross_entropy(out, lbl)

    return tiny_weights(jax.grad(loss)(variables["params"]))


def port_one_process(weights, feats, labels, steps=1, optimizer="adamw",
                     max_grad_norm=None, **arch):
    """The port's step in this process, no process group: per step
    (losses, grad_norm, state dict); the first step's gradients."""
    from picklebot_tpu_torch.core.policy import DtypePolicy as TorchPolicy
    from picklebot_tpu_torch.train import optim as torch_optim
    from picklebot_tpu_torch.train.step import make_train_step as torch_step
    m = Tiny(**arch)
    m.load_state_dict(weights)
    opt = torch_optim.OPTIMIZERS[optimizer](m.parameters(), weight_decay=WD)
    step = torch_step(m, opt, "CE", torch_optim.cosine_annealing_lr(LR, 10),
                      TorchPolicy.f32(), max_grad_norm=max_grad_norm,
                      device="cpu")
    out, grads = [], None
    for s in range(steps):
        met = step(0, feats[s], labels[s], s * feats.shape[1])
        if s == 0:
            grads = {n: p.grad.clone() for n, p in m.named_parameters()}
        out.append((met["loss"].numpy().copy(),
                    float(met["grad_norm"]) if "grad_norm" in met else None,
                    {k: v.clone() for k, v in m.state_dict().items()}))
    return out, grads


def assert_grads_close(got, want, rel=GRAD_REL, label=""):
    """Every gradient within ``rel`` of its tensor's max|want|."""
    assert got.keys() == want.keys()
    for k, w in want.items():
        w = np.asarray(w, np.float64)
        err = np.abs(np.asarray(got[k], np.float64) - w).max()
        assert err <= rel * max(np.abs(w).max(), 1e-30), (label, k, err)


def assert_steps_match(port, ref, weights_of=tiny_weights, loss_tol=1e-5,
                       rtol=1e-4, atol=3e-3, norm=True):
    """Every rank's losses (and clip norm) and full parameters after each
    step against the JAX sharded step's; the ranks bit-equal."""
    for r, got in enumerate(port):
        for s, (loss, gnorm, params) in enumerate(ref):
            np.testing.assert_allclose(got["loss"][s], loss, rtol=loss_tol,
                                       atol=loss_tol)
            if norm and gnorm is not None:
                np.testing.assert_allclose(got["grad_norm"][s], gnorm,
                                           rtol=1e-5)
            for key, w in weights_of(params).items():
                np.testing.assert_allclose(
                    got["states"][s][key].numpy(), w.numpy(), rtol=rtol,
                    atol=atol, err_msg=f"rank {r} step {s} {key}")
        for s, st in enumerate(got["states"]):
            for key, v in st.items():
                assert torch.equal(v, port[0]["states"][s][key]), (r, key)


# --------------------------------------------------------------------------
# data 1 x pipe 2
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pp2(tmp_path_factory):
    """Every data-1 x pipe-2 job in one spawn, with the JAX inputs."""
    tmp = tmp_path_factory.mktemp("pp2")
    rng = np.random.RandomState(1234)
    tv = JaxTinyPP().init(0)
    tw = tiny_weights(tv["params"])
    tv3 = JaxTinyPP(depth=3).init(0)
    feats, labels = tiny_data(7)
    depth, d = 4, 8
    gp = {"kind": "gpipe", "microbatches": 4,
          "ws": rng.randn(depth, d, d).astype(np.float32) * 0.3,
          "x": rng.randn(8, 3, d).astype(np.float32),
          "cot": rng.randn(8, 3, d).astype(np.float32)}
    xsq = rng.randn(8, 2, 8, 8, 3).astype(np.float32)
    vit = JaxMobileViT(num_classes=13, attention_backend="xla",
                       **VIT_PP_ARCH)
    _no_dropout(vit, torch.nn.Module())
    vv = vit.init(0)
    vfeats = rng.randint(0, 256, (1, 1, 2, 8, 64, 64, 3)).astype(np.uint8)
    vlabels = rng.randint(0, 13, (1, 1, 2)).astype(np.int32)
    jobs = {
        "gpipe": gp,
        "m2": step_job(tw, feats, labels),
        "m4": step_job(tw, feats, labels, arch={"microbatches": 4}),
        "clip": step_job(tw, feats[:1], labels[:1], max_grad_norm=MAX_NORM),
        "depth3": step_job(tiny_weights(tv3["params"]), feats, labels,
                           arch={"depth": 3}),
        "dropout": step_job(tw, feats[:1], labels[:1],
                            arch={"dropout": 0.3}),
        "square": {"kind": "square_grads", "weights": tw, "x": xsq},
        "vit": step_job(vit_weights(vv), vfeats, vlabels, model="mobilevit",
                        arch=VIT_PP_ARCH, max_grad_norm=1.0),
    }
    port = run_mesh_jobs(tmp, {"pipe": 2}, jobs)
    inputs = dict(tiny=(tv, tw, feats, labels), depth3=tv3, gpipe=gp,
                  xsq=xsq, vit=(vit, vv, vfeats, vlabels))
    return port, inputs


def test_gpipe_apply_matches_serial_loop(pp2):
    """The schedule alone, 4 tanh layers over 2 stages at M = 4: output,
    input gradient and (summed over 'pipe') layer gradients against the
    serial loop, on both ranks; M + P - 2 = 4 hops forward and 4 back,
    the exit's all-reduce forward and the entry's backward."""
    port, inputs = pp2
    job = inputs["gpipe"]
    ws = torch.tensor(job["ws"], requires_grad=True)
    x = torch.tensor(job["x"], requires_grad=True)
    h = x
    for i in range(ws.shape[0]):
        h = torch.tanh(h @ ws[i])
    (h * torch.tensor(job["cot"])).sum().backward()
    mb_bytes = 2 * 3 * 8 * 4
    for got in port["gpipe"]:
        np.testing.assert_allclose(got["out"].numpy(), h.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["dx"].numpy(), x.grad.numpy(),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got["dws"].numpy(), ws.grad.numpy(),
                                   rtol=1e-4, atol=1e-5)
        assert {k: v for k, v in got["counts"].items() if v["count"]} == {
            "collective-permute": {"count": 8, "bytes": 8 * mb_bytes},
            "all-reduce": {"count": 2, "bytes": 2 * 8 * 3 * 8 * 4}}


@pytest.mark.parametrize("micro", [2, 4])
def test_pp_step_matches_jax_pp_step(pp2, micro):
    """pipe 2 at M = 2 and M = 4: 2 f32 AdamW steps against the JAX PP
    step (data 1 x pipe 2) at the JAX test's tolerances; the ranks hold
    the same weights and both stacks ran pipelined."""
    port, inputs = pp2
    tv, _, feats, labels = inputs["tiny"]
    ref = jax_mesh_steps(JaxTinyPP(pipeline_axis="pipe", microbatches=micro),
                         tv, AdamW(weight_decay=WD), feats, labels,
                         {"data": 1, "pipe": 2})
    got = port[f"m{micro}"]
    assert_steps_match(got, ref)
    for r in got:
        assert r["pp_engaged"] == ["transformer"]


@pytest.mark.parametrize("micro", [2, 4])
def test_pp_first_step_gradients_are_the_one_process_ones(pp2, micro):
    """The PP step's first-step gradients (after its sum over 'pipe'), on
    every rank, against the port's one-process step and the JAX unsharded
    gradient, every leaf within 1e-5 of its max|ref|."""
    port, inputs = pp2
    tv, tw, feats, labels = inputs["tiny"]
    _, one = port_one_process(tw, feats, labels)
    unsharded = jax_grads(JaxTinyPP(), tv, feats, labels)
    assert_grads_close(one, unsharded, label="one process vs JAX")
    for r, got in enumerate(port[f"m{micro}"]):
        assert_grads_close(got["grads"], one, label=f"rank {r}")
        assert_grads_close(got["grads"], unsharded, label=f"rank {r} JAX")


def test_pp_clip_matches_one_process(pp2):
    """The global-norm clip under PP (every leaf replicated over 'pipe'
    after the sum): the norm and the step against the one-process
    step's."""
    port, inputs = pp2
    _, tw, feats, labels = inputs["tiny"]
    ref, _ = port_one_process(tw, feats[:1], labels[:1],
                              max_grad_norm=MAX_NORM)
    assert ref[0][1] > MAX_NORM
    for got in port["clip"]:
        np.testing.assert_allclose(got["grad_norm"][0], ref[0][1],
                                   rtol=1e-5)
        for k, v in ref[0][2].items():
            np.testing.assert_allclose(got["states"][0][k].numpy(),
                                       v.numpy(), rtol=1e-4, atol=2 * LR)


def test_jax_pp_gradient_factor_beside_the_ports(pp2):
    """The JAX PP gradient, as its step takes it (inside shard_map,
    check_vma off), of sum(out^2) on TinyTransformer at data 1 x pipe 2
    against the unsharded one: rank 0 holds 2x on every stack leaf and
    upstream of the stack (embed), 1x on the head; rank 1 2x on the stack
    and 0 upstream. The port's gradient (after its sum over 'pipe') is
    1x everywhere on both ranks. Kept as a record of the JAX package's
    fault, which the port does not copy (ROADMAP.md, section C)."""
    from jax import shard_map
    port, inputs = pp2
    tv = inputs["tiny"][0]
    x = jnp.asarray(inputs["xsq"])
    ref_m, pp_m = JaxTinyPP(), JaxTinyPP(pipeline_axis="pipe")

    def square(model):
        def loss(params):
            out, _ = model.apply({"params": params, "state": tv["state"]},
                                 x, train=False, policy=DtypePolicy.f32())
            return jnp.sum(out ** 2)
        return loss

    ref = tiny_weights(jax.grad(square(ref_m))(tv["params"]))
    mesh = make_mesh(data=1, pipe=2, devices=jax.devices()[:2])
    per_rank = jax.jit(shard_map(
        lambda p: jax.tree_util.tree_map(lambda g: g[None],
                                         jax.grad(square(pp_m))(p)),
        mesh=mesh, in_specs=(P(),), out_specs=P("pipe"),
        check_vma=False))(tv["params"])

    def factors(grads):
        out = {}
        for k, g in grads.items():
            w = ref[k].numpy().astype(np.float64)
            out[k] = float(np.sum(np.asarray(g, np.float64) * w)
                           / np.sum(w * w))
        return out

    jax_rank = [factors(tiny_weights(jax.tree_util.tree_map(
        lambda g: g[r], per_rank))) for r in range(2)]
    for k in ref:
        part = k.split(".")[0]
        want = ({"head": 1.0, "embed": 2.0, "transformer": 2.0}[part],
                {"head": 1.0, "embed": 0.0, "transformer": 2.0}[part])
        for r in range(2):
            assert abs(jax_rank[r][k] - want[r]) < 1e-4, (r, k, jax_rank[r])
    for r, got in enumerate(port["square"]):
        assert_grads_close(got, ref, label=f"port rank {r}")


def test_pp_falls_back_when_depth_indivisible(pp2):
    """depth 3 over pipe 2: the plain loop runs (no stack engaged, no sum
    over 'pipe') and the steps match the unsharded JAX step."""
    port, inputs = pp2
    tv3 = inputs["depth3"]
    _, _, feats, labels = inputs["tiny"]
    ref = jax_mesh_steps(JaxTinyPP(depth=3), tv3, AdamW(weight_decay=WD),
                         feats, labels, {"data": 1})
    got = port["depth3"]
    assert_steps_match(got, ref)
    for r in got:
        assert r["pp_engaged"] == []
        assert all(not c["collective-permute"]["count"]
                   for c in r["counts"])


def test_pp_dropout_path_runs(pp2):
    """Dropout under PP draws from (layer, microbatch)-keyed streams: not
    comparable with one process, but finite, and the ranks agree."""
    port, _ = pp2
    got = port["dropout"]
    for r in got:
        assert np.isfinite(r["loss"][0]).all()
        for k, v in r["states"][0].items():
            assert torch.equal(v, got[0]["states"][0][k])


def test_pp_collective_counts_from_shapes(pp2):
    """Per PP step of the tiny model (batch 8, N = 8 tokens of width 32,
    f32, two layers at pipe 2, M microbatches of 8/M): M hops forward and
    M back of one (8/M, 8, 32) microbatch (M + P - 2 = M ticks with a
    hop), the exit's all-reduce of (8, 8, 32) forward and the entry's
    backward, and the stack's parameter gradients (2 x 8192) summed over
    'pipe'; no data reduction (one replica)."""
    port, _ = pp2
    act = 8 * 8 * 32 * 4
    for micro in (2, 4):
        want = {"collective-permute": {"count": 2 * micro,
                                       "bytes": 2 * micro * act // micro},
                "all-reduce": {"count": 3,
                               "bytes": 2 * act + 2 * 8192 * 4}}
        for got in port[f"m{micro}"]:
            for counts in got["counts"]:
                assert {k: v for k, v in counts.items()
                        if v["count"]} == want


def test_mobilevit_pp_step_matches_jax(pp2):
    """The slice as a whole: MobileViT at a small width (dims 16; depths
    2, 2, 1: stages 1 and 2 pipeline, stage 3 runs the plain loop), 8x64x64
    clips, batch 2, pipe 2: one f32 step with the clip against the
    one-process JAX step (the JAX PP step's clip norm is inflated, see the
    module docstring); the two stacks that engage."""
    port, inputs = pp2
    vit, vv, feats, labels = inputs["vit"]
    ref = jax_mesh_steps(vit, vv, AdamW(weight_decay=WD), feats, labels,
                         {"data": 1}, max_grad_norm=1.0)
    got = port["vit"]
    assert_steps_match(got, ref, weights_of=lambda p: vit_weights(
        {"params": p, "state": {}}))
    for r in got:
        assert r["pp_engaged"] == ["trunk.0.1.transformer",
                                   "trunk.1.1.transformer"]


# --------------------------------------------------------------------------
# 4 ranks: pipe 2 x model 2, pipe 2 x seq 2
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pp4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp4")
    tv = JaxTinyPP().init(0)
    feats, labels = tiny_data(11)
    out = {}
    for axis in ("model", "seq"):
        (tmp / axis).mkdir()
        out[axis] = run_mesh_jobs(
            tmp / axis, {"pipe": 2, axis: 2},
            {"step": step_job(tiny_weights(tv["params"]), feats, labels)})
    return out, (tv, feats, labels)


@pytest.mark.parametrize("axis", ["model", "seq"])
def test_pp_composes_with_tp_and_sp(pp4, axis):
    """pipe 2 x model 2 (each stage's FFNs Megatron-sharded) and pipe 2 x
    seq 2 (tokens scattered first, ring attention inside each tick): 2 f32
    AdamW steps against the JAX step on the same mesh."""
    port, (tv, feats, labels) = pp4
    jm = (JaxTinyPP(pipeline_axis="pipe", model_axis="model")
          if axis == "model" else
          JaxTinyPP(pipeline_axis="pipe", sequence_axis="seq"))
    ref = jax_mesh_steps(jm, tv, AdamW(weight_decay=WD), feats, labels,
                         {"data": 1, "pipe": 2, axis: 2},
                         rules=MOBILEVIT_TP_RULES if axis == "model"
                         else None, shard_degree=2 if axis == "model" else 1)
    got = port[axis]["step"]
    assert_steps_match(got, ref)
    for r in got:
        assert r["pp_engaged"] == ["transformer"]
        assert r["sp_engaged"] == (["transformer"] if axis == "seq" else [])


# --------------------------------------------------------------------------
# no process needed
# --------------------------------------------------------------------------

def test_pp_axis_must_be_distinct():
    from picklebot_tpu_torch.models.mobilevit import TransformerStack
    with pytest.raises(ValueError, match="distinct"):
        TransformerStack(32, 2, 4, 8, 64, model_axis="model",
                         pipeline_axis="model")
    with pytest.raises(ValueError, match="distinct"):
        TransformerStack(32, 2, 4, 8, 64, sequence_axis="seq",
                         pipeline_axis="seq")


def test_config_validates_pipeline_keys():
    """The port's Config takes and checks the PP keys as the JAX one
    does; the registry builds a PP model once the mesh has the axis."""
    from picklebot_tpu_torch.models.registry import initialize_model
    from picklebot_tpu_torch.utils.config import Config

    def cfg(**kw):
        return Config(model_name="MobileViT", batch_size=4,
                      effective_batch_size=4, data_backend="synthetic",
                      dims=[32, 32, 32],
                      channels=[8, 8, 8, 8, 16, 16, 16, 16, 16, 16, 32],
                      **kw).validate()

    assert cfg(pipeline_parallel=2).pipeline_parallel == 2
    assert cfg(pipeline_microbatches=2).pipeline_microbatches == 2
    with pytest.raises(ValueError, match="divide batch_size"):
        cfg(pipeline_microbatches=3)
    with pytest.raises(ValueError, match="MobileViT"):
        Config(model_name="MobileNetLarge3D", batch_size=4,
               effective_batch_size=4, data_backend="synthetic",
               pipeline_parallel=2).validate()
    with pytest.raises(ValueError, match="init_mesh"):
        initialize_model(cfg(pipeline_parallel=2))


def test_pp_stack_engages_by_the_jax_rule():
    """The stack pipelines only where the axis divides the depth and the
    microbatches divide the batch (default: the axis size)."""
    from picklebot_tpu_torch.models.mobilevit import TransformerStack
    from picklebot_tpu_torch.parallel import mesh
    saved = dict(mesh._MESH), mesh._MESH_SHAPE
    try:
        mesh._MESH["pipe"] = mesh._Axis(2, 0, [0, 1])
        two = TransformerStack(32, 2, 4, 8, 64, pipeline_axis="pipe")
        assert two.pp_active(8) and not two.pp_active(3)
        three = TransformerStack(32, 3, 4, 8, 64, pipeline_axis="pipe")
        assert not three.pp_active(8)
        four = TransformerStack(32, 2, 4, 8, 64, pipeline_axis="pipe",
                                pipeline_microbatches=4)
        assert four.pp_active(8) and not four.pp_active(6)
    finally:
        mesh._MESH.clear()
        mesh._MESH.update(saved[0])
        mesh._MESH_SHAPE = saved[1]
