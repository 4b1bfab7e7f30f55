"""Port: the MoE feed-forward (``ops/moe.py``) and expert parallelism (the
'expert' axis of ``parallel/mesh.py``, the EP step, its optimizer state,
snapshots and ``.pth``, serving and export) against the JAX package's
``MoEFeedForward`` and EP step.

Ranks and job files are ``test_torch_pp.py``'s (``MESH_WORKER``); the JAX
side runs on the 8 virtual CPU devices. Tolerances: the module against
the JAX module (routing, outputs, aux loss, gradients) within 1e-6 of
each tensor's max|ref|; the sharded module against the unsharded one, and
first-step gradients of the EP step, within 1e-5 of max|ref|; the EP step
after AdamW steps at the JAX tests' tolerances (``tests/test_moe.py``:
losses 1e-5, parameters rtol 1e-4 atol 3e-3) and AdamW8bit at the 8-bit
ones of ``tests/test_torch_tp.py`` (losses 5e-4, rtol 1e-3 atol 5e-3: the
port quantizes its (h, d, E/size) shards in 256-blocks, the JAX package
its (E/size, d, h) ones).
"""

import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from picklebot_tpu.core.module import DtypePolicy, flatten_dict
from picklebot_tpu.models.mobilevit import MobileViT as JaxMobileViT
from picklebot_tpu.ops.moe import MoEFeedForward as JaxMoE
from picklebot_tpu.parallel.mesh import MOBILEVIT_MOE_EP_RULES
from picklebot_tpu.train.optim import AdamW, AdamW8bit
from test_moe import TinyMoE as JaxTinyMoE
from test_torch_pp import (MAX_NORM, VIT_ARCH, Tiny, assert_grads_close,
                           assert_steps_match, jax_grads, jax_mesh_steps,
                           port_one_process, run_mesh_jobs, step_job,
                           tiny_weights, vit_weights)
from test_torch_tp import tiny_data
from test_torch_train_step import _no_dropout

WD = 1e-4
MOE_REL = 1e-6
D, H = 16, 32
VIT_MOE = dict(VIT_ARCH, moe_experts=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def moe_weights(params) -> dict:
    """A JAX MoEFeedForward's params -> the port module's state dict."""
    return {"router": torch.tensor(np.asarray(params["router"]).T.copy()),
            "w1": torch.tensor(np.asarray(params["w1"]).transpose(2, 1, 0)
                               .copy()),
            "w2": torch.tensor(np.asarray(params["w2"]).transpose(2, 1, 0)
                               .copy())}


def port_moe(e, top_k=2, cf=1.25, params=None, **kw):
    from picklebot_tpu_torch.ops.moe import MoEFeedForward
    mod = MoEFeedForward(D, H, e, top_k, cf, **kw)
    if params is not None:
        mod.load_state_dict(moe_weights(params))
    return mod


def jax_moe_loss_grads(mod, variables, x, c):
    """JAX value, output, aux and gradients (params, x) of sum(out * c) +
    0.01 aux."""
    def loss(p, x):
        out, ns = mod.apply({"params": p, "state": variables["state"]}, x,
                            train=False, policy=DtypePolicy.f32())
        return jnp.sum(out * c) + 0.01 * ns["aux_loss"], (out,
                                                          ns["aux_loss"])
    (val, (out, aux)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"],
                                            jnp.asarray(x))
    return (float(val), np.asarray(out), float(aux),
            {k: np.asarray(v) for k, v in moe_weights(gp).items()},
            np.asarray(gx))


def port_moe_loss_grads(mod, x, c):
    xt = torch.tensor(x, requires_grad=True)
    out = mod(xt)
    val = (out * torch.tensor(c)).sum() + 0.01 * mod.aux_loss
    val.backward()
    return (val.item(), out.detach().numpy(), mod.aux_loss.item(),
            {k: p.grad.numpy() for k, p in mod.named_parameters()},
            xt.grad.numpy())


def close(got, want, rel, label):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), (label, err)


# --------------------------------------------------------------------------
# the module against the JAX module, one process
# --------------------------------------------------------------------------

def test_moe_single_expert_equals_dense_mlp():
    """n_experts=1, top-1, capacity >= tokens: routing is the identity and
    the module computes silu(x @ w1) @ w2 (the JAX test's case)."""
    rng = np.random.RandomState(1234)
    jm = JaxMoE(D, H, n_experts=1, top_k=1, capacity_factor=1.0)
    v = jm.init(0)
    mod = port_moe(1, top_k=1, cf=1.0, params=v["params"])
    x = rng.randn(2, 3, 24, D).astype(np.float32)
    out = mod(torch.tensor(x)).detach().numpy()
    w1, w2 = (np.asarray(v["params"][k][0]) for k in ("w1", "w2"))
    h = x @ w1
    np.testing.assert_allclose(out, (h / (1 + np.exp(-h))) @ w2, rtol=1e-5,
                               atol=1e-6)


def test_moe_aux_loss_published_and_finite():
    """The aux loss is a per-forward value outside ``state_dict``: near 1
    for the near-uniform router at init, and no key of the state dict."""
    rng = np.random.RandomState(1234)
    mod = port_moe(4, params=JaxMoE(D, H, 4, top_k=2).init(0)["params"])
    mod(torch.tensor(rng.randn(2, 3, 24, D).astype(np.float32)))
    aux = mod.aux_loss.item()
    assert np.isfinite(aux) and 0.5 < aux < 2.0
    assert set(mod.state_dict()) == {"router", "w1", "w2"}


def test_moe_capacity_drops_overflow_tokens():
    """A capacity of one slot per expert: at most 2 of 64 tokens keep a
    row, the rest are exactly zero (their combine weight is zero)."""
    rng = np.random.RandomState(1234)
    jm = JaxMoE(8, 16, 2, top_k=1, capacity_factor=1e-6)
    from picklebot_tpu_torch.ops.moe import MoEFeedForward
    mod = MoEFeedForward(8, 16, 2, top_k=1, capacity_factor=1e-6)
    assert mod.capacity(64) == jm.capacity(64) == 1
    p = jm.init(0)["params"]
    mod.load_state_dict(moe_weights(p))
    x = rng.randn(1, 1, 64, 8).astype(np.float32)
    out = mod(torch.tensor(x)).detach().numpy()
    assert np.sum(np.all(out == 0.0, axis=-1)) >= 62
    ref, _ = jm.apply(jm.init(0), x, train=False, policy=DtypePolicy.f32())
    np.testing.assert_array_equal(out == 0.0, np.asarray(ref) == 0.0)


@pytest.mark.parametrize("n_experts,top_k,cf", [
    (4, 1, 1.25), (4, 2, 1.25), (4, 2, 0.5), (8, 2, 2.0)])
def test_moe_matches_jax_module(n_experts, top_k, cf):
    """Routing, outputs, aux loss and the gradients of sum(out * c) +
    0.01 aux (router, both banks, the input; the loss itself, a sum with
    cancellation, is left to them) against the JAX
    MoEFeedForward, each within 1e-6 of its max|ref|; the dropped tokens
    are the same ones (capacity factor 0.5 drops some)."""
    rng = np.random.RandomState(n_experts * 10 + top_k)
    jm = JaxMoE(D, H, n_experts, top_k=top_k, capacity_factor=cf)
    v = jm.init(0)
    x = rng.randn(2, 3, 24, D).astype(np.float32)
    c = rng.randn(2, 3, 24, D).astype(np.float32)
    want = jax_moe_loss_grads(jm, v, x, c)
    got = port_moe_loss_grads(port_moe(n_experts, top_k, cf, v["params"]),
                              x, c)
    close(got[1], want[1], MOE_REL, "out")
    close(got[2], want[2], MOE_REL, "aux")
    for k in want[3]:
        close(got[3][k], want[3][k], MOE_REL, k)
    close(got[4], want[4], MOE_REL, "dx")
    np.testing.assert_array_equal(np.all(got[1] == 0, -1),
                                  np.all(want[1] == 0, -1))


def test_moe_routes_by_the_jax_rule_on_ties():
    """A router of zeros (every gate equal): both pick expert 0 first and
    expert 1 second (the first maximum), so the same tokens queue, and
    the outputs agree."""
    rng = np.random.RandomState(5)
    jm = JaxMoE(D, H, 4, top_k=2, capacity_factor=0.5)
    v = jm.init(0)
    params = dict(v["params"], router=jnp.zeros((D, 4), jnp.float32))
    x = rng.randn(1, 2, 16, D).astype(np.float32)
    ref, _ = jm.apply({"params": params, "state": v["state"]}, x,
                      train=False, policy=DtypePolicy.f32())
    out = port_moe(4, 2, 0.5, params)(torch.tensor(x)).detach().numpy()
    close(out, np.asarray(ref), MOE_REL, "out")


# --------------------------------------------------------------------------
# data 1 x expert 2
# --------------------------------------------------------------------------

def moe_job(params, x, c, e, dispatch="replicated"):
    return {"kind": "moe", "weights": moe_weights(params), "x": x, "c": c,
            "d": D, "h": H, "e": e, "top_k": 2, "cf": 1.25,
            "dispatch": dispatch}


@pytest.fixture(scope="module")
def ep2(tmp_path_factory):
    """Every data-1 x expert-2 job in one spawn, with the JAX inputs."""
    tmp = tmp_path_factory.mktemp("ep2")
    rng = np.random.RandomState(1234)
    mv = JaxMoE(D, H, 8, top_k=2).init(0)
    x = rng.randn(2, 3, 24, D).astype(np.float32)
    c = rng.randn(2, 3, 24, D).astype(np.float32)
    x21 = rng.randn(2, 1, 21, D).astype(np.float32)
    c21 = rng.randn(2, 1, 21, D).astype(np.float32)
    tv = JaxTinyMoE().init(0)
    tw = tiny_weights(tv["params"])
    feats, labels = tiny_data(9)
    vit = JaxMobileViT(num_classes=13, attention_backend="xla", **VIT_MOE)
    _no_dropout(vit, torch.nn.Module())
    vv = vit.init(0)
    vfeats = rng.randint(0, 256, (1, 1, 2, 8, 64, 64, 3)).astype(np.uint8)
    vlabels = rng.randint(0, 13, (1, 1, 2)).astype(np.int32)
    moe = {"experts": 4}
    jobs = {
        "rep": moe_job(mv["params"], x, c, 8),
        "tok": moe_job(mv["params"], x, c, 8, "tokens"),
        "tok21": moe_job(mv["params"], x21, c21, 8, "tokens"),
        "adamw": step_job(tw, feats, labels, arch=moe,
                          max_grad_norm=MAX_NORM),
        "adamw8bit": step_job(tw, feats, labels, "adamw8bit",
                              {"min_8bit_size": 1024}, arch=moe,
                              max_grad_norm=MAX_NORM, q8snap=True),
        "tokens": step_job(tw, feats, labels,
                           arch=dict(moe, dispatch="tokens"),
                           max_grad_norm=MAX_NORM),
        "grads": step_job(tw, feats[:1], labels[:1], arch=moe),
        "dropout": step_job(tw, feats[:1], labels[:1],
                            arch=dict(moe, dropout=0.3)),
        "vit": step_job(vit_weights(vv), vfeats, vlabels, model="mobilevit",
                        arch=VIT_MOE, max_grad_norm=1.0),
    }
    port = run_mesh_jobs(tmp, {"expert": 2}, jobs)
    return port, dict(moe=(mv, x, c, x21, c21), tiny=(tv, tw, feats, labels),
                      vit=(vit, vv, vfeats, vlabels))


def test_moe_ep_replicated_matches_unsharded(ep2):
    """dispatch 'replicated' at expert 2 (8 experts, 4 a rank): loss,
    output and every gradient (the router's included: its sum over
    'expert' and the aux term's 1/size) against the unsharded JAX
    module and the port's own, within 1e-5 of max|ref|."""
    port, inputs = ep2
    mv, x, c, _, _ = inputs["moe"]
    want = jax_moe_loss_grads(JaxMoE(D, H, 8, top_k=2), mv, x, c)
    one = port_moe_loss_grads(port_moe(8, params=mv["params"]), x, c)
    for r, got in enumerate(port["rep"]):
        for ref, label in ((want, "JAX"), (one, "port")):
            close(got["out"].numpy(), ref[1], 1e-5, f"{label} out {r}")
            close(got["aux"], ref[2], 1e-5, f"{label} aux {r}")
            close(got["dx"].numpy(), ref[4], 1e-5, f"{label} dx {r}")
            for k in ref[3]:
                close(got["grads"][k].numpy(), ref[3][k], 1e-5,
                      f"{label} {k} {r}")
        assert not got["warned"]


def test_moe_ep_tokens_matches_grouped_reference(ep2):
    """dispatch 'tokens' at expert 2: each rank routes its 12-token block
    as its groups; the output, aux and gradients equal the unsharded
    module applied to the tokens regrouped per rank (JAX and the
    port)."""
    port, inputs = ep2
    mv, x, c, _, _ = inputs["moe"]
    b, p, n = x.shape[:3]
    xg = x.reshape(b, p, 2, n // 2, D)
    cg = c.reshape(b, p, 2, n // 2, D)
    want = jax_moe_loss_grads(JaxMoE(D, H, 8, top_k=2), mv, xg, cg)
    one = port_moe_loss_grads(port_moe(8, params=mv["params"]), xg, cg)
    for r, got in enumerate(port["tok"]):
        for ref, label in ((want, "JAX"), (one, "port")):
            close(got["out"].numpy(), ref[1].reshape(x.shape), 1e-5,
                  f"{label} out {r}")
            close(got["aux"], ref[2], 1e-5, f"{label} aux {r}")
            close(got["dx"].numpy(), ref[4].reshape(x.shape), 1e-5,
                  f"{label} dx {r}")
            for k in ref[3]:
                close(got["grads"][k].numpy(), ref[3][k], 1e-5,
                      f"{label} {k} {r}")


def test_moe_ep_tokens_counts_and_fallback(ep2):
    """The tokens mode's collectives per forward and backward (2 x 3 x 24
    tokens of 16, E 8, capacity 4 per 12-token group, f32): the entry's
    all-gather backward and the exit's forward (the whole (2, 3, 24, 16)
    each), one all-reduce of the 16 routing statistics and one of the
    router's gradient, two all-to-alls each way of (8, 6, 4, 16) slots
    ((4, 12, 4, 16) after). N = 21 does not split over 2: a warning, and
    the replicated result."""
    port, inputs = ep2
    mv, _, _, x21, c21 = inputs["moe"]
    full = 2 * 3 * 24 * D * 4
    slots = 8 * 6 * 4 * D * 4
    want = {"all-gather": {"count": 2, "bytes": 2 * full},
            "all-reduce": {"count": 2, "bytes": 16 * 4 + 8 * D * 4},
            "all-to-all": {"count": 4, "bytes": 4 * slots}}
    ref = port_moe_loss_grads(port_moe(8, params=mv["params"]), x21, c21)
    for got in port["tok"]:
        assert {k: v for k, v in got["counts"].items()
                if v["count"]} == want
    for got in port["tok21"]:
        assert any("falling back" in w for w in got["warned"])
        close(got["out"].numpy(), ref[1], 1e-5, "fallback out")


@pytest.mark.parametrize("job", ["adamw", "adamw8bit", "tokens"])
def test_ep_step_matches_jax_ep_step(ep2, job):
    """data 1 x expert 2, TinyMoE (E 4, two layers): 2 steps with the
    global-norm clip on (the clip sums the expert banks' squares over
    'expert'), f32 AdamW and AdamW8bit with per-shard blocks in
    'replicated' dispatch and AdamW in 'tokens', against the JAX EP step
    on the same mesh; the ranks end with the same weights."""
    port, inputs = ep2
    tv, _, feats, labels = inputs["tiny"]
    opt = (AdamW8bit(weight_decay=WD, min_8bit_size=1024)
           if job == "adamw8bit" else AdamW(weight_decay=WD))
    dispatch = "tokens" if job == "tokens" else "replicated"
    ref = jax_mesh_steps(JaxTinyMoE(expert_axis="expert",
                                    moe_dispatch=dispatch),
                         tv, opt, feats, labels, {"data": 1, "expert": 2},
                         max_grad_norm=MAX_NORM,
                         rules=MOBILEVIT_MOE_EP_RULES, shard_degree=2)
    assert ref[0][1] > MAX_NORM         # the clip engaged
    tol = (dict(loss_tol=5e-4, rtol=1e-3, atol=5e-3) if job == "adamw8bit"
           else {})
    assert_steps_match(port[job], ref, **tol)


def test_ep_first_step_gradients_are_the_one_process_ones(ep2):
    """The EP step's first-step gradients (the banks gathered over
    'expert') against the port's one-process step and the JAX unsharded
    gradient (aux loss included), every leaf within 1e-5 of its
    max|ref|; the clip's norm against the one-process one."""
    port, inputs = ep2
    tv, tw, feats, labels = inputs["tiny"]
    _, one = port_one_process(tw, feats, labels, experts=4)
    unsharded = jax_aux_grads(tv, feats, labels)
    assert_grads_close(one, unsharded, label="one process vs JAX")
    for r, got in enumerate(port["grads"]):
        assert_grads_close(got["grads"], one, label=f"rank {r}")
    ref, _ = port_one_process(tw, feats, labels, steps=2, experts=4,
                              max_grad_norm=MAX_NORM)
    for got in port["adamw"]:
        np.testing.assert_allclose(got["grad_norm"], [s[1] for s in ref],
                                   rtol=1e-5)


def jax_aux_grads(tv, feats, labels):
    """The JAX unsharded TinyMoE gradient of CE + 0.01 aux on the first
    microbatch, in ``Tiny``'s keys."""
    from picklebot_tpu.train.losses import cross_entropy
    from picklebot_tpu.train.step import collect_aux_losses
    model = JaxTinyMoE()
    x = jnp.asarray(feats[0, 0].astype(np.float32) / 255.0)
    lbl = jnp.asarray(labels[0, 0], jnp.int32)

    def loss(params):
        out, st = model.apply({"params": params, "state": tv["state"]}, x,
                              train=False, policy=DtypePolicy.f32())
        return cross_entropy(out, lbl) + 0.01 * collect_aux_losses(st)

    return tiny_weights(jax.grad(loss)(tv["params"]))


def test_ep_8bit_snapshot_layout_and_reslice(ep2):
    """The snapshot's AdamW8bit moments of the expert banks in the JAX EP
    layout (each rank's (h, d, 2) shard in its own 256-blocks, stacked by
    expert rank; ``shard_axes`` 'expert', ``expert_parallel`` 2), cut back
    exactly for each rank."""
    port, _ = ep2
    for r, got in enumerate(port["adamw8bit"]):
        snap = got["snap"]
        assert snap["expert_parallel"] == 2
        assert "model_parallel" not in snap
        axes = [a for a in snap["shard_axes"] if a is not None]
        assert axes == ["expert"] * 4
        for part in ("m", "v"):
            for a, b in zip(got["back"][part], got["local"][part]):
                a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
                assert all(torch.equal(x, y) for x, y in zip(a, b))
        for i, (shape, dim) in enumerate(zip(snap["shapes"],
                                             snap["tp_dims"])):
            if dim is None:
                continue
            assert dim == 2 and shape[2] == 4
            blocks_local = -(-int(np.prod(shape)) // 2 // 256)
            assert snap["m"][i][0].shape == (2 * blocks_local, 256)


def test_ep_dropout_path_runs(ep2):
    """Expert-MLP dropout under EP: finite, the ranks agree."""
    port, _ = ep2
    got = port["dropout"]
    for r in got:
        assert np.isfinite(r["loss"][0]).all()
        for k, v in r["states"][0].items():
            assert torch.equal(v, got[0]["states"][0][k])


def test_ep_collective_counts_from_shapes(ep2):
    """Per EP step of TinyMoE in 'replicated' dispatch (batch 8, 8 tokens
    of 32, two layers, f32): per layer f's all-reduce of the input's and
    the router's gradients backward and g's of the (8, 8, 32) output
    forward; the clip's one all-reduce of the 4 expert banks' squares
    over 'expert'; no data reduction (one replica)."""
    port, _ = ep2
    act = 8 * 8 * 32 * 4
    router = 4 * 32 * 4
    want = {"all-reduce": {"count": 2 * 3 + 1,
                           "bytes": 2 * (2 * act + router) + 4 * 4}}
    for got in port["adamw"]:
        for counts in got["counts"]:
            assert {k: v for k, v in counts.items() if v["count"]} == want
        assert got["local_numel"] == sum(
            v.numel() for v in tiny_weights(ep2[1]["tiny"][0]["params"])
            .values()) - 2 * 2 * 32 * 64 * 2


def test_mobilevit_ep_step_matches_jax(ep2):
    """The slice as a whole: MoE MobileViT at a small width (dims 16,
    depth 1 per stage, E 4 top-2), 8x64x64 clips, batch 2, expert 2: one
    f32 step with the clip against the JAX EP step."""
    port, inputs = ep2
    vit, vv, feats, labels = inputs["vit"]
    jm = JaxMobileViT(num_classes=13, attention_backend="xla",
                      expert_axis="expert", **VIT_MOE)
    _no_dropout(jm, torch.nn.Module())
    ref = jax_mesh_steps(jm, vv, AdamW(weight_decay=WD), feats, labels,
                         {"data": 1, "expert": 2}, max_grad_norm=1.0,
                         rules=MOBILEVIT_MOE_EP_RULES, shard_degree=2)
    assert_steps_match(port["vit"], ref, weights_of=lambda p: vit_weights(
        {"params": p, "state": {}}))


# --------------------------------------------------------------------------
# one process: remat, the .pth both ways, serving and export
# --------------------------------------------------------------------------

def test_moe_remat_with_dropout_keeps_the_kept_forwards_aux():
    """TinyMoE with dropout 0.3 under remat 2 against remat 0 from the
    same weights and seed: the same losses and updated weights (the
    recompute replays the dropout masks), and the step adds the aux loss
    of the forward autograd keeps (a remat step that read the recompute's
    would still match; one that missed the aux would not)."""
    from picklebot_tpu_torch.core.policy import DtypePolicy as TorchPolicy
    from picklebot_tpu_torch.train.optim import AdamW as TorchAdamW
    from picklebot_tpu_torch.train.optim import cosine_annealing_lr
    from picklebot_tpu_torch.train.step import make_train_step
    tw = tiny_weights(JaxTinyMoE().init(0)["params"])
    feats, labels = tiny_data(3)
    runs = []
    for remat, aux_weight in ((0, 0.01), (2, 0.01), (0, 0.0)):
        m = Tiny(experts=4, dropout=0.3)
        m.load_state_dict(tw)
        opt = TorchAdamW(m.parameters(), weight_decay=WD)
        step = make_train_step(m, opt, "CE", cosine_annealing_lr(1e-3, 10),
                               TorchPolicy.f32(), device="cpu", remat=remat,
                               moe_aux_weight=aux_weight)
        met = step(0, feats[0], labels[0])
        runs.append((met["loss"], {k: v.clone() for k, v in
                                   m.state_dict().items()}))
    (l0, s0), (l2, s2), (_, s_noaux) = runs
    torch.testing.assert_close(l2, l0, rtol=1e-6, atol=1e-7)
    for k in s0:
        torch.testing.assert_close(s2[k], s0[k], rtol=1e-6, atol=5e-7)
    router = "transformer.ffs.0.router"
    assert not torch.equal(s0[router], s_noaux[router])


def test_moe_pth_round_trip_both_ways(tmp_path):
    """A MoE MobileViT's .pth: the JAX export (router (E, d), banks with
    every axis reversed, no aux_loss) loads strictly into the port with
    the same values, and the port's state dict loads strictly into the
    JAX model (``load_pth`` with the MobileViT key map) with the same
    values."""
    from picklebot_tpu.train import checkpoint as jax_ckpt
    from picklebot_tpu.train.key_maps import key_map_for
    from picklebot_tpu_torch.models.mobilevit import MobileViT
    jm = JaxMobileViT(num_classes=13, attention_backend="xla", **VIT_MOE)
    v = jm.init(3)
    port = MobileViT(num_classes=13, seed=1, **VIT_MOE)
    path = tmp_path / "jax.pth"
    jax_ckpt.save_pth(str(path), v, reverse_map=jax_ckpt.build_reverse_map(
        port.state_dict().keys(), key_map_for("MobileViT")))
    sd = torch.load(str(path), weights_only=True)
    assert not any(k.endswith("aux_loss") for k in sd)
    assert tuple(sd["trunk.0.1.transformer.ffs.0.w1"].shape) == (32, 16, 4)
    port.load_state_dict(sd, strict=True)
    want = vit_weights(v)
    for k, t in port.state_dict().items():
        if k in want:
            assert torch.equal(t, want[k]), k
    back = tmp_path / "port.pth"
    torch.save(MobileViT(num_classes=13, seed=5, **VIT_MOE).state_dict(),
               str(back))
    v2 = jax_ckpt.load_pth(str(back), jm.init(99),
                           key_map=key_map_for("MobileViT"))
    again = vit_weights(v2)
    src = torch.load(str(back), weights_only=True)
    for k, t in again.items():
        assert torch.equal(t, src[k]), k


def test_moe_jax_param_paths():
    """``convert.jax_param_path`` names the MoE leaves by their JAX paths
    (the SE rule for w1/w2 does not reach them)."""
    from picklebot_tpu_torch.convert import jax_param_path
    from picklebot_tpu_torch.models.mobilevit import MobileViT
    m = MobileViT(num_classes=13, **VIT_MOE)
    jm = JaxMobileViT(num_classes=13, **VIT_MOE)
    paths = set(flatten_dict(jm.init(0)["params"]))
    for name, _ in m.named_parameters():
        assert jax_param_path(m, name, "MobileViT") in paths, name


@pytest.fixture(scope="module")
def ep_loop(tmp_path_factory):
    """train() at 2 ranks with expert_parallel 2 (MoE MobileViT, small
    width) and with pipeline_parallel 2."""
    from test_torch_dp import run_loop
    tmp = tmp_path_factory.mktemp("ep_loop")
    run_loop(tmp, "ep", **EP_LOOP)
    run_loop(tmp, "pp", **PP_LOOP)
    return tmp


EP_LOOP = {"model_name": "MobileViT", "moe_experts": 4,
           "expert_parallel": 2, "attention_backend": "xla",
           "dims": VIT_ARCH["dims"], "channels": VIT_ARCH["channels"],
           "synthetic_len": 12, "synthetic_shape": [8, 32, 32],
           "max_frames": 8, "t_bucket": 8}
PP_LOOP = dict(EP_LOOP, moe_experts=0, expert_parallel=1,
               pipeline_parallel=2)
FINISHED = "MobileViT_CrossEntropyLoss()_finished"


@pytest.mark.parametrize("tag", ["ep", "pp"])
def test_loop_at_two_ranks_writes_full_leaves(ep_loop, tag):
    """train() with expert_parallel 2 and with pipeline_parallel 2: the
    ranks end with the same weights (full leaves, the EP banks gathered),
    rank 0 alone writes, the snapshot records the EP layout, and the
    .pth loads strictly into one process."""
    from picklebot_tpu_torch.models.mobilevit import MobileViT
    from picklebot_tpu_torch.train import checkpoint as ckpt
    tmp = ep_loop
    snap = ckpt.load_checkpoint(str(tmp / f"{tag}_rank0" / "ck" / FINISHED
                                    / "step_2"))
    assert not (tmp / f"{tag}_rank1" / "ck" / "MobileViT").exists()
    arch = {k: VIT_ARCH[k] for k in ("dims", "channels")}
    one = MobileViT(num_classes=13, moe_experts=4 if tag == "ep" else 0,
                    **arch)
    one.load_state_dict(snap["model"], strict=True)
    pth = tmp / f"{tag}_rank0" / "ck" / f"{FINISHED}.pth"
    one.load_state_dict(torch.load(str(pth), weights_only=True), strict=True)
    if tag == "ep":
        assert snap["optimizer"]["expert_parallel"] == 2
        assert tuple(snap["model"]["trunk.0.1.transformer.ffs.0.w1"].shape
                     )[2] == 4


def test_ep_snapshot_resumes_bit_equal(ep_loop):
    """The EP run's epoch-0 snapshot resumed at 2 ranks ends bit for bit
    where the uninterrupted run ended (weights and AdamW moments)."""
    from test_torch_dp import run_loop
    from picklebot_tpu_torch.train import checkpoint as ckpt
    tmp = ep_loop
    start = tmp / "ep_rank0" / "ck" / "MobileViT" / "step_0"
    run_loop(tmp, "ep_resume", checkpoint=str(start), **EP_LOOP)
    a = ckpt.load_checkpoint(str(tmp / "ep_rank0" / "ck" / FINISHED
                                 / "step_2"))
    b = ckpt.load_checkpoint(str(tmp / "ep_resume_rank0" / "ck" / FINISHED
                                 / "step_2"))
    for key in a["model"]:
        assert torch.equal(a["model"][key], b["model"][key]), key
    for part in ("m", "v"):
        for x, y in zip(a["optimizer"][part], b["optimizer"][part]):
            assert torch.equal(x, y)


def test_ep_config_serves_and_exports_replicated(ep_loop, tmp_path, capsys):
    """An EP config serves (``replicated_equivalent`` drops
    expert_parallel, the experts stay) its run's .pth in one process, and
    exports it: the exported program (routing's argmax, cumsum and index
    writes at static shapes, batch 3) gives the eager logits."""
    from picklebot_tpu_torch import export as ex
    from picklebot_tpu_torch import serve
    tmp = ep_loop
    cfg = str(tmp / "ep.json")
    pth = str(tmp / "ep_rank0" / "ck" / f"{FINISHED}.pth")
    rc = serve.main([cfg, "--checkpoint", pth, "--csv", "x", "--limit", "4",
                     "--batch", "2", "--device", "cpu"])
    assert rc == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "evaluated"] == 4
    out = tmp_path / "moe.pt2"
    assert ex.main([cfg, "--checkpoint", pth, "--out", str(out), "--frames",
                    "8", "--size", "32", "--batch", "3", "--device",
                    "cpu"]) == 0
    predict, meta = ex.load_artifact(str(out), "cpu")
    from picklebot_tpu_torch.convert import load_pth
    from picklebot_tpu_torch.core.policy import DtypePolicy as TorchPolicy
    from picklebot_tpu_torch.models.registry import initialize_model
    from picklebot_tpu_torch.train.step import make_predict_fn
    from picklebot_tpu_torch.utils.config import (load_config,
                                                  replicated_equivalent)
    config = replicated_equivalent(load_config(cfg))
    assert config.moe_experts == 4 and config.expert_parallel == 1
    model = load_pth(pth, initialize_model(config))
    feats = np.random.RandomState(2).randint(
        0, 256, (3, 8, 32, 32, 3)).astype(np.uint8)
    eager = make_predict_fn(model, TorchPolicy.f32(), device="cpu")(feats)
    np.testing.assert_allclose(predict(feats), eager, rtol=1e-5, atol=1e-5)


def test_registry_builds_ep_and_refuses_without_the_mesh():
    """The registry takes moe_experts and expert_parallel: an unsharded
    MoE model at expert 1, a refusal naming init_mesh at expert 2 without
    the mesh; the composition rules of the JAX stack."""
    from picklebot_tpu_torch.models.mobilevit import TransformerStack
    from picklebot_tpu_torch.models.registry import initialize_model
    from picklebot_tpu_torch.ops.moe import MoEFeedForward
    from picklebot_tpu_torch.utils.config import Config
    base = dict(model_name="MobileViT", dims=VIT_ARCH["dims"],
                channels=VIT_ARCH["channels"], moe_experts=4)
    m = initialize_model(Config(**base).validate())
    ff = m.trunk[0][1].transformer.ffs[0]
    assert isinstance(ff, MoEFeedForward) and ff.expert_axis is None
    with pytest.raises(ValueError, match="init_mesh"):
        initialize_model(Config(expert_parallel=2, **base).validate())
    for kw in ({"model_axis": "model"}, {"sequence_axis": "seq"},
               {"pipeline_axis": "pipe"}):
        with pytest.raises(ValueError, match="composes with"):
            TransformerStack(32, 1, 4, 8, 64, moe_experts=4, **kw)
    with pytest.raises(ValueError, match="top_k"):
        MoEFeedForward(16, 32, n_experts=1, top_k=2)
