"""Port: sequence parallelism (``parallel/sequence.py``,
``ops/ring_attention.py``, ``MultiHeadAttention`` and
``TransformerStack`` with ``sequence_axis``, the 'seq' axis of the step)
against the JAX package's sharded functions.

The ranks and the job files are ``test_torch_tp.py``'s (``LAYOUT_WORKER``,
gloo subprocesses laid out as the JAX mesh); the JAX side runs on the 8
virtual CPU devices. Tolerances are the JAX tests' own
(``tests/test_sequence_parallel.py``): ring attention's output rtol/atol
1e-5 and its gradients rtol 1e-4 atol 1e-5; a train step's losses 1e-5
and parameters after Adam steps rtol 1e-4 atol 3e-3; gradients rtol 1e-5
atol 1e-6.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from picklebot_tpu.core.module import Ctx, DtypePolicy, Module
from picklebot_tpu.models.mobilevit import (MobileViT as JaxMobileViT,
                                            TransformerStack as JaxStack)
from picklebot_tpu.ops.attention import sdpa_xla
from picklebot_tpu.ops.linear import Dense
from picklebot_tpu.train.losses import cross_entropy
from picklebot_tpu.train.optim import AdamW
from test_sequence_parallel import TinyTransformer as JaxTiny
from test_torch_tp import (VIT_ARCH, WD,
                           assert_step_matches, jax_sharded_steps,
                           run_layout_jobs, step_job, tiny_data,
                           tiny_torch_weights)
from test_torch_train_step import _no_dropout

SCALE = 0.25
# stages of 27, 8 and 2 tokens: stage 1 falls back at seq 2, as
# MobileViT-s's stage 2 (N = 147) does
SP_VIT_CLIP = (8, 48, 48, 3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class JaxTinyN(Module):
    """The JAX fallback test's Tiny6 with ``tokens_in`` features a token:
    a (B, 2, 8, 24, 1) clip is 384 / tokens_in tokens, one layer."""

    def __init__(self, tokens_in=64, sequence_axis=None):
        super().__init__()
        self.tokens_in = tokens_in
        self.embed = Dense(tokens_in, 32)
        self.transformer = JaxStack(32, depth=1, heads=4, dim_head=8,
                                    ffw_dim=64, backend="xla",
                                    sequence_axis=sequence_axis)
        self.head = Dense(32, 13)

    def forward(self, cx: Ctx, x):
        tokens = x.reshape(x.shape[0], -1, self.tokens_in)
        h = cx(self.transformer, cx(self.embed, tokens))
        return cx(self.head, jnp.mean(h, axis=1))


def ring_job(seed, shape=(2, 3, 32, 8)):
    rng = np.random.RandomState(seed)
    q, k, v, w = (rng.randn(*shape).astype(np.float32) for _ in range(4))
    return {"kind": "ring", "q": q, "k": k, "v": v, "w": w, "scale": SCALE}


def fallback_job(tokens_in, seed):
    rng = np.random.RandomState(seed)
    feats = rng.randint(0, 255, (1, 1, 8, 2, 8, 24, 1)).astype(np.uint8)
    labels = rng.randint(0, 13, (1, 1, 8)).astype(np.int32)
    jm = JaxTinyN(tokens_in)
    v = jm.init(0)
    job = step_job("tiny", v, feats, labels, record_grads=True,
                   max_grad_norm=None,
                   arch={"depth": 1, "tokens_in": tokens_in})
    return job, (jm, v, feats, labels)


@pytest.fixture(scope="module")
def sp2(tmp_path_factory):
    """data 1 x seq 2: ring attention, the SP step, the fallback (N = 3),
    the dropout path and MobileViT, in one spawn."""
    tmp = tmp_path_factory.mktemp("sp2")
    rng = np.random.RandomState(1234)
    tv = JaxTiny().init(0)
    feats, labels = tiny_data(5)
    fb_job, fb = fallback_job(128, 21)
    vit = JaxMobileViT(num_classes=13, attention_backend="xla", **VIT_ARCH)
    _no_dropout(vit, torch.nn.Module())
    vv = vit.init(0)
    vfeats = rng.randint(0, 256, (1, 1, 2) + SP_VIT_CLIP).astype(np.uint8)
    vlabels = rng.randint(0, 13, (1, 1, 2)).astype(np.int32)
    jobs = {"ring": ring_job(3),
            "step": step_job("tiny", tv, feats, labels),
            "fallback": fb_job,
            "dropout": step_job("tiny", tv, feats[:1], labels[:1],
                                arch={"dropout": 0.3}),
            "vit": step_job("mobilevit", vv, vfeats, vlabels)}
    port = run_layout_jobs(tmp, {"seq": 2}, jobs)
    return port, dict(tiny=(tv, feats, labels), fallback=fb,
                      vit=(vv, vfeats, vlabels), ring=jobs["ring"])


@pytest.fixture(scope="module")
def sp4(tmp_path_factory):
    """data 1 x seq 4: ring attention over 4 blocks and the JAX fallback
    test's own case (N = 6 at seq 4)."""
    tmp = tmp_path_factory.mktemp("sp4")
    fb_job, fb = fallback_job(64, 22)
    jobs = {"ring": ring_job(4, (2, 2, 16, 8)), "fallback": fb_job}
    return run_layout_jobs(tmp, {"seq": 4}, jobs), dict(
        fallback=fb, ring=jobs["ring"])


def _jax_ring_reference(job):
    q, k, v, w = (jnp.asarray(job[t]) for t in "qkvw")

    def loss(q, k, v):
        return jnp.sum(sdpa_xla(q, k, v, scale=SCALE) * w)

    return (np.asarray(sdpa_xla(q, k, v, scale=SCALE)),
            [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(q, k,
                                                                      v)])


@pytest.mark.parametrize("seq", [2, 4])
def test_ring_attention_matches_plain_attention(sp2, sp4, seq):
    """Each rank's block of ring attention and of its Q/K/V gradients
    against the JAX ``sdpa_xla`` (and its ``jax.grad``) on the whole
    sequence, and against the port's ``sdpa``; K/V make size - 1 hops
    each way."""
    from picklebot_tpu_torch.ops.flash_attention import sdpa
    port, inputs = sp2 if seq == 2 else sp4
    job = inputs["ring"]
    out, grads = _jax_ring_reference(job)
    plain = sdpa(*(torch.tensor(job[t]) for t in "qkv"), SCALE).numpy()
    np.testing.assert_allclose(plain, out, rtol=1e-5, atol=1e-5)
    n = job["q"].shape[-2] // seq
    hop = int(np.prod(job["q"].shape[:-2])) * n * job["q"].shape[-1] * 4
    for r, got in enumerate(port["ring"]):
        blk = slice(r * n, (r + 1) * n)
        np.testing.assert_allclose(got["out"].numpy(), out[..., blk, :],
                                   rtol=1e-5, atol=1e-5)
        for name, g in zip(("dq", "dk", "dv"), grads):
            np.testing.assert_allclose(got[name].numpy(), g[..., blk, :],
                                       rtol=1e-4, atol=1e-5,
                                       err_msg=f"rank {r} {name}")
        assert got["counts"]["collective-permute"] == {
            "count": 4 * (seq - 1), "bytes": 4 * (seq - 1) * hop}


def test_sp_train_matches_jax_sharded_step(sp2):
    """data 1 x seq 2: the token-sharded transformer's 2 f32 AdamW steps
    with the clip on against the JAX SP step (the counterpart of
    test_sp_train_matches_single_device): the gradients of the replicated
    weights are exact through the optimizer, and both ranks hold the same
    weights."""
    port, inputs = sp2
    tv, feats, labels = inputs["tiny"]
    ref = jax_sharded_steps(JaxTiny(sequence_axis="seq"), tv,
                            AdamW(weight_decay=WD), feats, labels, seq=2)
    assert_step_matches(port["step"], ref)
    for got in port["step"]:
        assert got["engaged"] == ["transformer"]


def test_sp_collective_counts_from_shapes(sp2):
    """Per SP step of the tiny model (batch 8, N = 8 tokens of width 32,
    4 heads of 8, two layers, f32): the stack's exit all-gather forward
    and its entry's all-gather backward, 2 x (8, 8, 32); per layer K and V
    one hop forward and one back, 4 x (8, 4, 4, 8); one all-reduce of the
    stack's parameter gradients over 'seq' (2 x 8192 f32); no clip
    reduction (no sharded leaf) and no data reduction (one replica)."""
    port, _ = sp2
    want = {"all-gather": {"count": 2, "bytes": 2 * 8 * 8 * 32 * 4},
            "collective-permute": {"count": 2 * 4,
                                   "bytes": 2 * 4 * 8 * 4 * 4 * 8 * 4},
            "all-reduce": {"count": 1, "bytes": 2 * 8192 * 4}}
    for got in port["step"]:
        for counts in got["counts"]:
            assert {k: v for k, v in counts.items() if v["count"]} == want


@pytest.mark.parametrize("seq", [2, 4])
def test_sp_falls_back_when_indivisible(sp2, sp4, seq):
    """N = 3 tokens at seq 2 and N = 6 at seq 4 (the JAX test's case): the
    stack runs replicated, so no gradient is summed over 'seq'; the
    step's gradients equal the dense JAX gradient of the batch (a sum
    over 'seq' would double them) and the step matches the JAX SP step."""
    port, inputs = sp2 if seq == 2 else sp4
    jm, v, feats, labels = inputs["fallback"]

    def loss(params):
        out, _ = jm.apply({"params": params, "state": v["state"]},
                          jnp.asarray(feats[0, 0], jnp.float32) / 255.0,
                          train=False, policy=DtypePolicy.f32())
        return cross_entropy(out, jnp.asarray(labels[0, 0]))

    dense = tiny_torch_weights(jax.grad(loss)(v["params"]))
    ref = jax_sharded_steps(JaxTinyN(jm.tokens_in, sequence_axis="seq"), v,
                            AdamW(weight_decay=WD), feats, labels, seq=seq,
                            max_grad_norm=None)
    for r, got in enumerate(port["fallback"]):
        assert got["engaged"] == []
        for key, want in dense.items():
            np.testing.assert_allclose(got["grads"][key].numpy(),
                                       want.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=f"rank {r} {key}")
        np.testing.assert_allclose(got["loss"][0], ref[0][0], rtol=1e-5,
                                   atol=1e-5)
        for key, want in tiny_torch_weights(ref[0][2]).items():
            np.testing.assert_allclose(got["states"][0][key].numpy(),
                                       want.numpy(), rtol=1e-4, atol=3e-3)


def test_sp_dropout_path_runs(sp2):
    """Attention and FFN dropout under SP (all-gathered K/V, masks drawn
    per rank from a stream seeded with the seq rank): finite losses, the
    region engaged, and the replicated weights still equal on both
    ranks."""
    port, _ = sp2
    a, b = port["dropout"]
    assert np.isfinite(a["loss"][0]).all()
    assert a["engaged"] == ["transformer"]
    for key, val in a["states"][0].items():
        assert torch.equal(val, b["states"][0][key]), key


def test_mobilevit_sp_step_matches_jax(sp2):
    """The slice as a whole at seq 2: MobileViT at a small width (8x48x48
    clips: stages of 27, 8 and 2 tokens, so stage 1 falls back as
    MobileViT-s's stage 2 does), one f32 step with the clip, against the
    JAX sharded step."""
    port, inputs = sp2
    vv, feats, labels = inputs["vit"]
    jm = JaxMobileViT(num_classes=13, attention_backend="xla",
                      sequence_axis="seq", **VIT_ARCH)
    _no_dropout(jm, torch.nn.Module())
    ref = jax_sharded_steps(jm, vv, AdamW(weight_decay=WD), feats, labels,
                            seq=2)
    assert_step_matches(port["vit"], ref, kind="mobilevit")
    for got in port["vit"]:
        assert got["engaged"] == ["trunk.1.1.transformer",
                                  "trunk.2.1.transformer"]


@pytest.fixture(scope="module")
def sptp(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sptp")
    tv = JaxTiny().init(0)
    feats, labels = tiny_data(9)
    jobs = {"step": step_job("tiny", tv, feats, labels)}
    return run_layout_jobs(tmp, {"seq": 2, "model": 2}, jobs), (tv, feats,
                                                                 labels)


def test_sp_composes_with_tp(sptp):
    """seq 2 x model 2 (4 ranks): ring attention over 'seq' and the
    Megatron FFN shards over 'model' in one step, 2 f32 steps with the
    clip, against the JAX step on the same mesh."""
    port, (tv, feats, labels) = sptp
    ref = jax_sharded_steps(JaxTiny(sequence_axis="seq", model_axis="model"),
                            tv, AdamW(weight_decay=WD), feats, labels,
                            seq=2, model_ax=2)
    assert_step_matches(port["step"], ref)


def test_sp_same_axis_as_tp_raises():
    from picklebot_tpu_torch.models.mobilevit import TransformerStack
    with pytest.raises(ValueError, match="distinct mesh axes"):
        TransformerStack(32, depth=1, heads=4, dim_head=8, ffw_dim=64,
                         model_axis="model", sequence_axis="model")


def test_config_sequence_parallel_validation():
    """sequence_parallel is MobileViT's alone; a MobileViT config with it
    builds stacks with sequence_axis 'seq' once the mesh has the axis
    (the registry refuses it without one), and the trainer no longer
    refuses it."""
    from picklebot_tpu_torch.models.registry import initialize_model
    from picklebot_tpu_torch.parallel import mesh
    from picklebot_tpu_torch.train.loop import check_ported
    from picklebot_tpu_torch.utils.config import Config
    with pytest.raises(ValueError, match="sequence_parallel"):
        Config(model_name="MobileNetLarge3D", sequence_parallel=2).validate()
    cfg = Config(model_name="MobileViT", sequence_parallel=2,
                 dims=[64, 80, 96],
                 channels=[16, 16, 24, 24, 48, 48, 64, 64, 80, 80, 320]
                 ).validate()
    check_ported(cfg)
    with pytest.raises(ValueError, match="init_mesh"):
        initialize_model(cfg)
    saved = dict(mesh._MESH), mesh._MESH_SHAPE
    try:
        mesh._MESH["seq"] = mesh._Axis(2, 0, [0, 1])
        model = initialize_model(cfg)
    finally:
        mesh._MESH.clear()
        mesh._MESH.update(saved[0])
        mesh._MESH_SHAPE = saved[1]
    stack = model.trunk[0][1].transformer
    assert stack.sequence_axis == "seq"
    assert all(attn.sequence_axis == "seq" for attn, _ in stack.layers)


def test_sp_engages_only_where_the_axis_divides():
    """``sp_active`` (the JAX stack's rule): more than one rank on the
    axis and N divisible by it; at one rank the stack is the plain
    loop."""
    from picklebot_tpu_torch.models.mobilevit import TransformerStack
    from picklebot_tpu_torch.parallel import mesh
    stack = TransformerStack(32, depth=1, heads=4, dim_head=8, ffw_dim=64,
                             sequence_axis="seq")
    assert not stack.sp_active(8)
    saved = dict(mesh._MESH), mesh._MESH_SHAPE
    try:
        mesh._MESH["seq"] = mesh._Axis(2, 0, [0, 1])
        assert stack.sp_active(784) and stack.sp_active(32)
        assert not stack.sp_active(147)
    finally:
        mesh._MESH.clear()
        mesh._MESH.update(saved[0])
        mesh._MESH_SHAPE = saved[1]
