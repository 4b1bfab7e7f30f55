"""Port: ZeRO (``parallel/zero.py``) against the JAX package's
``picklebot_tpu/parallel/zero.py``, at 2 ``gloo`` ranks
(``test_torch_dp.spawn_ranks``).

  * ZeRO-1 and ZeRO-3 steps of the tiny model without BatchNorm (odd leaf
    sizes, so that chunks pad: 648, 8, 104 and 13 elements), f32 AdamW and
    AdamW8bit (``min_8bit_size`` 64: the conv kernel's 324-element chunks
    quantize, the dense kernel's 52 do not), 3 steps against the JAX
    sharded step at ``zero_degree=2``: losses within 2e-4 and parameters
    within 2 * lr per step, the bounds of ``test_torch_train_step.py``; in
    f32 both stages bit-equal to the port's own DP, and in 8 bits stage 3
    bit-equal to stage 1.
  * ``zero_degree_of`` and ``zero_reshard`` against the JAX functions on
    the same states (the JAX runs' rank stacks), f32 and 8-bit, between
    degrees 2, 3 and the replicated layout: equal bit for bit.
  * The collective counter (``parallel/mesh.COUNTS``, logical result
    bytes) over one MobileNetLarge3D step, by the bounds of the JAX
    package's ``tests/test_collective_bytes.py``: DP's all-reduce within
    [1, 1.1] x the f32 parameter bytes P and nothing else; ZeRO-1's
    reduce-scatter about P/2 and its all-gather about P, its all-reduce
    under 0.1 P; ZeRO-3's total within 2% of ZeRO-1's.
"""

import numpy as np
import pytest
import jax
import torch

from picklebot_tpu.core.module import flatten_dict
from picklebot_tpu.models.mobilenet3d import MobileNetLarge3D as JaxLarge3D
from picklebot_tpu.parallel import zero as jz
from picklebot_tpu.train import optim as jax_optim
from picklebot_tpu_torch.convert import state_dict_from_jax
from picklebot_tpu_torch.parallel import zero as pz
from picklebot_tpu_torch.train.optim import AdamW, AdamW8bit
from test_torch_dp import (LR, WD, jax_dp_steps, run_step_jobs,
                           tiny_torch_weights)
from test_train_step import TinyNoBNNet

STEPS, A, B = 3, 2, 8
MIN_8BIT = 64
CLIP = 0.5
PORT_KEYS = {"conv.weight": "conv.w", "conv.bias": "conv.b",
             "fc.weight": "fc.w", "fc.bias": "fc.b"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_opt(kind):
    return (jax_optim.AdamW(weight_decay=WD) if kind == "adamw" else
            jax_optim.AdamW8bit(weight_decay=WD, min_8bit_size=MIN_8BIT))


# (zero stage, optimizer, max_grad_norm) of each tiny-model job
TINY_JOBS = {"dp_adamw": (0, "adamw", None), "z1_adamw": (1, "adamw", None),
             "z3_adamw": (3, "adamw", None),
             "z1_adamw8bit": (1, "adamw8bit", CLIP),
             "z3_adamw8bit": (3, "adamw8bit", CLIP)}


@pytest.fixture(scope="module")
def zero_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zero_runs")
    rng = np.random.RandomState(4321)
    tiny = TinyNoBNNet()
    tv = tiny.init(jax.random.key(0))
    feats = rng.randint(0, 256, (STEPS, A, B, 4, 16, 16, 3)).astype(np.uint8)
    labels = rng.randint(0, 13, (STEPS, A, B))
    jobs, want, jax_states = {}, {}, {}
    for name, (stage, kind, clip) in TINY_JOBS.items():
        kw = {"weight_decay": WD}
        if kind == "adamw8bit":
            kw["min_8bit_size"] = MIN_8BIT
        jobs[name] = dict(model="tiny", weights=tiny_torch_weights(
            tv["params"]), optimizer=kind, opt_kw=kw, zero=stage, lr=LR,
            max_grad_norm=clip, feats=feats, labels=labels)
        if stage:
            opt = _jax_opt(kind)
            want[name] = jax_dp_steps(tiny, tv, feats, labels, opt,
                                      zero_degree=2, zero_stage=stage,
                                      max_grad_norm=clip)
            jax_states[name] = want[name][-1][3], want[name][-1][5]
    # one MobileNetLarge3D step at each layout, for the collective counter
    jm = JaxLarge3D(13)
    v = jm.init(0)
    large = state_dict_from_jax(flatten_dict(v["params"]),
                                flatten_dict(v["state"]), "MobileNetLarge3D")
    lf = rng.randint(0, 256, (1, 1, 4, 8, 32, 32, 3)).astype(np.uint8)
    ll = rng.randint(0, 13, (1, 1, 4))
    for stage in (0, 1, 3):
        jobs[f"large_z{stage}"] = dict(
            model="large3d", weights=large, optimizer="adamw",
            opt_kw={"weight_decay": WD}, zero=stage, lr=LR,
            max_grad_norm=None, feats=lf, labels=ll)
    pbytes = 4 * sum(t.numel() for k, t in large.items()
                     if not k.endswith(("running_mean", "running_var",
                                        "num_batches_tracked")))
    return want, jax_states, run_step_jobs(tmp, jobs), pbytes


@pytest.mark.parametrize("name", [k for k, (z, _, _) in TINY_JOBS.items()
                                  if z])
def test_zero_step_matches_jax(zero_runs, name):
    want, _, got, _ = zero_runs
    for r in range(2):
        np.testing.assert_allclose(np.stack(got[name][r]["loss"]),
                                   np.stack([w[0] for w in want[name]]),
                                   rtol=2e-4, atol=2e-4)
    final = tiny_torch_weights(want[name][-1][3])
    for key, value in final.items():
        np.testing.assert_allclose(got[name][0]["model"][key].numpy(),
                                   value.numpy(), rtol=0,
                                   atol=2 * LR * STEPS, err_msg=key)
    if TINY_JOBS[name][2] is not None:
        np.testing.assert_allclose(got[name][0]["grad_norm"],
                                   [w[2] for w in want[name]], rtol=1e-4)
        assert max(w[2] for w in want[name]) > CLIP


@pytest.mark.parametrize("name,ref", [
    ("z1_adamw", "dp_adamw"), ("z3_adamw", "dp_adamw"),
    ("z3_adamw8bit", "z1_adamw8bit")])
def test_zero_is_bit_equal_to_its_reference(zero_runs, name, ref):
    """f32 ZeRO-1 and ZeRO-3 against the port's DP, and 8-bit ZeRO-3
    against 8-bit ZeRO-1: weights, losses and (stacked to the full
    layout) optimizer moments bit for bit, on both ranks."""
    _, _, got, _ = zero_runs
    for r in range(2):
        a, b = got[name][r], got[ref][r]
        assert np.array_equal(np.stack(a["loss"]), np.stack(b["loss"]))
        for key in b["model"]:
            assert torch.equal(a["model"][key], b["model"][key]), key
    sa, sb = got[name][0]["optimizer"], got[ref][0]["optimizer"]
    if pz.zero_degree_of(sb) != pz.zero_degree_of(sa):
        sa = pz.zero_reshard(AdamW([]), sa, 0)
    for part in ("m", "v"):
        for x, y in zip(sa[part], sb[part]):
            xs = x if isinstance(x, tuple) else (x,)
            ys = y if isinstance(y, tuple) else (y,)
            assert all(torch.equal(p, q) for p, q in zip(xs, ys))


# --------------------------------------------------------------------------
# zero_degree_of / zero_reshard against the JAX functions
# --------------------------------------------------------------------------

def _to_port(params, opt_state):
    """A JAX optimizer state (nested dicts, 8-bit leaves {"q", "s"}) ->
    the port's list layout in the port's parameter order, with the JAX
    parameters' shapes (both functions only flatten)."""
    def leaf(tree, key):
        node = tree
        for part in key.split("."):
            node = node[part]
        return node

    def conv(x):
        if isinstance(x, dict):
            return (torch.tensor(np.asarray(x["q"])),
                    torch.tensor(np.asarray(x["s"])))
        return torch.tensor(np.asarray(x))
    keys = list(PORT_KEYS.values())
    return {"steps": int(opt_state["step"]),
            "m": [conv(leaf(opt_state["m"], k)) for k in keys],
            "v": [conv(leaf(opt_state["v"], k)) for k in keys],
            "shapes": [tuple(np.shape(leaf(params, k))) for k in keys]}


def _same(port_state, jax_params, jax_state):
    want = _to_port(jax_params, jax_state)
    assert port_state["steps"] == want["steps"]
    for part in ("m", "v"):
        for x, y in zip(port_state[part], want[part]):
            assert isinstance(x, tuple) == isinstance(y, tuple)
            xs = x if isinstance(x, tuple) else (x,)
            ys = y if isinstance(y, tuple) else (y,)
            for p, q in zip(xs, ys):
                assert p.shape == q.shape
                assert torch.equal(p.to(q.dtype), q)


@pytest.mark.parametrize("kind", ["adamw", "adamw8bit"])
@pytest.mark.parametrize("n_new", [0, 3])
def test_zero_reshard_matches_jax(zero_runs, kind, n_new):
    _, jax_states, _, _ = zero_runs
    params, state = jax_states[f"z1_{kind}"]
    port_opt = (AdamW([]) if kind == "adamw"
                else AdamW8bit([], min_8bit_size=MIN_8BIT))
    ported = _to_port(params, state)
    assert pz.zero_degree_of(ported) == jz.zero_degree_of(params, state) == 2
    want = jz.zero_reshard(_jax_opt(kind), params, state, n_new)
    got = pz.zero_reshard(port_opt, ported, n_new)
    assert pz.zero_degree_of(got) == jz.zero_degree_of(params, want) == n_new
    _same(got, params, want)
    # and back to 2 ranks from there
    want2 = jz.zero_reshard(_jax_opt(kind), params, want, 2)
    _same(pz.zero_reshard(port_opt, got, 2), params, want2)


def test_zero_reshard_round_trip_is_exact_in_f32(zero_runs):
    _, jax_states, _, _ = zero_runs
    params, state = jax_states["z1_adamw"]
    ported = _to_port(params, state)
    back = pz.zero_reshard(AdamW([]),
                           pz.zero_reshard(AdamW([]), ported, 3), 2)
    for part in ("m", "v"):
        for x, y in zip(back[part], ported[part]):
            assert torch.equal(x, y)


# --------------------------------------------------------------------------
# the collective counter
# --------------------------------------------------------------------------

def test_collective_bytes_dp_zero1_zero3(zero_runs):
    _, _, got, p = zero_runs
    dp, z1, z3 = (got[f"large_z{s}"][0]["counts"] for s in (0, 1, 3))
    assert p <= dp["all-reduce"]["bytes"] <= 1.10 * p, (dp, p)
    assert dp["all-gather"]["count"] == dp["reduce-scatter"]["count"] == 0
    assert 0.99 * p <= z1["all-gather"]["bytes"] <= 1.15 * p, z1
    assert 0.9 * p / 2 <= z1["reduce-scatter"]["bytes"] <= 1.3 * p / 2, z1
    assert z1["all-reduce"]["bytes"] < 0.10 * p, z1

    def total(c):
        return sum(v["bytes"] for v in c.values())
    assert abs(total(z3) - total(z1)) <= 0.02 * total(z1), (z3, z1)
    # the same counts on the other rank
    assert got["large_z1"][1]["counts"] == z1
