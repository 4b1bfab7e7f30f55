"""Closed-loop training with gradient accumulation: the step that the
trainer builds for the configuration (``make_train_step``, with its
optimizer and options), called back to back, each call one optimizer
update over A microbatches of B clips.

A and B are the configuration's: B = ``batch_size``, A =
``effective_batch_size`` // ``batch_size``. Traffic parameters:
``pool_updates`` (distinct updates of uint8 clips and labels, drawn from
the seed on the device and kept on the host; the step moves each
microbatch to the card, as in the trainer), ``check_steps`` (the first
steps of the run, which the plain reference follows), ``profiled_steps``
(the traced window). The clips' shape is the configuration's ``clip``.

Set-up builds one step object and drives it through the check steps,
which warm every shape; the window then calls the same object.
``train_clips_per_s`` is every clip of the updates finished in the
window over its whole time; the window ends with the first update that
finishes after ``seconds``. Once it has closed (and after the profiled
update of a traced run), the same object makes one more update, from
the state the window left and at the pool's next place: the reference
follows it from the program's weights and optimizer state, so that what
only shows after the check steps (the 8-bit moments' drift, a pool that
has wrapped) is compared too.
"""

from __future__ import annotations

import math
import time

import torch

from portbench.harness import checks, program, session, work
from portbench.harness import weights as W
from portbench.harness.references import reference_model
from portbench.reference.optim import from_codes
from portbench.reference.steps import follow_training

TAG_CLIPS, TAG_LABELS = 21, 22


def shape(cfg):
    b = cfg["batch_size"]
    return cfg["effective_batch_size"] // b, b


def inputs(cfg, traffic, seed, dev):
    """(state, features, labels) of a seed: the weights on ``dev``, and
    ``pool_updates`` distinct updates of uint8 clips (U, A, B, T, H, W, 3)
    and labels (U, A, B) on the host."""
    a, b = shape(cfg)
    n = traffic["pool_updates"]
    state = W.seeded_state(reference_model(cfg), seed, dev, cfg["init"])
    feats = W.seeded_clips(seed, TAG_CLIPS, (n, a, b, *cfg["clip"], 3), dev)
    labels = W.seeded_ints(seed, TAG_LABELS, cfg["num_classes"], (n, a, b))
    return state, feats, labels


def moments(opt_state: dict, params: dict):
    """(steps, m, v) of the program's optimizer state, decoded to
    float32 by the reference's codebooks, in the order of ``params``
    ({name: tensor})."""
    shapes = [tuple(p.shape) for p in params.values()]
    if [tuple(s) for s in opt_state["shapes"]] != shapes:
        raise ValueError("optimizer state does not follow the model's "
                         "parameters")

    def f32(st, shape, signed):
        return from_codes(*st, shape, signed) if isinstance(st, tuple) \
            else st.float()
    return (opt_state["steps"],
            [f32(m, s, True) for m, s in zip(opt_state["m"], shapes)],
            [f32(v, s, False) for v, s in zip(opt_state["v"], shapes)])


def run(spec: session.Spec) -> dict:
    cfg, traffic, dev = spec.config, spec.traffic, spec.device
    a, b = shape(cfg)
    n_pool, n_check = traffic["pool_updates"], traffic["check_steps"]
    pcfg = program.config(cfg)
    state, feats, labels = inputs(cfg, traffic, spec.seed, dev)
    model = program.model(pcfg, state, dev)
    state = {k: v.cpu() for k, v in state.items()}
    key_seed = spec.seed % 2 ** 63
    step, optimizer = program.train_step(model, pcfg, key_seed, dev)
    session.log(f"weights and pool {time.time() - spec.t0:.2f} s")
    start = checks.as_cpu_state(model)
    params = dict(model.named_parameters())
    position = [0]

    def update():
        u = (position[0] // a) % n_pool
        m = step(0, feats[u], labels[u], position=position[0])
        position[0] += a
        return m

    prog = {"losses": []}
    for k in range(n_check):
        prog["losses"].append(update()["loss"].float().cpu().tolist())
        if k == 0:
            prog["first_grads"] = checks.to_host(
                {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in params.items()})
    prog["params"] = checks.as_cpu_state(model)

    setup_s = time.time() - spec.t0
    session.log(f"set-up {setup_s:.2f} s")
    steps = failed = 0
    t_start = session.now()
    while True:
        loss = update()["loss"]
        if dev != "cpu":
            torch.cuda.synchronize()
        steps += 1
        if not bool(torch.isfinite(loss).all()):
            failed += 1
        done = session.now()
        if done - t_start >= spec.seconds:
            break
    rate = steps * a * b / (done - t_start)

    win = breakdown = None
    if spec.trace:
        n = traffic["profiled_steps"]
        win = session.Window(
            "train", *session.profiled(update, n), clips=n * a * b,
            forwards=n * a, backwards=n * a, steps=n, rate=rate,
            flops_per_clip=work.flops_per_clip(reference_model(cfg),
                                               cfg["clip"], b, train=True),
            calls=work.geometry(reference_model(cfg), cfg["clip"], b))
        metrics, breakdown = session.traced(win, spec.per_layer)
    else:
        metrics = session.end_to_end(spec, {"train_clips_per_s": rate,
                                            "setup_s": setup_s})
    dev_line = session.device_of(spec, win)

    session.log(f"window closed {time.time() - spec.t0:.2f} s")
    late = {"pre": checks.as_cpu_state(model),
            "opt": program.optimizer_state(optimizer),
            "position": position[0], "pool": (position[0] // a) % n_pool}
    late["losses"] = update()["loss"].float().cpu().tolist()
    late["params"] = checks.as_cpu_state(model)

    # the program's state goes before the reference runs
    del step, optimizer, model, params, update, loss
    session.free_program()
    ref = reference_model(cfg, dev)
    ref.load_state_dict(state)
    ref_out = follow_training(
        ref, cfg, [(feats[k % n_pool], labels[k % n_pool])
                   for k in range(n_check)], key_seed)
    numbers, notes = checks.train_numbers(prog, {
        "losses": ref_out["losses"],
        "first_grads": checks.to_host(ref_out["first_grads"]),
        "params": checks.to_host(ref_out["params"])}, start)
    del ref, ref_out
    session.free_program()
    ref = reference_model(cfg, dev)
    ref.load_state_dict({**state, **late["pre"]})
    u = late["pool"]
    ref_out = follow_training(
        ref, cfg, [(feats[u], labels[u])], key_seed,
        position0=late["position"],
        opt_state=moments(late["opt"], late["pre"]))
    more, more_notes = checks.late_numbers(late, {
        "losses": ref_out["losses"][0],
        "grads": checks.to_host(ref_out["first_grads"]),
        "params": checks.to_host(ref_out["params"])}, late["pre"])
    numbers.update(more)
    notes.update(more_notes)
    session.log(f"checked {time.time() - spec.t0:.2f} s")
    ok, judged = checks.judged(numbers, spec.limits)
    notes["not_compared"] = checks.uncompared(numbers, spec.limits)
    ok = ok and failed == 0 and math.isfinite(rate)
    line = session.result(ok, steps, failed, metrics, dev_line, judged,
                          breakdown)
    line[session.NOTES] = notes
    return line
