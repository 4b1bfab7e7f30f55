"""The control of ``correct``: the plain reference put in the program's
place and computed one precision below the configuration's (bf16 ->
float8: e4m3 operands with one scale per tensor, e5m2 gradients), held
to the same numbers against the float32 reference. Its readings set the
upper end of each limit; the benchmark's own runs never run it."""

from __future__ import annotations

import numpy as np
import torch

from portbench.generators import serve_closed, train_accum
from portbench.harness import checks
from portbench.harness.references import reference_model
from portbench.reference.models import set_precision
from portbench.reference.steps import (follow_training, predict,
                                       serving_config)


def decode(logits, num_classes):
    """The records a server would build from ``logits``: argmax, its
    softmax probability rounded to 4 places, its label."""
    out = []
    for row in np.asarray(logits, np.float64):
        e = np.exp(row - row.max())
        pred = int(row.argmax())
        out.append({"pred": pred, "label": checks.label_of(pred, num_classes),
                    "confidence": round(float(e[pred] / e.sum()), 4)})
    return out


def serve(cfg, traffic, seed, dev, precision="fp8"):
    state, pool, _ = serve_closed.inputs(cfg, traffic, seed, dev)
    ref = reference_model(cfg, dev)
    ref.load_state_dict(state)
    want = predict(ref, pool, block=traffic["batch"],
                   **serving_config(cfg))
    set_precision(ref, precision)
    got = predict(ref, pool, block=traffic["batch"],
                  **serving_config(cfg)).cpu().numpy()
    recs = decode(got, cfg["num_classes"])
    return checks.serve_numbers([(i, got[i], recs[i])
                                 for i in range(len(pool))],
                                want.cpu().numpy(), cfg["num_classes"])


def train(cfg, traffic, seed, dev, precision="fp8", window_updates=0):
    """The check steps, then one update after ``window_updates`` more, as
    the update after a window: the lower precision's from its own state,
    and the float32 reference's from the same weights and moments."""
    state, feats, labels = train_accum.inputs(cfg, traffic, seed, dev)
    n_check, n_pool = traffic["check_steps"], traffic["pool_updates"]
    a = train_accum.shape(cfg)[0]
    key = seed % 2 ** 63

    def pool(first, n):
        return [(feats[k % n_pool], labels[k % n_pool])
                for k in range(first, first + n)]

    def fresh(p, weights):
        ref = reference_model(cfg, dev)
        ref.load_state_dict(weights)
        return set_precision(ref, p)

    def host(o):
        return {"losses": o["losses"],
                "first_grads": checks.to_host(o["first_grads"]),
                "params": checks.to_host(o["params"])}

    low = fresh(precision, state)
    start = checks.as_cpu_state(low)
    o = follow_training(low, cfg, pool(0, n_check), key)
    prog, opt_state = host(o), o["opt_state"]
    at = n_check
    if window_updates:
        opt_state = follow_training(low, cfg, pool(at, window_updates), key,
                                    position0=at * a,
                                    opt_state=opt_state)["opt_state"]
        at += window_updates
    pre = checks.as_cpu_state(low)
    o = follow_training(low, cfg, pool(at, 1), key, position0=at * a,
                        opt_state=opt_state)
    prog_late = {"losses": o["losses"][0],
                 "params": checks.to_host(o["params"])}
    del low, o
    ref = fresh("f32", state)
    want = host(follow_training(ref, cfg, pool(0, n_check), key))
    del ref
    ref = fresh("f32", {**state, **pre})
    o = follow_training(ref, cfg, pool(at, 1), key, position0=at * a,
                        opt_state=opt_state)
    want_late = {"losses": o["losses"][0],
                 "grads": checks.to_host(o["first_grads"]),
                 "params": checks.to_host(o["params"])}
    del ref, o
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    numbers, notes = checks.train_numbers(prog, want, start)
    more, more_notes = checks.late_numbers(prog_late, want_late, pre)
    numbers.update(more)
    notes.update(more_notes)
    return numbers, notes


def run(workload_kind, cfg, traffic, seed, dev, window_updates=0):
    """The control's numbers (and, in training, notes) of one seed;
    ``window_updates``: the updates between the check steps and the
    update after the window, as many as a run's window holds."""
    if workload_kind == "serve_closed":
        return serve(cfg, traffic, seed, dev), {}
    return train(cfg, traffic, seed, dev, window_updates=window_updates)
