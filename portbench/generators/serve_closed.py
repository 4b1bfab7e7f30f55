"""Closed-loop batched serving: one caller sends a list of ``batch`` clips
to ``serve.records_fn`` over the checkpoint path's predictor, waits for
the records, and sends the next at once.

Traffic parameters: ``batch`` (clips per call, also ``max_batch``),
``pool`` (distinct clips, drawn from the seed and cycled through in a
seeded order), ``warm_calls`` (untimed calls first), ``profiled_calls``
(the traced window). The clips' shape is the configuration's ``clip``.

A request is one call, due when the previous call returned (the window's
start for the first), answered when its records are on the host.
``serve_clips_per_s`` is every clip answered in the window over the
window's whole time; ``request_p95_ms`` the 95th percentile of all its
requests' latencies. The window ends with the first call that returns
after ``seconds``. Every answer of the run is checked against the plain
reference's logits of its clip (``harness/checks.py``).
"""

from __future__ import annotations

import time

import numpy as np

from portbench.harness import checks, program, session, work
from portbench.harness import weights as W
from portbench.harness.references import reference_model
from portbench.reference.steps import mean_std, serving_config
from portbench.reference.steps import predict as reference_predict

TAG_POOL, TAG_ORDER, TAG_CALIBRATION = 11, 12, 13


def inputs(cfg, traffic, seed, dev):
    """(state, pool, order) of a seed: the weights with BatchNorm
    statistics calibrated by the reference, on ``dev``; the uint8 clip
    pool on the host; the order the calls take the clips in."""
    ref = reference_model(cfg, dev)
    state = W.calibrated(
        W.seeded_state(ref, seed, dev, cfg["init"]), ref,
        W.seeded_clips(seed, TAG_CALIBRATION,
                       (traffic["calibration_clips"], *cfg["clip"], 3), dev),
        *mean_std(cfg))
    pool = W.seeded_clips(seed, TAG_POOL,
                          (traffic["pool"], *cfg["clip"], 3), dev)
    order = np.random.default_rng([seed % 2 ** 64, TAG_ORDER]
                                  ).permutation(traffic["pool"])
    return state, pool, order


def run(spec: session.Spec) -> dict:
    cfg, traffic, dev = spec.config, spec.traffic, spec.device
    batch, n_pool = traffic["batch"], traffic["pool"]
    pcfg = program.config(cfg)
    state, pool, order = inputs(cfg, traffic, spec.seed, dev)
    model = program.model(pcfg, state, dev)
    state = {k: v.cpu() for k, v in state.items()}
    session.log(f"weights and clip pool {time.time() - spec.t0:.2f} s")
    predict = program.predictor(model, pcfg, dev)
    kept, inside = [], [0.0]

    def timed_predict(feats):
        t = session.now()
        out = predict(feats)
        inside[0] += session.now() - t
        kept.append(out.copy())
        return out

    records = program.records_fn(timed_predict, pcfg, batch)
    answers, host_ms = [], []
    position = [0]

    def call():
        i = position[0]
        position[0] += 1
        idx = [int(order[(i * batch + j) % n_pool]) for j in range(batch)]
        before = inside[0]
        kept.clear()
        t = session.now()
        recs = records([pool[j] for j in idx])
        dt = session.now() - t
        logits = kept[-1] if kept else []
        for k, j in enumerate(idx):
            answers.append((j, logits[k] if k < len(logits) else None,
                            recs[k] if k < len(recs) else None))
        return dt - (inside[0] - before)      # the host's part of the call

    for _ in range(traffic["warm_calls"]):
        call()
    answers.clear()

    # the window: each request due when the previous one returned
    setup_s = time.time() - spec.t0
    session.log(f"set-up {setup_s:.2f} s")
    lat = []
    start = due = session.now()
    while True:
        host = call()
        done = session.now()
        lat.append(done - due)
        host_ms.append(host * 1e3)
        due = done
        if done - start >= spec.seconds:
            break
    elapsed = done - start
    n_calls = len(lat)
    lat_ms = 1e3 * np.asarray(lat)
    rate = n_calls * batch / elapsed

    win = breakdown = None
    if spec.trace:
        n = traffic["profiled_calls"]
        win = session.Window(
            "serve", *session.profiled(call, n), clips=n * batch,
            forwards=n, backwards=0, steps=0, rate=rate,
            flops_per_clip=work.flops_per_clip(reference_model(cfg),
                                               cfg["clip"], batch,
                                               train=False),
            calls=work.geometry(reference_model(cfg), cfg["clip"], batch),
            host_ms=host_ms)
        metrics, breakdown = session.traced(win, spec.per_layer)
    else:
        metrics = session.end_to_end(spec, {
            "serve_clips_per_s": rate, "setup_s": setup_s,
            "request_p95_ms": float(np.percentile(lat_ms, 95))})
    dev_line = session.device_of(spec, win)

    # the program's state goes before the reference runs
    del model, predict, records, timed_predict, kept
    session.free_program()
    session.log(f"window closed {time.time() - spec.t0:.2f} s")
    ref = reference_model(cfg, dev)
    ref.load_state_dict(state)
    ref_logits = reference_predict(ref, pool, block=batch,
                                   **serving_config(cfg)).cpu().numpy()
    numbers = checks.serve_numbers(answers, ref_logits,
                                   cfg["num_classes"])
    ok, judged = checks.judged(numbers, spec.limits)
    session.log(f"checked {time.time() - spec.t0:.2f} s")
    failed = sum(1 for _, logits, rec in answers
                 if logits is None or rec is None) // batch
    line = session.result(ok, n_calls, failed, metrics, dev_line, judged,
                          breakdown)
    half = max(n_calls // 2, 1)
    line[session.NOTES] = {
        "latency_ms_p50_p95_max": [float(np.percentile(lat_ms, q))
                                   for q in (50, 95, 100)],
        "host_ms_p50": float(np.median(host_ms)),
        "clips_per_s_first_last_half": [
            batch * len(part) / sum(part) for part in (lat[:half],
                                                       lat[half:]) if part]}
    return line
