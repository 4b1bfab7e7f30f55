"""The numbers that decide ``correct``, computed from the program's outputs
and the plain reference's.

Serving (every answer of the run): ``logit_err``, the largest gap
between a returned logit and the reference's, over that clip's largest
reference logit; ``conf_err``, the gap between the served confidence and
the reference's probability of the served class (a served class that is
not the reference's best shows here); ``records_bad``, answers missing,
malformed or mislabelled.

Training, the run's first steps: ``loss_gap_first``, the largest
relative gap of a microbatch's loss in the first step (the forward at
the seeded weights), ``loss_gap`` the same over every checked step;
``grad_norm_gap_median``, the median over the leaves of the gap between
the norms of the first step's summed gradient, each over the larger of
the reference leaf's norm and the median leaf's (the worst leaf's gap is
a note: no control or fault separates it from sound runs);
``update_norm_gap``, the worst leaf's gap of the parameters' change over
the steps, leaving out the leaves whose reference gradient is under a
thousandth of the median leaf's (their change is round-off under Adam).

Training, the update after the window, which the reference follows from
the program's weights and optimizer state: ``late_loss_gap``, the
largest relative gap of its microbatches' losses; ``late_update_gap``,
the worst leaf's gap of its change, by the same rule of leaves.
"""

from __future__ import annotations

import math

import numpy as np
import torch

BALL_STRIKE = {0: "ball", 1: "strike"}


def label_of(pred: int, num_classes: int) -> str:
    if num_classes <= 2:
        return BALL_STRIKE.get(pred, f"zone_{pred}")
    return f"zone_{pred}"


def serve_numbers(answers, ref_logits, num_classes):
    """``answers``: [(pool index, returned logits (C,), record or None)];
    ``ref_logits``: (pool, C) float32 of the reference."""
    ref = np.asarray(ref_logits, dtype=np.float64)
    e = np.exp(ref - ref.max(-1, keepdims=True))
    probs = e / e.sum(-1, keepdims=True)
    logit_err = conf_err = 0.0
    bad = 0
    for idx, logits, rec in answers:
        r = ref[idx]
        scale = max(np.abs(r).max(), 1e-30)
        if logits is None or not np.all(np.isfinite(logits)):
            logit_err = math.inf
        else:
            logit_err = max(logit_err, float(
                np.abs(np.asarray(logits, np.float64) - r).max() / scale))
        try:
            pred, conf = int(rec["pred"]), float(rec["confidence"])
            ok = (0 <= pred < len(r)
                  and rec["label"] == label_of(pred, num_classes))
        except (TypeError, KeyError, ValueError):
            ok = False
        if not ok:
            bad += 1
            continue
        conf_err = max(conf_err, abs(conf - float(probs[idx, pred])))
    return {"logit_err": logit_err, "conf_err": conf_err,
            "records_bad": float(bad)}


def _norms(tensors: dict) -> dict:
    return {n: float(t.double().norm()) for n, t in tensors.items()}


def _gaps(prog: dict, ref: dict, names):
    """{leaf: gap of the norms, over the larger of the reference leaf's
    norm and the median leaf's}."""
    med = float(np.median([ref[n] for n in names])) if names else 0.0
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
            for n in names}


def _worst(gaps: dict):
    if not gaps:
        return 0.0, None
    leaf = max(gaps, key=lambda n: (gaps[n] if gaps[n] == gaps[n]
                                    else math.inf))
    return gaps[leaf], leaf


def _loss_gap(prog_losses, ref_losses):
    return max((abs(lp - lr) / max(abs(lr), 1e-30)
                if math.isfinite(lp) else math.inf)
               for lp, lr in zip(prog_losses, ref_losses))


def _moved(ref_grads: dict):
    """(leaf names, {leaf: reference gradient norm}, the leaves whose
    reference gradient is at least a thousandth of the median leaf's)."""
    gr = _norms(ref_grads)
    names = sorted(gr)
    med = float(np.median([gr[n] for n in names]))
    return names, gr, [n for n in names if gr[n] >= 1e-3 * med]


def _change_gap(prog_params, ref_params, start, moved):
    dp = _norms({n: prog_params[n] - start[n] for n in moved})
    dr = _norms({n: ref_params[n] - start[n] for n in moved})
    return _worst(_gaps(dp, dr, moved))


def train_numbers(prog: dict, ref: dict, start: dict):
    """``prog`` and ``ref``: {'losses': [[loss]], 'first_grads': {name:
    tensor}, 'params': {name: tensor after the steps}}; ``start``: the
    weights before the first step. Returns (numbers, notes): the notes
    name the worst leaves and give each step's loss gap."""
    steps = [_loss_gap(p, r) for p, r in zip(prog["losses"], ref["losses"])]
    names, gr, moved = _moved(ref["first_grads"])
    grad_gaps = _gaps(_norms(prog["first_grads"]), gr, names)
    grad_worst, grad_leaf = _worst(grad_gaps)
    update_gap, update_leaf = _change_gap(prog["params"], ref["params"],
                                          start, moved)
    numbers = {"loss_gap_first": steps[0], "loss_gap": max(steps),
               "grad_norm_gap_median": float(np.median(
                   list(grad_gaps.values()))),
               "update_norm_gap": update_gap}
    notes = {"loss_gap_by_step": steps, "grad_norm_gap_worst": grad_worst,
             "worst_grad_leaf": grad_leaf, "worst_update_leaf": update_leaf,
             "grad_gap_top": sorted(((round(g, 6), n) for n, g in
                                     grad_gaps.items()), reverse=True)[:6],
             "leaves_left_out": sorted(set(names) - set(moved))}
    return numbers, notes


def late_numbers(prog: dict, ref: dict, pre: dict):
    """The update after the window. ``prog`` and ``ref``: {'losses':
    [loss per microbatch], 'params': {name: tensor after it}}, ``ref``
    with its 'grads' of the update; ``pre``: the weights before it.
    Returns (numbers, notes)."""
    _, _, moved = _moved(ref["grads"])
    gap, leaf = _change_gap(prog["params"], ref["params"], pre, moved)
    return ({"late_loss_gap": _loss_gap(prog["losses"], ref["losses"]),
             "late_update_gap": gap},
            {"worst_late_leaf": leaf,
             "late_losses": {"program": list(prog["losses"]),
                             "reference": list(ref["losses"])}})


def judged(numbers: dict, limits: dict):
    """(correct, {name: {'value', 'limit'}}): every number that has a
    limit at or under it and finite. A number whose limit is null has no
    upper reading to set one from (``PERF.md``): it is not compared, and
    ``uncompared`` gives it to the notes."""
    out, ok = {}, True
    for name, value in numbers.items():
        limit = limits[name]
        if limit is None:
            continue
        good = value == value and value <= limit
        ok = ok and good
        out[name] = {"value": value, "limit": limit}
    return ok, out


def uncompared(numbers: dict, limits: dict) -> dict:
    return {n: v for n, v in numbers.items() if limits[n] is None}


def to_host(tensors: dict) -> dict:
    return {n: t.detach().float().cpu() for n, t in tensors.items()}


def as_cpu_state(model) -> dict:
    with torch.no_grad():
        return {n: p.detach().float().cpu().clone()
                for n, p in model.named_parameters()}
