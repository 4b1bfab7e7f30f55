"""Faults planted under the timed path, to show that ``correct`` sees
them: each is a context manager that breaks the program's entry that a
generator calls (``harness/program.py``). The tests drive whole runs
with them; the readings tool reads their numbers on the card."""

from __future__ import annotations

import contextlib

import torch

from portbench.harness import program


@contextlib.contextmanager
def _patched(name, wrap):
    original = getattr(program, name)
    setattr(program, name, wrap(original))
    try:
        yield
    finally:
        setattr(program, name, original)


def half_batch():
    """Every microbatch loses its second half; the step's mean is taken
    over the rest."""
    def wrap(make):
        def train_step(*args, **kwargs):
            step, optimizer = make(*args, **kwargs)

            def broken(epoch, features, labels, position=0):
                half = features.shape[1] // 2
                return step(epoch, features[:, :half], labels[:, :half],
                            position)
            return broken, optimizer
        return train_step
    return _patched("train_step", wrap)


def unchanged_state():
    """The step runs, then puts every parameter back as it was."""
    def wrap(make):
        def train_step(m, *args, **kwargs):
            step, optimizer = make(m, *args, **kwargs)

            def broken(*a, **k):
                before = [p.detach().clone() for p in m.parameters()]
                out = step(*a, **k)
                with torch.no_grad():
                    for p, b in zip(m.parameters(), before):
                        p.copy_(b)
                return out
            return broken, optimizer
        return train_step
    return _patched("train_step", wrap)


def unchanged_after_checks(calls=3):
    """Sound for the first ``calls`` updates (the check steps), then
    every update puts the parameters back as they were: a fault that
    only the update after the window can show."""
    def wrap(make):
        def train_step(m, *args, **kwargs):
            step, optimizer = make(m, *args, **kwargs)
            done = [0]

            def broken(*a, **k):
                done[0] += 1
                if done[0] <= calls:
                    return step(*a, **k)
                before = [p.detach().clone() for p in m.parameters()]
                out = step(*a, **k)
                with torch.no_grad():
                    for p, b in zip(m.parameters(), before):
                        p.copy_(b)
                return out
            return broken, optimizer
        return train_step
    return _patched("train_step", wrap)


def answer_altered():
    """The predictor answers the first clip of every call with the class
    after its best, lifted above the best by the row's largest
    magnitude: the logits and the record built from them both change."""
    def wrap(make):
        def predictor(*args, **kwargs):
            predict = make(*args, **kwargs)

            def broken(features):
                out = predict(features).copy()
                row = out[0]
                other = (int(row.argmax()) + 1) % len(row)
                row[other] = row.max() + abs(row).max()
                return out
            return broken
        return predictor
    return _patched("predictor", wrap)


FAULTS = {"half_batch": half_batch, "unchanged_state": unchanged_state,
          "unchanged_after_checks": unchanged_after_checks,
          "answer_altered": answer_altered}
