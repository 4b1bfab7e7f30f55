"""The plain reference of a configuration, found by its file.

A configuration file may carry ``"reference": "<name>"``: its reference
is then ``portbench/reference/<name>.py``, imported by that name, whose
``build(cfg)`` returns the float32 model in plain ``torch`` and which
may define ``loss_terms(model)``. A configuration without the key gets
``portbench/reference/models.py`` ``build`` of its ``model_name``.
"""

from __future__ import annotations

import importlib

import torch

from portbench.reference import models as R

PACKAGE = "portbench.reference"


def module_of(cfg: dict):
    """The reference module a configuration names, or None without the
    key. Imported once per process, so its classes are the same objects
    in every model it builds."""
    name = cfg.get("reference")
    if name is None:
        return None
    if not isinstance(name, str) or not name.isidentifier():
        raise ValueError(f"reference {name!r}: the name of a file "
                         f"portbench/reference/<name>.py, an identifier")
    return importlib.import_module(f"{PACKAGE}.{name}")


def reference_model(cfg: dict, dev="meta"):
    """The configuration's plain reference model, built on ``dev``."""
    mod = module_of(cfg)
    with torch.device(dev):
        if mod is None:
            return R.build(cfg["model_name"], cfg["num_classes"],
                           cfg.get("dims"), cfg.get("channels"))
        return mod.build(cfg)


def loss_terms(cfg: dict):
    """The reference module's ``loss_terms(model)``, or None: what the
    configuration's program step adds to the cross entropy before the
    backward."""
    return getattr(module_of(cfg), "loss_terms", None)
