"""Weights in and out of the port: reference ``.pth`` files and the JAX
package's variables.

``load_pth`` loads a state dict with the reference torch keys (a reference
checkpoint, or one written by the JAX package's ``save_pth``) with
``strict=True``. ``state_dict_from_jax`` turns the JAX package's flattened
variables, given as numpy arrays, into the port's state dict; it carries
its own copy of the MobileNetLarge3D key table and the layout rules of
``picklebot_tpu/train/key_maps.py`` and ``checkpoint.py``.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

# JAX path -> torch key where the two module trees differ (MobileNet3D)
_MOBILENET3D_KEYS = {
    "fc1.w": "classifier.1.weight", "fc1.b": "classifier.1.bias",
    "fc2.w": "classifier.3.weight", "fc2.b": "classifier.3.bias",
    "block1.conv.w": "block1.0.weight", "block1.conv.b": "block1.0.bias",
    "block6.conv.w": "block6.0.weight", "block6.conv.b": "block6.0.bias",
}
_MOBILENET3D_PREFIXES = {"block1.bn.": "block1.1.", "block6.bn.": "block6.1."}
# torch keys declared as 1x1x1 Conv3d weights where JAX keeps a matrix
_CONV_MATRIX = re.compile(r"(classifier\.[13]|.*\.se\.[13])\.weight")

KEY_TABLES = {"MobileNetLarge3D": (_MOBILENET3D_KEYS, _MOBILENET3D_PREFIXES)}


def _torch_key(path: str, is_state: bool, model_name: str) -> str:
    if model_name not in KEY_TABLES:
        raise NotImplementedError(
            f"no key table for {model_name}: not ported yet (ROADMAP.md)")
    table, prefixes = KEY_TABLES[model_name]
    if path in table:
        return table[path]
    for old, new in prefixes.items():
        if path.startswith(old):
            path = new + path[len(old):]
    head, _, leaf = path.rpartition(".")
    if is_state:
        return f"{head}.running_{leaf}"          # BN mean / var
    if head.rpartition(".")[2] == "squeeze_excite":  # SE w1 b1 w2 b2
        idx = {"1": "1", "2": "3"}[leaf[1]]
        kind = "weight" if leaf[0] == "w" else "bias"
        return f"{head}.se.{idx}.{kind}"
    return f"{head}." + {"w": "weight", "b": "bias", "scale": "weight",
                         "bias": "bias"}[leaf]


def _torch_layout(v: np.ndarray, torch_key: str) -> np.ndarray:
    v = np.array(v, np.float32, copy=True)   # never alias the caller's
    if v.ndim >= 3:                          # conv (k..., I, O) -> (O, I, k...)
        return np.ascontiguousarray(
            np.transpose(v, (v.ndim - 1, v.ndim - 2) + tuple(
                range(v.ndim - 2))))
    if v.ndim == 2:                          # dense (I, O) -> (O, I[, 1, 1, 1])
        vt = np.ascontiguousarray(v.T)
        return (vt.reshape(vt.shape + (1, 1, 1))
                if _CONV_MATRIX.fullmatch(torch_key) else vt)
    return v


def state_dict_from_jax(flat_params: Dict[str, np.ndarray],
                        flat_state: Dict[str, np.ndarray],
                        model_name: str) -> Dict[str, torch.Tensor]:
    """The JAX package's flattened ``params`` and ``state`` (dotted paths
    -> numpy arrays) -> a state dict with the reference torch keys and
    layouts, ``num_batches_tracked`` included. Every tensor owns a copy
    of its data."""
    out: Dict[str, torch.Tensor] = {}
    for path, v in flat_params.items():
        tk = _torch_key(path, False, model_name)
        out[tk] = torch.from_numpy(_torch_layout(np.asarray(v), tk))
    for path, v in flat_state.items():
        tk = _torch_key(path, True, model_name)
        out[tk] = torch.from_numpy(np.array(v, np.float32, copy=True))
        if tk.endswith(".running_mean"):
            out[tk[:-len("running_mean")] + "num_batches_tracked"] = \
                torch.zeros((), dtype=torch.int64)
    return out


def load_pth(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Strict load of a reference-keyed ``.pth`` into ``model`` (the
    ``_orig_mod.`` prefix of torch.compile is dropped first)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k[len("_orig_mod."):] if k.startswith("_orig_mod.") else k: v
          for k, v in sd.items()}
    model.load_state_dict(sd, strict=True)
    return model
