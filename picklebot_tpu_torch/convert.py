"""Weights in and out of the port: reference ``.pth`` files and the JAX
package's variables.

``load_pth`` loads a state dict with the reference torch keys (a reference
checkpoint, or one written by the JAX package's ``save_pth``) with
``strict=True``. ``state_dict_from_jax`` turns the JAX package's flattened
variables, given as numpy arrays, into the port's state dict; it carries
its own copy of the MobileNetLarge3D and MobileViT key tables and the
layout rules of ``picklebot_tpu/train/key_maps.py`` and ``checkpoint.py``
(conv (k..., I, O) -> (O, I, k...), 2-D linear (I, O) -> (O, I), BN
statistics as state only).
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

# JAX path -> torch key where the two module trees differ: regex
# rewrites, applied in order before the generic leaf renames
_MOBILENET3D_RULES = (
    (r"^fc1\.", "classifier.1."), (r"^fc2\.", "classifier.3."),
    (r"^block([16])\.conv\.", r"block\1.0."),
    (r"^block([16])\.bn\.", r"block\1.1."),
)
# MobileViT (key_maps.py mobilevit_key_map, inverted): conv_*_bn stacks
# are Sequential(conv, bn, silu), transformer layers ModuleList(attention,
# feedforward), the head lives in to_logits
_MOBILEVIT_RULES = (
    (r"^to_logits_conv\.conv\.", "to_logits.0.0."),
    (r"^to_logits_conv\.bn\.", "to_logits.0.1."),
    (r"^head\.", "to_logits.2."),
    (r"(^|\.)(conv[1-4])\.conv\.", r"\1\2.0."),
    (r"(^|\.)(conv[1-4])\.bn\.", r"\1\2.1."),
    (r"\.attns\.(\d+)\.to_out\.", r".layers.\1.0.to_out.0."),
    (r"\.attns\.(\d+)\.", r".layers.\1.0."),
    (r"\.ffs\.(\d+)\.fc1\.", r".layers.\1.1.net.0."),
    (r"\.ffs\.(\d+)\.fc2\.", r".layers.\1.1.net.3."),
)
# torch keys declared as 1x1x1 Conv3d weights where JAX keeps a matrix
_CONV_MATRIX = re.compile(r"(classifier\.[13]|.*\.se\.[13])\.weight")

KEY_RULES = {"MobileNetLarge3D": _MOBILENET3D_RULES,
             "MobileViT": _MOBILEVIT_RULES}


def _torch_key(path: str, is_state: bool, model_name: str) -> str:
    if model_name not in KEY_RULES:
        raise NotImplementedError(
            f"no key table for {model_name}: not ported yet (ROADMAP.md)")
    for pattern, repl in KEY_RULES[model_name]:
        path = re.sub(pattern, repl, path)
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
