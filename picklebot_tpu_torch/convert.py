"""Weights in and out of the port: reference ``.pth`` files and the JAX
package's variables, and the checkpoint-conversion CLI.

``load_pth`` loads a state dict with the reference torch keys (a reference
checkpoint, or one written by the JAX package's ``save_pth``) with
``strict=True``. ``state_dict_from_jax`` turns the JAX package's flattened
variables, given as numpy arrays, into the port's state dict; it carries
its own copy of the key tables of the eight models and the layout rules
of ``picklebot_tpu/train/key_maps.py`` and ``checkpoint.py`` (conv
(k..., I, O) -> (O, I, k...), 2-D linear and LSTM (I, O) -> (O, I), a 1x1
conv kept as a matrix -> (O, I, 1, 1, 1), or (O, I, 1, 1) in the 2-D
models, BN statistics as state only; an MoE feed-forward's ``router``,
``w1`` and ``w2`` keep their JAX names with every axis reversed, as the
JAX export writes them, and its per-forward ``aux_loss`` is no state).
``shard_state_dict`` cuts a full state dict into one rank's of a sharded
axis (MobileViT's FFN weights over 'model', its expert banks over
'expert', by ``parallel/megatron.py``'s rules), ``local_state_dict`` into
this rank's of every axis of the mesh, and ``unshard_state_dicts`` joins
the ranks' back: JAX -> ``state_dict_from_jax`` -> a rank's shard, and
back.

The CLI, the counterpart of ``python -m picklebot_tpu.convert`` on the
port's formats; the direction follows the output's suffix, and no device
is touched::

  # a .pth -> the port's snapshot file (step 0: fresh optimizer state)
  python -m picklebot_tpu_torch.convert weights.pth --config cfg.json \
      --out ck/

  # a port snapshot (or another .pth) -> a .pth with the reference keys
  python -m picklebot_tpu_torch.convert ck/step_0 --config cfg.json \
      --out weights.pth [--like reference.pth] [--ema]

``--like`` writes the keys of an existing ``.pth`` in its order (its
``_orig_mod.`` prefix dropped, as the JAX CLI drops it); ``--ema`` takes a
snapshot's EMA weights. It prints the JAX CLI's one JSON line.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from typing import Dict

import numpy as np
import torch

from picklebot_tpu_torch.ops.norm import BatchNorm, GroupNorm, LayerNorm

# JAX path -> torch key where the two module trees differ: regex
# rewrites, applied in order before the generic leaf renames
_MOBILENET3D_RULES = (
    (r"^fc1\.", "classifier.1."), (r"^fc2\.", "classifier.3."),
    (r"^block([16])\.conv\.", r"block\1.0."),
    (r"^block([16])\.bn\.", r"block\1.1."),
    # Small3D's block4 = (conv, SE, BN), unrolled in the JAX model
    (r"^b4_conv\.", "block4.0."), (r"^b4_se\.", "block4.1."),
    (r"^b4_bn\.", "block4.2."),
)
# MoViNetA2 (key_maps.py _MOVINET_TABLE, inverted)
_MOVINET_RULES = (
    (r"^stem_conv\.", "block1.0."), (r"^stem_bn\.", "block1.1."),
    (r"^head_conv\.", "conv.0."), (r"^head_bn\.", "conv.1."),
    (r"^fc1_bn\.", "classifier.3."), (r"^fc1\.", "classifier.2."),
    (r"^fc2\.", "classifier.6."),
)
# MoViNetA2Stream (key_maps.py movinet_stream_key_map, inverted): the JAX
# model nests the offline one under "net" and each causal depthwise conv
# under "conv"; the torch keys are the offline model's
_MOVINET_STREAM_RULES = (
    (r"^net\.", ""), (r"^(block\d+\.\d+)\.conv\.conv\.", r"\1.conv."),
) + _MOVINET_RULES
# MobileNetLarge2D / Small2D (key_maps.py _MOBILENET2D_TABLE, inverted)
_MOBILENET2D_RULES = (
    (r"^block1\.conv\.", "block1.0."), (r"^block1\.bn\.", "block1.1."),
    (r"^b6_conv\.", "block6.0."), (r"^b6_bn\.", "block6.1."),
    (r"^b4_conv\.", "block4.0."), (r"^b4_se\.", "block4.1."),
    (r"^b4_bn\.", "block4.2."), (r"^classifier\.", "classifier.0."),
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
# MobileViTV2 (key_maps.py mobilevitv2_key_map, inverted): torch nests
# each transformer's layers under 'layer'
_MOBILEVITV2_RULES = (
    (r"^(transformer\d)\.transformer\.(\d+)\.",
     r"\1.transformer.layer.\2."),
)
# torch keys declared as 1x1 conv weights where JAX keeps a matrix:
# Conv3d (O, I, 1, 1, 1), or Conv2d (O, I, 1, 1) in the 2-D models; in
# MobileViTV2 the attention's and the FFN's (key_maps.py
# mobilevitv2_export_ranks), not its top-level 3x3 conv1
_CONV_MATRIX = re.compile(r"(classifier\.[13]|.*\.se\.[13]"
                          r"|.*\.attention\.(qkv|out)_proj"
                          r"|.*\.ffn\.conv[12])\.weight")
_CONV2D_MODELS = ("MobileNetLarge2D", "MobileNetSmall2D", "MobileViTV2")

KEY_RULES = {"MobileNetLarge3D": _MOBILENET3D_RULES,
             "MobileNetSmall3D": _MOBILENET3D_RULES,
             "MobileViT": _MOBILEVIT_RULES, "MoViNetA2": _MOVINET_RULES,
             "MoViNetA2Stream": _MOVINET_STREAM_RULES,
             "MobileNetLarge2D": _MOBILENET2D_RULES,
             "MobileNetSmall2D": _MOBILENET2D_RULES,
             "MobileViTV2": _MOBILEVITV2_RULES}


# an MoE feed-forward's leaves (ops/moe.py): the JAX export keeps their
# pytree names, which no rule below may touch (w1/w2 would read as an SE
# block's)
_MOE_LEAF = re.compile(r".*\.transformer\.ffs\.\d+\.(router|w1|w2)")
# per-forward values the JAX modules publish as state; never a tensor of
# the state dict (the JAX TRANSIENT_STATE_LEAVES)
TRANSIENT_STATE_LEAVES = ("aux_loss",)


def _torch_key(path: str, is_state: bool, model_name: str) -> str:
    if model_name not in KEY_RULES:
        raise NotImplementedError(
            f"no key table for {model_name}: not ported yet (ROADMAP.md)")
    if model_name == "MobileViT" and not is_state and _MOE_LEAF.fullmatch(
            path):
        return path
    for pattern, repl in KEY_RULES[model_name]:
        path = re.sub(pattern, repl, path)
    head, _, leaf = path.rpartition(".")
    if is_state:
        return f"{head}.running_{leaf}"          # BN mean / var
    if leaf in ("w1", "b1", "w2", "b2"):         # an SE block's leaves
        idx = {"1": "1", "2": "3"}[leaf[1]]
        kind = "weight" if leaf[0] == "w" else "bias"
        return f"{head}.se.{idx}.{kind}"
    lstm = re.fullmatch(r"([wb])_((?:ih|hh)_l\d+)", leaf)
    if lstm:                                     # w_ih_l0 -> weight_ih_l0
        return f"{head}." + {"w": "weight", "b": "bias"}[lstm[1]] + \
            f"_{lstm[2]}"
    return f"{head}." + {"w": "weight", "b": "bias", "scale": "weight",
                         "bias": "bias"}[leaf]


# torch key -> JAX path: the rules above inverted, model by model. A
# lookahead for a bare leaf tells a Sequential's conv/BN (block1.0.weight)
# from a bottleneck's inner module (block4.0.pointwise_conv1.weight).
_LEAF_ONLY = r"(?=[^.]+$)"
_MOBILENET3D_INVERSE = (
    (r"^classifier\.1\.", "fc1."), (r"^classifier\.3\.", "fc2."),
    (r"^block([16])\.0\." + _LEAF_ONLY, r"block\1.conv."),
    (r"^block([16])\.1\." + _LEAF_ONLY, r"block\1.bn."),
    (r"^block4\.0\." + _LEAF_ONLY, "b4_conv."),
    (r"^block4\.1\.(?=se\.)", "b4_se."),
    (r"^block4\.2\." + _LEAF_ONLY, "b4_bn."),
)
_MOVINET_INVERSE = (
    (r"^block1\.0\." + _LEAF_ONLY, "stem_conv."),
    (r"^block1\.1\." + _LEAF_ONLY, "stem_bn."),
    (r"^conv\.0\.", "head_conv."), (r"^conv\.1\.", "head_bn."),
    (r"^classifier\.2\.", "fc1."), (r"^classifier\.3\.", "fc1_bn."),
    (r"^classifier\.6\.", "fc2."),
)
_MOBILENET2D_INVERSE = (
    (r"^block1\.0\." + _LEAF_ONLY, "block1.conv."),
    (r"^block1\.1\." + _LEAF_ONLY, "block1.bn."),
    (r"^block6\.0\." + _LEAF_ONLY, "b6_conv."),
    (r"^block6\.1\." + _LEAF_ONLY, "b6_bn."),
    (r"^block4\.0\." + _LEAF_ONLY, "b4_conv."),
    (r"^block4\.1\.(?=se\.)", "b4_se."),
    (r"^block4\.2\." + _LEAF_ONLY, "b4_bn."),
    (r"^classifier\.0\.", "classifier."),
)
_MOBILEVIT_INVERSE = (
    (r"^to_logits\.0\.0\.", "to_logits_conv.conv."),
    (r"^to_logits\.0\.1\.", "to_logits_conv.bn."),
    (r"^to_logits\.2\.", "head."),
    (r"(^|\.)(conv[1-4])\.0\.", r"\1\2.conv."),
    (r"(^|\.)(conv[1-4])\.1\.", r"\1\2.bn."),
    (r"\.layers\.(\d+)\.0\.to_out\.0\.", r".attns.\1.to_out."),
    (r"\.layers\.(\d+)\.0\.", r".attns.\1."),
    (r"\.layers\.(\d+)\.1\.net\.0\.", r".ffs.\1.fc1."),
    (r"\.layers\.(\d+)\.1\.net\.3\.", r".ffs.\1.fc2."),
)
INVERSE_RULES = {"MobileNetLarge3D": _MOBILENET3D_INVERSE,
                 "MobileNetSmall3D": _MOBILENET3D_INVERSE,
                 "MobileViT": _MOBILEVIT_INVERSE,
                 "MoViNetA2": _MOVINET_INVERSE,
                 # the offline model's paths, each block's causal conv
                 # nested one level deeper, all under "net"
                 "MoViNetA2Stream": _MOVINET_INVERSE + (
                     (r"^(block\d+\.\d+)\.conv\.", r"\1.conv.conv."),
                     (r"^", "net.")),
                 "MobileNetLarge2D": _MOBILENET2D_INVERSE,
                 "MobileNetSmall2D": _MOBILENET2D_INVERSE,
                 "MobileViTV2": (
                     (r"^(transformer\d)\.transformer\.layer\.(\d+)\.",
                      r"\1.transformer.\2."),)}


def jax_param_path(model: torch.nn.Module, torch_key: str,
                   model_name: str) -> str:
    """The JAX package's parameter path of the port parameter
    ``torch_key``: ``_torch_key`` inverted, checked by mapping it
    forward again. A norm's weight is the JAX ``scale``, an SE block's
    ``se.1``/``se.3`` leaves its ``w1 b1 w2 b2``."""
    if model_name not in INVERSE_RULES:
        raise NotImplementedError(
            f"no key table for {model_name}: not ported yet (ROADMAP.md)")
    owner_key, _, leaf = torch_key.rpartition(".")
    owner = model.get_submodule(owner_key)
    if model_name == "MobileViT" and _MOE_LEAF.fullmatch(torch_key):
        return torch_key
    path = torch_key
    for pattern, repl in INVERSE_RULES[model_name]:
        path = re.sub(pattern, repl, path)
    head, _, _ = path.rpartition(".")
    se = re.fullmatch(r"(.*)\.se\.([13])", head)
    kind = {"weight": "w", "bias": "b"}[leaf.split("_")[0]]
    if se:
        path = f"{se[1]}.{kind}{'1' if se[2] == '1' else '2'}"
    elif "_" in leaf:                            # weight_ih_l0 -> w_ih_l0
        path = f"{head}.{kind}_{leaf.split('_', 1)[1]}"
    elif isinstance(owner, (BatchNorm, LayerNorm, GroupNorm)):
        path = f"{head}." + {"w": "scale", "b": "bias"}[kind]
    else:
        path = f"{head}.{kind}"
    if _torch_key(path, False, model_name) != torch_key:
        raise KeyError(f"{torch_key}: no JAX path maps to it ({path} maps "
                       f"to {_torch_key(path, False, model_name)})")
    return path


def _torch_layout(v: np.ndarray, torch_key: str,
                  conv_rank: int) -> np.ndarray:
    v = np.array(v, np.float32, copy=True)   # never alias the caller's
    if v.ndim >= 3:                          # conv (k..., I, O) -> (O, I, k...)
        return np.ascontiguousarray(
            np.transpose(v, (v.ndim - 1, v.ndim - 2) + tuple(
                range(v.ndim - 2))))
    if v.ndim == 2:                          # dense (I, O) -> (O, I[, 1...])
        vt = np.ascontiguousarray(v.T)
        return (vt.reshape(vt.shape + (1,) * (conv_rank - 2))
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
    conv_rank = 4 if model_name in _CONV2D_MODELS else 5
    for path, v in flat_params.items():
        tk = _torch_key(path, False, model_name)
        out[tk] = torch.from_numpy(_torch_layout(np.asarray(v), tk,
                                                 conv_rank))
    for path, v in flat_state.items():
        if path.rsplit(".", 1)[-1] in TRANSIENT_STATE_LEAVES:
            continue
        tk = _torch_key(path, True, model_name)
        out[tk] = torch.from_numpy(np.array(v, np.float32, copy=True))
        if tk.endswith(".running_mean"):
            out[tk[:-len("running_mean")] + "num_batches_tracked"] = \
                torch.zeros((), dtype=torch.int64)
    return out


def shard_state_dict(sd: Dict[str, torch.Tensor], rank: int, n: int,
                     axis: str = "model") -> Dict[str, torch.Tensor]:
    """A full state dict -> the one of rank ``rank`` of ``n`` on mesh axis
    ``axis``: over 'model' each FeedForward's ``net.0`` weight (and bias)
    keeps its rank's rows and ``net.3`` weight its columns, as the JAX
    ``MOBILEVIT_TP_RULES`` shard fc1 and fc2; over 'expert' each expert
    bank keeps its rank's experts; the rest is shared."""
    from picklebot_tpu_torch.parallel.megatron import shard_rule, shard_tensor
    if n <= 1:
        return dict(sd)
    out = {}
    for k, v in sd.items():
        rule = shard_rule(k)
        out[k] = (v if rule is None or rule[0] != axis
                  else shard_tensor(v, rule[1], rank, n))
    return out


def local_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A full state dict -> this rank's, cut for every sharded axis of the
    mesh (``parallel/mesh.init_mesh``)."""
    from picklebot_tpu_torch.parallel import mesh
    for axis in ("model", "expert"):
        sd = shard_state_dict(sd, mesh.axis_index(axis),
                              mesh.axis_size(axis), axis)
    return sd


def unshard_state_dicts(shards, axis: str = "model"
                        ) -> Dict[str, torch.Tensor]:
    """The inverse of ``shard_state_dict``: the ranks' state dicts, in
    rank order of ``axis`` -> the full one (each shared tensor from rank
    0)."""
    from picklebot_tpu_torch.parallel.megatron import shard_rule
    shards = list(shards)
    out = {}
    for k, v in shards[0].items():
        rule = shard_rule(k)
        out[k] = (v if rule is None or rule[0] != axis or len(shards) == 1
                  else torch.cat([sd[k] for sd in shards], dim=rule[1]))
    return out


def read_pth(path: str) -> Dict[str, torch.Tensor]:
    """A reference-keyed ``.pth`` state dict on the CPU, the
    ``_orig_mod.`` prefix of torch.compile dropped."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k[len("_orig_mod."):] if k.startswith("_orig_mod.") else k: v
            for k, v in sd.items()}


def load_pth(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Strict load of a reference-keyed ``.pth`` into ``model``."""
    model.load_state_dict(read_pth(path), strict=True)
    return model


def load_weights(path: str, model: torch.nn.Module,
                 ema: bool = False) -> torch.nn.Module:
    """Load weights into ``model`` from a ``.pth`` (reference keys) or a
    snapshot of the port's trainer (its ``model`` state dict; with
    ``ema`` its EMA weights over the parameters, as the trainer's eval
    scores them), for serve, export and the CLI below. Raises SystemExit
    for ``ema`` without EMA weights, as the JAX server does, and
    NotImplementedError for any other path (an Orbax snapshot of the JAX
    package)."""
    from picklebot_tpu_torch.train import checkpoint as ckpt

    if path.endswith(".pth"):
        if ema:
            # a .pth holds one weight set: --ema would hand back raw ones
            raise SystemExit(
                "--ema requires a training snapshot (the EMA weights are "
                "part of the training state); a .pth file has no EMA "
                "stream")
        return load_pth(path, model)
    if not ckpt.is_snapshot(path):
        raise NotImplementedError(
            f"checkpoint {path!r}: the port reads a .pth or its own "
            "snapshot files; Orbax snapshots are the JAX package's (export "
            "one's weights as a .pth with python -m picklebot_tpu.convert)")
    payload = ckpt.load_checkpoint(path)
    model.load_state_dict(payload["model"], strict=True)
    if ema:
        if payload.get("ema") is None:
            raise SystemExit(
                "--ema: this snapshot has no EMA weights (train with "
                "config ema_decay > 0)")
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(payload["ema"][name])
    return model


def like_state_dict(state: Dict[str, torch.Tensor],
                    like_path: str) -> Dict[str, torch.Tensor]:
    """``state`` under the keys of the ``.pth`` at ``like_path``, in its
    order. The key sets must agree but for ``num_batches_tracked``
    (written where the like file has it): a KeyError names the first
    that does not."""
    like = list(read_pth(like_path))
    bookkeeping = ".num_batches_tracked"
    missing = [k for k in like if k not in state]
    extra = [k for k in state if k not in set(like)
             and not k.endswith(bookkeeping)]
    if missing or extra:
        raise KeyError(f"--like {like_path}: its keys are not this model's "
                       f"(not in the model: {missing[:3]}; not in the file: "
                       f"{extra[:3]})")
    return {k: state[k] for k in like}


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Convert checkpoints between a torch .pth and the "
                    "port's snapshot file")
    p.add_argument("src", help="source: a .pth or a snapshot file of the "
                   "port's trainer")
    p.add_argument("--config", required=True)
    p.add_argument("--out", required=True,
                   help=".pth -> a state dict; anything else -> a snapshot "
                        "directory (step_0 in it)")
    p.add_argument("--like", default=None,
                   help="a .pth whose key names the export should mirror")
    p.add_argument("--ema", action="store_true",
                   help="convert the EMA weights of a snapshot trained "
                        "with ema_decay > 0 (same contract as serve --ema)")
    args = p.parse_args(argv)

    from picklebot_tpu_torch.models.registry import initialize_model
    from picklebot_tpu_torch.train import checkpoint as ckpt
    from picklebot_tpu_torch.train.optim import OPTIMIZERS
    from picklebot_tpu_torch.utils.config import load_config

    config = load_config(args.config)
    model = load_weights(args.src, initialize_model(config), args.ema)
    if args.out.endswith(".pth"):
        state = {k: v.detach().clone() for k, v in
                 model.state_dict().items()}
        if args.like:
            state = like_state_dict(state, args.like)
        torch.save(state, args.out)
        out_path, kind = args.out, "torch"
    else:
        # step 0 of a fresh run: the optimizer's initial state, no EMA,
        # the early-stop baselines at inf (train/loop.py's start)
        optimizer = OPTIMIZERS[config.optimizer](
            model.parameters(), weight_decay=config.weight_decay)
        payload = ckpt.snapshot(model, optimizer, None, 0, [0, 0],
                                [float("inf"), float("inf"), 0])
        out_path = ckpt.SnapshotWriter().save(args.out, 0, payload)
        kind = "snapshot"
    print(json.dumps({"converted": args.src, "to": out_path,
                      "format": kind, "model": config.model_name}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
