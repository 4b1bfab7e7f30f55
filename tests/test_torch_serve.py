"""Port: the serve CLI against the JAX package's, from one shared .pth.

For MobileNetLarge3D and MobileViT (xxs widths, 'auto' attention), the
JAX package's ``save_pth`` writes its init weights once; both servers
load that file and evaluate the same synthetic CSV on the CPU under the
f32 policy. Predictions must be identical; confidences (softmax of
logits that agree to ~1e-5, rounded to 4 decimals by both) within 2e-4.
"""

import json

import numpy as np
import pytest

from picklebot_tpu import serve as jax_serve
from picklebot_tpu.models.mobilenet3d import MobileNetLarge3D as JaxLarge3D
from picklebot_tpu.models.mobilevit import MobileViT as JaxMobileViT
from picklebot_tpu.train.checkpoint import build_reverse_map, save_pth
from picklebot_tpu.train.key_maps import export_rank_for, key_map_for
from picklebot_tpu_torch import serve as port_serve
from picklebot_tpu_torch.models.mobilenet3d import MobileNetLarge3D
from picklebot_tpu_torch.models.mobilevit import MOBILEVIT_CONFIGS, MobileViT

NAME = "MobileNetLarge3D"


def _write_inputs(tmp_path, name=NAME):
    cfg = {"model_name": name, "num_classes": 13, "criterion": "CE",
           "use_autocast": False, "batch_size": 2,
           "effective_batch_size": 2, "video_paths": str(tmp_path),
           "data_backend": "synthetic", "synthetic_shape": [8, 64, 64],
           "t_bucket": 8, "max_frames": 8}
    if name == "MobileViT":
        cfg.update(MOBILEVIT_CONFIGS["xxs"], attention_backend="auto")
        jax_model = JaxMobileViT(num_classes=13, **MOBILEVIT_CONFIGS["xxs"])
        port = MobileViT(num_classes=13, **MOBILEVIT_CONFIGS["xxs"])
    else:
        jax_model, port = JaxLarge3D(13), MobileNetLarge3D(13)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    pth = tmp_path / "w.pth"
    save_pth(str(pth), jax_model.init(0),
             reverse_map=build_reverse_map(port.state_dict().keys(),
                                           key_map_for(name)),
             rank_map=export_rank_for(name))
    return str(cfg_path), str(pth)


def _lines(capsys):
    return [json.loads(l) for l in capsys.readouterr().out.splitlines()
            if l.startswith("{")]


def _serve_parity(tmp_path, capsys, name):
    cfg, pth = _write_inputs(tmp_path, name)
    args = [cfg, "--checkpoint", pth, "--csv", "x", "--limit", "4",
            "--batch", "2"]
    assert jax_serve.main(args) == 0
    want = _lines(capsys)
    assert port_serve.main(args + ["--device", "cpu"]) == 0
    got = _lines(capsys)
    assert len(got) == len(want) == 5
    assert got[-1] == want[-1]                      # evaluated / accuracy
    for g, w in zip(got[:-1], want[:-1]):
        assert (g["clip"], g["pred"], g["label"]) == \
            (w["clip"], w["pred"], w["label"])
        assert abs(g["confidence"] - w["confidence"]) <= 2e-4


def test_port_serve_matches_jax_serve(tmp_path, capsys):
    _serve_parity(tmp_path, capsys, NAME)


def test_port_serve_matches_jax_serve_mobilevit(tmp_path, capsys):
    _serve_parity(tmp_path, capsys, "MobileViT")


def test_serve_on_cuda_without_a_card_raises(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the check is for one without")
    cfg, pth = _write_inputs(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_serve.main([cfg, "--checkpoint", pth, "--csv", "x",
                         "--limit", "2", "--device", "cuda"])


def test_decode_and_batch_helpers_match_jax(rng):
    for crit, nc in (("CE", 13), ("CE", 2), ("BCE", 1)):
        logits = rng.randn(5, nc).astype(np.float32)
        assert port_serve.decode_logits(logits, crit, nc) == \
            jax_serve.decode_logits(logits, crit, nc)
    for n in range(1, 12):
        assert port_serve.pad_batch_pow2(n, 8) == \
            jax_serve.pad_batch_pow2(n, 8)
    feats = rng.randint(0, 255, (3, 2, 4, 4, 3)).astype(np.uint8)
    a, b = port_serve.pad_batch_to(feats, 4), jax_serve.pad_batch_to(feats,
                                                                      4)
    assert a[1] == b[1] == 3
    np.testing.assert_array_equal(a[0], b[0])
