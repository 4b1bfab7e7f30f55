"""Port: the config loader and the clip dataset against the JAX package's
(both numpy; the port keeps its own copies)."""

import dataclasses
import glob
import os
import warnings

import numpy as np
import pytest

from picklebot_tpu.data import dataset as jax_data
from picklebot_tpu.utils import config as jax_config
from picklebot_tpu_torch.data import dataset as port_data
from picklebot_tpu_torch.utils import config as port_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.json")))


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_files_load_identically(path):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = dataclasses.asdict(jax_config.load_config(path))
        got = dataclasses.asdict(port_config.load_config(path))
    assert got == want


def test_config_fields_and_model_names_match():
    from picklebot_tpu.models.registry import MODELS, fold_spans_for
    assert [f.name for f in dataclasses.fields(port_config.Config)] == \
        [f.name for f in dataclasses.fields(jax_config.Config)]
    assert set(port_config.MODEL_NAMES) == set(MODELS)
    for name in MODELS:
        assert port_config.FOLD_SPANS.get(name) == fold_spans_for(name)


@pytest.mark.parametrize("bad", [dict(criterion="MSE"),
                                 dict(batch_size=3, effective_batch_size=4),
                                 dict(model_name="ResNet"),
                                 dict(fold_span="trunk")])
def test_config_rejects_what_the_jax_loader_rejects(bad):
    with pytest.raises(ValueError):
        jax_config.Config(**bad).validate()
    with pytest.raises(ValueError):
        port_config.Config(**bad).validate()


@pytest.mark.parametrize("backend", ["synthetic", "synthetic_learnable"])
def test_synthetic_clips_are_byte_identical(backend):
    kw = dict(backend=backend, synthetic_shape=(6, 8, 10), synthetic_len=9)
    want = jax_data.ClipDataset("", "", **kw)
    got = port_data.ClipDataset("", "", **kw)
    assert got.filenames == want.filenames
    for i in range(len(want)):
        (a, la), (b, lb) = got[i], want[i]
        assert la == lb and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_npy_backend_and_collate_match(tmp_path, rng):
    clips = [rng.randint(0, 255, (t, 4, 6, 3)).astype(np.uint8)
             for t in (3, 7, 12)]
    csv = tmp_path / "ann.csv"
    csv.write_text("filename,zone\n" + "".join(
        f"c{i}.npy,{i}\n" for i in range(len(clips))))
    for i, c in enumerate(clips):
        np.save(tmp_path / f"c{i}.npy", c)
    got = port_data.ClipDataset(str(csv), str(tmp_path), backend="npy")
    want = jax_data.ClipDataset(str(csv), str(tmp_path), backend="npy")
    assert list(got.labels) == list(want.labels)
    for i in range(len(clips)):
        np.testing.assert_array_equal(got[i][0], want[i][0])
    for tb, mf in ((8, 256), (4, 8)):
        a = port_data.pad_collate(clips, [0, 1, 2], tb, mf)
        b = jax_data.pad_collate(clips, [0, 1, 2], tb, mf, native=False)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert port_data.bucket_frames(11, tb, mf) == \
            jax_data.bucket_frames(11, tb, mf)
