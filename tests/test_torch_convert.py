"""Port: param-tree conversion and checkpoint restore in the shared npy
manifest format."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

import jax  # noqa: E402

from ncf_tpu.models import advanced_ncf as jmodel  # noqa: E402
from ncf_tpu.utils.config import ModelConfig as JModelConfig  # noqa: E402
from ncf_tpu_torch.convert import (params_from_numpy,  # noqa: E402
                                   params_to_numpy)
from ncf_tpu_torch.models import advanced_ncf as tmodel  # noqa: E402
from ncf_tpu_torch.train import checkpoint as tckpt  # noqa: E402
from ncf_tpu_torch.utils.config import ModelConfig  # noqa: E402

DEMO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                    "demo", "checkpoint")


def _paths(tree):
    return dict(tckpt._leaves_with_path(tree))


def test_round_trip_keeps_keys_shapes_and_dtypes():
    cfg = JModelConfig(num_users=30, num_items=20, mf_dim=8, mlp_dim=8,
                       temporal_dim=4, mlp_hidden_dims=[16, 8])
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(3), cfg))
    tree["extra_int"] = np.arange(5, dtype=np.int32)
    params = params_from_numpy(tree, "cpu")
    assert isinstance(params["mlp"], list) and len(params["mlp"]) == 2
    assert params["extra_int"].dtype == torch.int32
    back = params_to_numpy(params)
    a, b = _paths(tree), _paths(back)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        np.testing.assert_array_equal(a[k], b[k])


def test_bf16_leaves_convert_exactly():
    ml_dtypes = pytest.importorskip("ml_dtypes")
    arr = np.asarray([1.5, -2.25, 3.0e-3], dtype=ml_dtypes.bfloat16)
    t = params_from_numpy({"w": arr}, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(params_to_numpy({"w": t})["w"],
                                  arr.astype(np.float32))


def test_restore_demo_equals_np_load():
    template = tmodel.init(torch.Generator(), ModelConfig(), device="meta")
    state, manifest = tckpt.restore(DEMO, {"params": template}, "cpu")
    assert manifest["step"] == 324
    leaves = _paths(state)
    with open(os.path.join(DEMO, tckpt.MANIFEST)) as f:
        files = json.load(f)["leaves"]
    assert leaves.keys() == files.keys()
    for name, meta in files.items():
        want = np.load(os.path.join(DEMO, meta["file"]))
        assert leaves[name].device.type == "cpu"
        np.testing.assert_array_equal(leaves[name].numpy(), want)


def test_restore_checks_shapes_and_missing_leaves():
    small = tmodel.init(torch.Generator(), ModelConfig(num_users=10),
                        device="meta")
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.restore(DEMO, {"params": small}, "cpu")
    with pytest.raises(KeyError):
        tckpt.restore(DEMO, {"params": {"nope": torch.empty(1)}}, "cpu")


def test_restore_sharded_scalar_and_orbax(tmp_path):
    full = np.arange(12, dtype=np.float32).reshape(4, 3)
    np.save(tmp_path / "a.p0s0.npy", full[:2])
    np.save(tmp_path / "a.p1s0.npy", full[2:])
    manifest = {"step": 7, "leaves": {
        "a": {"kind": "sharded", "global_shape": [4, 3], "dtype": "float32",
              "shards": [{"file": "a.p0s0.npy", "index": [[0, 2], [0, 3]]},
                         {"file": "a.p1s0.npy", "index": [[2, 4], [0, 3]]}]},
        "n": {"kind": "scalar", "value": 5.0}}}
    (tmp_path / tckpt.MANIFEST).write_text(json.dumps(manifest))
    state, _ = tckpt.restore(str(tmp_path),
                             {"a": torch.empty(4, 3), "n": 0}, "cpu")
    np.testing.assert_array_equal(state["a"].numpy(), full)
    assert state["n"] == 5 and isinstance(state["n"], int)
    (tmp_path / tckpt.MANIFEST).write_text(json.dumps({"backend": "orbax"}))
    with pytest.raises(NotImplementedError):
        tckpt.restore(str(tmp_path), {"a": torch.empty(4, 3)}, "cpu")


def test_find_latest_and_best(tmp_path):
    assert tckpt.find_latest(str(tmp_path)) is None
    for step in (3, 12):
        d = tmp_path / f"ckpt_{step:08d}"
        d.mkdir()
        (d / tckpt.MANIFEST).write_text("{}")
    (tmp_path / "ckpt_00000099").mkdir()          # no manifest: skipped
    assert tckpt.find_latest(str(tmp_path)).endswith("ckpt_00000012")
    assert tckpt.find_best(str(tmp_path)) is None
    os.symlink("ckpt_00000003", tmp_path / tckpt.BEST_LINK)
    assert tckpt.find_best(str(tmp_path)).endswith("ckpt_00000003")
