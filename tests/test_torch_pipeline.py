"""Port parity for the input pipelines and the copied utilities against
``ncf_tpu``: ``DeviceEpochPipeline`` fed the reference's own
permutation (equal column for column: both take the same rows, so the
tolerance is exact equality), its per-epoch determinism, ``[K, B]``
groups and ``epoch_bytes``; ``group_batches`` and
``prefetch_to_device``; ``MetricsLogger``, ``LocalArtifactStore`` /
``push_training_artifacts`` and ``movielens.load`` (each format written
here) against the JAX package's copies, all exact.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

import jax  # noqa: E402

from ncf_tpu.data import movielens as jmovielens  # noqa: E402
from ncf_tpu.data import pipeline as jpipeline  # noqa: E402
from ncf_tpu.data.synthetic import generate_interactions as jgenerate  # noqa: E402
from ncf_tpu.utils import artifacts as jartifacts  # noqa: E402
from ncf_tpu.utils import logging as jlogging  # noqa: E402
from ncf_tpu_torch.data import generate_interactions  # noqa: E402
from ncf_tpu_torch.data import movielens  # noqa: E402
from ncf_tpu_torch.data import pipeline  # noqa: E402
from ncf_tpu_torch.utils import artifacts  # noqa: E402
from ncf_tpu_torch.utils import logging as tlogging  # noqa: E402

LOG = dict(num_users=120, num_items=40, num_days=30, avg_txns_per_user=8,
           seed=3)


@pytest.fixture(scope="module")
def logs():
    return generate_interactions(**LOG), jgenerate(**LOG)


def _np(batch):
    return {k: np.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("B,sort,extra", [(64, True, False),
                                          (100, False, False),
                                          (37, True, True)])
def test_build_from_the_reference_permutation(logs, B, sort, extra):
    tinter, jinter = logs
    cols = None
    if extra:
        cols = {"history": tinter.causal_history(5)}
    tp = pipeline.DeviceEpochPipeline(tinter, B, seed=4, sort_by_user=sort,
                                      extra_cols=cols, device="cpu")
    jp = jpipeline.DeviceEpochPipeline(jinter, B, seed=4, sort_by_user=sort,
                                       extra_cols=cols)
    assert len(tp) == len(jp)
    assert tp.epoch_bytes() == jp.epoch_bytes()
    for epoch in (0, 3):
        key = pipeline.epoch_key(4, epoch)
        perm = np.asarray(jax.random.permutation(jax.random.PRNGKey(key),
                                                 len(jinter)))
        got = tp.build_from_permutation(perm)
        want = [_np(b) for b in jp.epoch(epoch)]
        assert set(got) == set(want[0])
        for k, v in got.items():
            np.testing.assert_array_equal(
                v.numpy(), np.stack([w[k] for w in want]), err_msg=k)


def test_epochs_are_permutations_and_deterministic(logs):
    tinter, _ = logs
    n, B = len(tinter), 50
    a = pipeline.DeviceEpochPipeline(tinter, B, seed=1, device="cpu")
    b = pipeline.DeviceEpochPipeline(tinter, B, seed=1, device="cpu")
    c = pipeline.DeviceEpochPipeline(tinter, B, seed=2, device="cpu")
    p0, p1 = a.permutation(0), a.permutation(1)
    assert sorted(p0.tolist()) == list(range(n))
    assert not torch.equal(p0, p1)
    assert torch.equal(p0, b.permutation(0))
    assert not torch.equal(p0, c.permutation(0))
    # the padded epoch is the permutation repeated from its start, and
    # every batch is sorted by user
    rows = a.build_from_permutation(p0)
    users = rows["user_ids"]
    assert (users[:, 1:] >= users[:, :-1]).all()
    got = np.sort(rows["user_ids"].reshape(-1).numpy())
    order = np.resize(p0.numpy(), len(a) * B)
    np.testing.assert_array_equal(got, np.sort(tinter.user_ids[order]))
    unshuffled = pipeline.DeviceEpochPipeline(tinter, B, shuffle=False,
                                              device="cpu")
    assert torch.equal(unshuffled.permutation(5), torch.arange(n))


@pytest.mark.parametrize("K", [1, 3, 4])
def test_epoch_groups(logs, K):
    tinter, _ = logs
    p = pipeline.DeviceEpochPipeline(tinter, 64, seed=0, device="cpu")
    full = p.build_from_permutation(p.permutation(2))
    groups = list(p.epoch(2, steps_per_dispatch=K))
    nb = len(p)
    assert len(groups) == -(-nb // K)
    for i, g in enumerate(groups):
        lead = g["item_ids"].shape[0] if K > 1 else 1
        if K > 1:
            assert lead == min(K, nb - i * K)           # ragged last group
            assert g["item_ids"].shape == (lead, 64)
            for k, v in g.items():
                assert torch.equal(v, full[k][i * K:i * K + lead])
        else:
            for k, v in g.items():
                assert torch.equal(v, full[k][i])


def test_group_batches_and_prefetch(logs):
    tinter, jinter = logs
    tb = list(pipeline.BatchIterator(tinter, 32, seed=5).epoch(1))
    jb = list(jpipeline.BatchIterator(jinter, 32, seed=5).epoch(1))
    tg = list(pipeline.group_batches(iter(tb), 4))
    jg = list(jpipeline.group_batches(iter(jb), 4))
    assert len(tg) == len(jg)
    for a, b in zip(tg, jg):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    for size in (1, 2, 5):
        got = list(pipeline.prefetch_to_device(iter(tg), size=size,
                                               device="cpu"))
        assert len(got) == len(tg)
        for a, b in zip(got, tg):
            for k in b:
                assert isinstance(a[k], torch.Tensor)
                np.testing.assert_array_equal(a[k].numpy(), b[k])


def test_prefetch_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        next(pipeline.prefetch_to_device(iter([{"a": np.zeros(2)}])))


def test_metrics_logger_matches(tmp_path):
    records = [dict(kind="train", step=1, loss=np.float32(0.5), ts=1.0),
               dict(kind="val", step=2, name="x", flag=True, ts=2.0,
                    latency_ms=3.0),
               dict(kind="error", step=3, latency_ms=1.0, ts=3.0),
               dict(kind="train", obj=[1, 2], latency_ms=2.0, ts=4.0)]
    outs = []
    for mod, name in ((tlogging, "t"), (jlogging, "j")):
        lg = mod.MetricsLogger(str(tmp_path / name / "m.jsonl"),
                               memory_limit=3)
        for r in records:
            lg.write(**r)
        with open(tmp_path / name / "m.jsonl") as f:
            lines = f.read()
        outs.append((lines, lg.recent(2), lg.summary()))
    assert outs[0] == outs[1]
    assert tlogging.MetricsLogger().summary() == {"count": 0}


def _tree(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            if f == "manifest.json" and "checkpoint" not in dirpath:
                continue                  # holds the time of the push
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_artifact_store_matches(tmp_path):
    src = tmp_path / "src"
    (src / "ckpts" / "ckpt_00000003").mkdir(parents=True)
    (src / "ckpts" / "ckpt_00000003" / "manifest.json").write_text("{}")
    (src / "ckpts" / "ckpt_00000003" / "a.npy").write_bytes(b"xyz")
    (src / "m.jsonl").write_text('{"a": 1}\n')
    (src / "extra.txt").write_text("e")
    stored = {}
    for mod, name in ((artifacts, "t"), (jartifacts, "j")):
        uri = "file://" + str(tmp_path / name)
        paths = mod.push_training_artifacts(
            uri, "job", checkpoint_dir=str(src / "ckpts"),
            metrics_file=str(src / "m.jsonl"),
            extra={"notes": str(src / "extra.txt")})
        store = mod.get_store(str(tmp_path / name))
        assert store.exists("job/metrics.jsonl")
        with open(tmp_path / name / "job" / "manifest.json") as f:
            manifest = json.load(f)
        stored[name] = ([os.path.relpath(p, tmp_path / name) for p in paths],
                        store.list("job"), manifest["artifacts"],
                        _tree(tmp_path / name))
        pulled = store.pull("job/checkpoint", str(tmp_path / f"pull_{name}"))
        assert os.path.exists(os.path.join(pulled, "ckpt_00000003", "a.npy"))
    assert stored["t"] == stored["j"]
    for mod in (artifacts, jartifacts):
        with pytest.raises(ValueError, match="gs"):
            mod.get_store("gs://bucket/path")


def _write_movielens(root, fmt):
    d = root / fmt
    d.mkdir()
    if fmt == "ml-100k":
        rows = [(1, 10, 4, 100), (2, 20, 3, 50), (1, 20, 5, 200),
                (3, 10, 2, 150), (3, 30, 1, 150)]
        (d / "u.data").write_text(
            "".join("\t".join(map(str, r)) + "\n" for r in rows))
        flags = {10: 2, 20: 0, 30: None}
        lines = []
        for item, g in flags.items():
            f = ["0"] * 19
            if g is not None:
                f[g] = "1"
            lines.append("|".join([str(item), "t", "d", "", "u"] + f))
        (d / "u.item").write_text("\n".join(lines) + "\n",
                                  encoding="latin-1")
    elif fmt == "ml-1m":
        (d / "ratings.dat").write_text(
            "1::10::4::100\n2::20::3::50\n1::20::5::200\n3::30::2::10\n")
        (d / "movies.dat").write_text(
            "10::Toy Story (1995)::Animation|Children's\n"
            "20::Heat (1995)::Action|Crime\n30::X (1990)::Drama\n",
            encoding="latin-1")
    else:
        (d / "ratings.csv").write_text(
            "userId,movieId,rating,timestamp\n"
            "1,10,4.0,100\n2,20,3.5,50\n1,20,5.0,200\n4,10,1.0,7.0\n")
        (d / "movies.csv").write_text(
            "movieId,title,genres\n10,Toy Story (1995),Animation|Children\n"
            "20,Heat (1995),Action|Crime\n")
    return str(d)


@pytest.mark.parametrize("fmt", ["ml-100k", "ml-1m", "ml-25m"])
@pytest.mark.parametrize("threshold", [0.0, 3.0])
def test_movielens_load_matches(tmp_path, fmt, threshold):
    d = _write_movielens(tmp_path, fmt)
    assert movielens.available(d)
    got = movielens.load(d, implicit_threshold=threshold)
    want = jmovielens.load(d, implicit_threshold=threshold)
    for name in ("user_ids", "item_ids", "timestamps", "amounts",
                 "item_dept", "item_cat"):
        a, b = getattr(got, name), getattr(want, name)
        np.testing.assert_array_equal(a, b, err_msg=name)
        assert np.asarray(a).dtype == np.asarray(b).dtype, name
    assert (got.num_users, got.num_items) == (want.num_users,
                                              want.num_items)
    assert got.num_departments == want.num_departments


def test_movielens_missing_dir_raises(tmp_path):
    assert not movielens.available(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        movielens.load(str(tmp_path))
