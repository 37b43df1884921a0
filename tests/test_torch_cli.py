"""The port's CLI (``python -m ncf_tpu_torch.cli``): ``train`` then
``evaluate --protocol both`` on tiny synthetic data, ``--resume``, the
datasets of ``_load_interactions`` against the JAX package's, the
evaluation of one checkpoint by both CLIs, and every subcommand's refusal
to run without a card unless asked for the CPU (the serving subcommands'
parity is in ``tests/test_torch_serving_extras.py``).

Tolerance: the two CLIs print metrics rounded to 4 digits; on the same
checkpoint (f32, the same eval sets) they print the same numbers.
"""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

from ncf_tpu import cli as jcli  # noqa: E402
from ncf_tpu_torch import cli  # noqa: E402
from ncf_tpu_torch.train import checkpoint as ckpt  # noqa: E402

TINY = [
    "data.synthetic_users=60", "data.synthetic_items=30",
    "data.synthetic_days=20", "data.synthetic_avg_txns_per_user=8",
    "model.mf_dim=8", "model.mlp_dim=8", "model.temporal_dim=4",
    "model.mlp_hidden_dims=[16,8]", "model.compute_dtype=float32",
    "model.num_heads=2", "data.num_eval_negatives=20",
]


def _printed(out):
    """{protocol or 'best': metrics} from the CLI's printed lines."""
    got = {}
    for line in out.strip().splitlines():
        head, _, rest = line.partition(" ")
        if head in ("sampled", "full"):
            got[head] = ast.literal_eval(rest)
        elif line.startswith("{"):
            got["best"] = ast.literal_eval(line)
    return got


def _overrides(tmp_path, name="ck"):
    return TINY + [f"train.checkpoint_dir={tmp_path / name}",
                   "train.num_epochs=2", "train.batch_size=64",
                   f"train.metrics_file={tmp_path / name / 'm.jsonl'}"]


def test_train_then_evaluate_both(tmp_path, capsys):
    ov = _overrides(tmp_path)
    assert cli.main(["train", "--device", "cpu"] + ov) == 0
    best = _printed(capsys.readouterr().out)["best"]
    assert "val_loss" in best and "hr@10" in best
    best_dir = ckpt.find_best(str(tmp_path / "ck"))
    assert best_dir is not None
    with open(os.path.join(best_dir, "manifest.json")) as f:
        assert json.load(f)["metrics"]["hr@10"] == pytest.approx(
            best["hr@10"], abs=1e-4)

    assert cli.main(["evaluate", "--device", "cpu", "--protocol", "both"]
                    + ov) == 0
    got = _printed(capsys.readouterr().out)
    assert set(got) == {"sampled", "full"}
    # the sampled metrics of the best checkpoint are what validation saw
    assert got["sampled"]["hr@10"] == pytest.approx(best["hr@10"], abs=1e-4)
    assert got["full"]["eval_protocol_full"] == 1.0
    assert 0.0 <= got["full"]["hr@10"] <= 1.0

    # the JAX package's CLI prints the same numbers for this checkpoint
    args = jcli.build_parser().parse_args(["evaluate", "--protocol",
                                           "both"] + ov)
    assert args.fn(args) == 0
    assert _printed(capsys.readouterr().out) == got


def test_train_resume(tmp_path, capsys):
    ov = _overrides(tmp_path, "ck2")
    assert cli.main(["train", "--device", "cpu"] + ov[:-3]
                    + ["train.num_epochs=1", "train.batch_size=64"]) == 0
    capsys.readouterr()
    assert cli.main(["train", "--device", "cpu", "--resume"] + ov) == 0
    with open(tmp_path / "ck2" / "m.jsonl") as f:
        epochs = [json.loads(x)["epoch"] for x in f
                  if json.loads(x)["kind"] == "val"]
    assert epochs == [1]                     # epoch 0 was not run again
    assert cli.main(["evaluate", "--device", "cpu", "--checkpoint",
                     ckpt.find_latest(str(tmp_path / "ck2"))] + ov) == 0
    assert "sampled" in capsys.readouterr().out


def test_bad_override_and_unknown_command_fail():
    with pytest.raises((SystemExit, ValueError)):
        cli.main(["train", "--device", "cpu", "bogus.key=1"])
    for cmd in ("no-such-command",):
        with pytest.raises(SystemExit):
            cli.main([cmd])


def test_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ov = _overrides(tmp_path)
    for cmd in ("train", "evaluate"):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main([cmd] + ov)


@pytest.mark.parametrize("cmd", ["score", "serve", "export", "consolidate",
                                 "demo", "datagen"])
def test_serving_subcommands_default_to_the_card(tmp_path, monkeypatch, cmd):
    """Without a card each new subcommand raises before it loads data,
    writes a file or starts a server; ``serve`` is also guarded by a
    stand-in for ``api.serve`` that fails the test if it is reached."""
    from ncf_tpu_torch import api

    def no_server(*args, **kw):
        raise AssertionError("a server was started")

    monkeypatch.setattr(api, "serve", no_server)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([cmd, "--output", str(out)] if cmd in (
            "score", "export", "consolidate", "datagen") else [cmd])
    assert not out.exists()
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([cmd, "--device", "cuda"] + _overrides(tmp_path))


def _write(tmp_path, fmt):
    if fmt == "jsonl":
        rng = np.random.default_rng(0)
        p = tmp_path / "inter.jsonl"
        with open(p, "w") as f:
            for i in range(200):
                rec = {"user_id": f"u{rng.integers(20)}",
                       "item_id": int(rng.integers(15)),
                       "timestamp": 1_700_000_000 + 3600 * i}
                if i % 2:
                    rec["amount"] = float(i)
                f.write(json.dumps(rec) + "\n")
        return [f"data.dataset=jsonl", f"data.path={p}"]
    if fmt == "movielens":
        d = tmp_path / "ml-1m"
        d.mkdir()
        (d / "ratings.dat").write_text("".join(
            f"{1 + i % 7}::{10 + i % 5}::{1 + i % 5}::{100 + i}\n"
            for i in range(60)))
        (d / "movies.dat").write_text(
            "10::A (1995)::Animation\n11::B (1995)::Action|Crime\n",
            encoding="latin-1")
        return ["data.dataset=movielens", f"data.path={d}"]
    return ["data.dataset=synthetic"] + TINY[:4]


@pytest.mark.parametrize("fmt", ["synthetic", "jsonl", "movielens"])
def test_load_interactions_matches(tmp_path, fmt):
    ov = _write(tmp_path, fmt)
    args = cli.build_parser().parse_args(["train"] + ov)
    got = cli._load_interactions(cli.load_config(args))
    jargs = jcli.build_parser().parse_args(["train"] + ov)
    want = jcli._load_interactions(jcli.load_config(jargs))
    for name in ("user_ids", "item_ids", "timestamps", "amounts",
                 "item_dept", "item_cat"):
        a, b = getattr(got, name), getattr(want, name)
        if b is None:
            assert a is None, name
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_movielens_needs_a_path():
    args = cli.build_parser().parse_args(["train", "data.dataset=movielens"])
    with pytest.raises(SystemExit, match="data.path"):
        cli._load_interactions(cli.load_config(args))


def test_runs_as_a_module():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-m", "ncf_tpu_torch.cli",
                          "--help"], capture_output=True, text=True,
                         cwd=root, timeout=120)
    assert out.returncode == 0
    for cmd in ("train", "evaluate", "score", "serve", "export", "datagen",
                "consolidate", "demo"):
        assert cmd in out.stdout
