"""The port's ``doctor`` against the JAX package's.

``estimate_train_hbm`` gives the JAX package's byte count for every
shipped config; ``doctor --device cpu`` runs the eight checks in the JAX
doctor's order with the same statuses for the checks that do not look at
the device (``config``, ``mesh``, ``artifact_store``, ``native``,
``redis``), and warns that there is no card for the three that do; a bad
config fails both; the mesh check counts ranks; without a card and
without ``--device cpu`` the subcommand raises as every other does.  The
JAX package is imported inside the tests that compare with it, so the
card test at the end runs without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_doctor.py
"""

import glob
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ncf_tpu_torch.cli import main  # noqa: E402
from ncf_tpu_torch.utils import doctor  # noqa: E402
from ncf_tpu_torch.utils.config import Config  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the shipped configurations of both packages (configs/), and the port's
# own (ncf_tpu_torch/configs/: models the JAX package does not have)
CONFIGS = (sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))
           + sorted(glob.glob(os.path.join(ROOT, "ncf_tpu_torch", "configs",
                                           "*.yaml"))))
NAMES = ["config", "devices", "compile", "hbm", "mesh", "artifact_store",
         "native", "redis"]


def test_eight_configs_shipped():
    # the eight AdvancedNCF/NCF configurations under configs/, and
    # HSTU's among the port's own
    port = os.path.join(ROOT, "ncf_tpu_torch", "configs")
    assert len(CONFIGS) == 9
    assert [os.path.basename(p) for p in CONFIGS
            if p.startswith(port)] == ["hstu_large_retail4m.yaml"]


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_estimate_train_hbm_equal(path):
    from ncf_tpu.utils.config import Config as JConfig
    from ncf_tpu.utils.doctor import estimate_train_hbm as jestimate

    est = doctor.estimate_train_hbm(Config.from_yaml(path))
    assert est == jestimate(JConfig.from_yaml(path)) > 0


def test_estimate_bigvocab_at_its_trained_vocabulary():
    cfg = Config.from_yaml(os.path.join(ROOT, "configs",
                                        "advanced_ncf_bigvocab.yaml"))
    cfg.apply_overrides(["model.num_users=12000000",
                         "model.num_items=4000000"])
    assert doctor.estimate_train_hbm(cfg) == 16_733_130_752


def _report(lines):
    """[(name, icon)] of the check lines, in order."""
    rows = [ln.split(None, 2) for ln in lines if not ln.startswith("doctor:")]
    return [(r[1], r[0]) for r in rows]


def _jax_doctor(argv, capsys):
    from ncf_tpu.cli import build_parser

    args = build_parser().parse_args(argv)
    rc = args.fn(args)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("config", [None, "advanced_ncf_ml25m_sharded.yaml"])
def test_doctor_on_the_cpu_against_the_jax_doctor(config, tmp_path, capsys):
    argv = ["doctor", f"train.checkpoint_dir={tmp_path}/ck"]
    if config:
        argv += ["--config", os.path.join(ROOT, "configs", config)]
    rc = main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    port = _report(out.splitlines())
    assert [n for n, _ in port] == NAMES
    assert out.splitlines()[-1] == "doctor: all checks passed"
    j_rc, j_out = _jax_doctor(argv, capsys)
    ref = _report(j_out.splitlines())
    assert [n for n, _ in ref] == NAMES and j_rc == rc
    same = {"config", "mesh", "artifact_store", "native", "redis"}
    assert ([p for p in port if p[0] in same]
            == [r for r in ref if r[0] in same])
    # the card's checks warn that there is none; none ran on the CPU
    assert dict(port)["devices"] == dict(port)["compile"] == "!"
    assert dict(port)["hbm"] == "!"
    assert "no card" in out and "not built" in out


def test_doctor_fails_on_bad_config(tmp_path, capsys):
    argv = ["doctor", "model.negative_samples=0",
            f"train.checkpoint_dir={tmp_path}/ck"]
    assert main(argv + ["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "negative_samples" in out and "FAILURES" in out
    j_rc, j_out = _jax_doctor(argv, capsys)
    assert j_rc == 1 and "negative_samples" in j_out


@pytest.mark.parametrize("enable,dcn,ici,status,text", [
    ("on", 64, 64, "fail", "4096"),
    ("on", 1, 2, "fail", "--nproc-per-node 2"),
    ("auto", 1, 2, "warn", "one process: no mesh"),
    ("auto", 1, -1, "ok", "one process"),
    ("on", 1, -1, "ok", "fits 1 rank"),
    ("off", 64, 64, "ok", "mesh.enable=off"),
])
def test_mesh_check_counts_ranks(enable, dcn, ici, status, text):
    cfg = Config()
    cfg.mesh.enable, cfg.mesh.dcn_axis, cfg.mesh.ici_axis = enable, dcn, ici
    name, got, msg = doctor.check_mesh(cfg, device="cpu")
    assert (name, got) == ("mesh", status), msg
    assert text in msg
    if status == "fail":
        assert "torch.distributed.run" in msg and "XLA_FLAGS" not in msg
        assert "gloo" in msg


def test_doctor_needs_a_card_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["doctor", f"train.checkpoint_dir={tmp_path}/ck"])
    with pytest.raises(RuntimeError, match="CUDA"):
        doctor.run(Config())
    assert not (tmp_path / "ck").exists()


@pytest.mark.cuda
def test_compile_check_on_the_card(tmp_path, capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ncf_tpu_torch.ops.gather import gather_rows

    name, status, msg = doctor.check_devices("cuda")
    assert (name, status) == ("devices", "ok"), msg
    before = gather_rows.launches.value
    name, status, msg = doctor.check_compile_smoke("cuda")
    assert (name, status) == ("compile", "ok"), msg
    assert "bit for bit" in msg and gather_rows.launches.value == before + 1
    assert main(["doctor", f"train.checkpoint_dir={tmp_path}/ck"]) == 0
    assert "hbm" in capsys.readouterr().out
