"""The port imports neither JAX nor the JAX package, and its entry points
refuse to fall back to the CPU when no card is present."""

import os
import pkgutil
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

import ncf_tpu_torch  # noqa: E402


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        ncf_tpu_torch.__path__, "ncf_tpu_torch."))


def test_every_module_is_listed():
    mods = _modules()
    for name in ("ncf_tpu_torch.ops.topk", "ncf_tpu_torch.ops._kernels",
                 "ncf_tpu_torch.serving.server", "ncf_tpu_torch.convert",
                 "ncf_tpu_torch.train.checkpoint",
                 "ncf_tpu_torch.ops.sampler", "ncf_tpu_torch.ops.scatter",
                 "ncf_tpu_torch.ops.temporal_sum",
                 "ncf_tpu_torch.ops.embedding", "ncf_tpu_torch.native",
                 "ncf_tpu_torch.data.interactions",
                 "ncf_tpu_torch.data.synthetic",
                 "ncf_tpu_torch.data.pipeline", "ncf_tpu_torch.data.sampler",
                 "ncf_tpu_torch.evals.metrics",
                 "ncf_tpu_torch.evals.evaluate",
                 "ncf_tpu_torch.evals.full_eval", "ncf_tpu_torch.train.optim",
                 "ncf_tpu_torch.train.step", "ncf_tpu_torch.ops.tower",
                 "ncf_tpu_torch.ops.gather", "ncf_tpu_torch.models.ncf"):
        assert name in mods


def test_importing_the_port_loads_no_jax():
    code = textwrap.dedent(f"""
        import importlib, sys
        for name in {_modules() + ["ncf_tpu_torch"]!r}:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m in ("jax", "ncf_tpu") or m.startswith("jax.")
                     or m.startswith("ncf_tpu."))
        print(bad)
        sys.exit(1 if bad else 0)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_chip_smoke_imports_no_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "chip_smoke.py")) as f:
        src = f.read()
    assert "import jax" not in src and "from jax" not in src
    assert "ncf_tpu." not in src.replace("ncf_tpu_torch.", "")


def test_entry_points_default_to_the_card(monkeypatch):
    from ncf_tpu_torch.convert import params_from_numpy
    from ncf_tpu_torch.serving import ModelServer
    from ncf_tpu_torch.utils.config import Config
    from ncf_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ModelServer(Config())
    with pytest.raises(RuntimeError, match="CUDA"):
        ModelServer.from_checkpoint(Config(), "no-such-checkpoint")
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({"w": [1.0]})
    from ncf_tpu_torch.models import get_model
    from ncf_tpu_torch.train import make_optimizer, make_train_step

    ncf_cfg = Config()
    ncf_cfg.model.name = "neumf"
    with pytest.raises(RuntimeError, match="CUDA"):
        ModelServer(ncf_cfg)
    cfg = Config()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(get_model("advanced_ncf"), cfg,
                        make_optimizer(cfg.train))
    assert resolve_device("cpu").type == "cpu"


def test_eval_entry_points_default_to_the_card(monkeypatch):
    import numpy as np

    from ncf_tpu_torch.data import generate_interactions
    from ncf_tpu_torch.evals import (DeviceEvaluator, EvalSet,
                                     FullCatalogEvaluator, evaluate,
                                     full_ranks_naive, make_score_fn)
    from ncf_tpu_torch.models import advanced_ncf
    from ncf_tpu_torch.utils.config import ModelConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    inter = generate_interactions(num_users=20, num_items=15, num_days=10,
                                  avg_txns_per_user=4, seed=0)
    _, users, items = inter.leave_one_out()
    es = EvalSet.build(inter, users, items, num_negatives=5)
    cfg = ModelConfig(num_users=20, num_items=15, mf_dim=8, mlp_dim=8,
                      temporal_dim=4, mlp_hidden_dims=[8], num_heads=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceEvaluator(advanced_ncf, cfg, es)
    with pytest.raises(RuntimeError, match="CUDA"):
        FullCatalogEvaluator(cfg, inter, users, items)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_score_fn(advanced_ncf, {}, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate(lambda u, c, t: c.float(), es)
    with pytest.raises(RuntimeError, match="CUDA"):
        full_ranks_naive(advanced_ncf, {}, cfg, inter, users, items)
    # asked for the CPU, they run there
    ranks = DeviceEvaluator(advanced_ncf, cfg, es, device="cpu").ranks(
        advanced_ncf.init(torch.Generator().manual_seed(0), cfg,
                          device="cpu"))
    assert ranks.shape == (len(users),) and (ranks >= 0).all()
    assert evaluate(lambda u, c, t: torch.zeros(c.shape), es,
                    device="cpu")["hr@1"] == 0.0
    assert np.isfinite(list(evaluate(lambda u, c, t: c.float(), es,
                                     device="cpu").values())).all()


def test_the_kernel_loader_builds_nothing_on_import():
    from ncf_tpu_torch.ops import _kernels

    assert _kernels._libs == {}
    assert set(_kernels.SOURCES) == {"topk_streaming", "tree_sampler",
                                     "scatter_add", "temporal_sum",
                                     "fused_tower", "topk_streaming_int8",
                                     "topk_exact", "topk_segmax", "gather"}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name in _kernels.SOURCES:
        assert os.path.exists(os.path.join(
            root, "ncf_tpu_torch", "ops", "csrc", name + ".cu"))
    assert _kernels.NVCC_FLAGS[:2] == ["-gencode",
                                       "arch=compute_90a,code=sm_90a"]
    # the top-k kernels share a header: editing it changes every top-k
    # library's name, so they rebuild
    assert os.path.exists(os.path.join(root, "ncf_tpu_torch", "ops", "csrc",
                                       "topk_common.cuh"))
    assert os.path.basename(_kernels._target("topk_exact")[1]).startswith(
        "libtopk_exact_")
