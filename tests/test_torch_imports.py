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
                 "ncf_tpu_torch.train.sparse",
                 "ncf_tpu_torch.train.step", "ncf_tpu_torch.ops.tower",
                 "ncf_tpu_torch.ops.gather", "ncf_tpu_torch.models.ncf",
                 "ncf_tpu_torch.train.trainer", "ncf_tpu_torch.train.autotune",
                 "ncf_tpu_torch.utils.logging", "ncf_tpu_torch.utils.artifacts",
                 "ncf_tpu_torch.data.movielens", "ncf_tpu_torch.cli",
                 "ncf_tpu_torch.serving.dtos", "ncf_tpu_torch.serving.cache",
                 "ncf_tpu_torch.serving.features",
                 "ncf_tpu_torch.serving.export", "ncf_tpu_torch.serving.ann",
                 "ncf_tpu_torch.serving.intelligence", "ncf_tpu_torch.api",
                 "ncf_tpu_torch.api.app", "ncf_tpu_torch.api.demo_page",
                 "ncf_tpu_torch.parallel", "ncf_tpu_torch.parallel.mesh",
                 "ncf_tpu_torch.parallel.multihost",
                 "ncf_tpu_torch.parallel.embedding_sharding",
                 "ncf_tpu_torch.parallel.sharded_topk",
                 "ncf_tpu_torch.parallel.launch",
                 "ncf_tpu_torch.parallel.dryrun",
                 "ncf_tpu_torch.parallel.workers",
                 "ncf_tpu_torch.train.sparse_sharded",
                 "ncf_tpu_torch.data.schemas", "ncf_tpu_torch.data.generators",
                 "ncf_tpu_torch.naming", "ncf_tpu_torch.naming.parser",
                 "ncf_tpu_torch.naming.prompts",
                 "ncf_tpu_torch.naming.validators",
                 "ncf_tpu_torch.naming.generator",
                 "ncf_tpu_torch.naming.http_client",
                 "ncf_tpu_torch.utils.monitoring",
                 "ncf_tpu_torch.utils.profiling",
                 "ncf_tpu_torch.utils.doctor"):
        assert name in mods


# names of a JAX ``__all__`` with no port counterpart, and why
ALL_EXCEPTIONS = {
    ("parallel", "stacked_batch_sharding"):
        "a jax NamedSharding for stacked [K, B] batches; a rank's batch "
        "slice has no sharding object in PyTorch",
}


def _jax_packages():
    import ncf_tpu

    return sorted(m.name for m in pkgutil.walk_packages(
        ncf_tpu.__path__, "ncf_tpu.") if m.ispkg) + ["ncf_tpu"]


@pytest.mark.parametrize("jax_pkg", _jax_packages())
def test_every_jax_export_has_a_port_counterpart(jax_pkg):
    """Every name a JAX package ``__init__`` exports, the port's
    counterpart package exports too (the stated exceptions aside)."""
    import importlib

    sub = jax_pkg.partition(".")[2]
    ref = importlib.import_module(jax_pkg)
    port = importlib.import_module(
        "ncf_tpu_torch" + (f".{sub}" if sub else ""))
    missing = sorted(n for n in getattr(ref, "__all__", [])
                     if (sub, n) not in ALL_EXCEPTIONS
                     and (n not in getattr(port, "__all__", [n])
                          or not hasattr(port, n)))
    assert missing == [], f"{port.__name__} lacks {missing}"


def test_the_port_has_every_module_of_the_jax_package():
    """Each module of ``ncf_tpu`` but the Pallas kernel files has a
    counterpart of the same path under ``ncf_tpu_torch``."""
    import ncf_tpu

    ref = {m.name.partition(".")[2] for m in pkgutil.walk_packages(
        ncf_tpu.__path__, "ncf_tpu.")}
    port = {m.partition(".")[2] for m in _modules()}
    kernels = {m for m in ref if m.startswith("ops.pallas_")}
    built = {"native.libncf_native"}     # the C++ library, not a module
    assert sorted(ref - kernels - built - port) == []


def test_importing_the_port_loads_no_jax():
    assert "ncf_tpu_torch.utils.doctor" in _modules()
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


def test_the_api_loads_neither_jax_nor_pydantic():
    code = textwrap.dedent("""
        import sys
        import ncf_tpu_torch.api, ncf_tpu_torch.serving, ncf_tpu_torch.cli
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "ncf_tpu", "pydantic",
                                            "pydantic_core"))
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
    assert "pydantic" not in src
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
                                     "topk_exact", "topk_segmax", "gather",
                                     "hstu_attention"}
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


def test_training_entry_points_default_to_the_card(monkeypatch):
    from ncf_tpu_torch import cli
    from ncf_tpu_torch.data import generate_interactions
    from ncf_tpu_torch.data.pipeline import (DeviceEpochPipeline,
                                             prefetch_to_device)
    from ncf_tpu_torch.train import Trainer
    from ncf_tpu_torch.utils.config import Config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    inter = generate_interactions(num_users=20, num_items=15, num_days=10,
                                  avg_txns_per_user=4, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(Config(), inter)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceEpochPipeline(inter, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        next(prefetch_to_device(iter([{"a": [1]}])))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["evaluate", "data.synthetic_users=20",
                  "data.synthetic_items=15"])
    assert DeviceEpochPipeline(inter, 8, device="cpu").device.type == "cpu"


def test_serving_entry_points_default_to_the_card(monkeypatch, tmp_path):
    import numpy as np

    from ncf_tpu_torch.api import RecommendationAPI
    from ncf_tpu_torch.models import advanced_ncf
    from ncf_tpu_torch.serving import (ModelServer, ProductSearch,
                                       export_product_embeddings,
                                       export_user_embeddings)
    from ncf_tpu_torch.utils.config import Config

    cfg = Config()
    cfg.model.num_users, cfg.model.num_items = 20, 15
    cfg.model.mf_dim = cfg.model.mlp_dim = 8
    cfg.model.temporal_dim, cfg.model.mlp_hidden_dims = 4, [8]
    params = advanced_ncf.init(torch.Generator().manual_seed(0), cfg.model,
                               device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    emb = np.eye(4, dtype=np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        ProductSearch(emb)
    with pytest.raises(RuntimeError, match="CUDA"):
        export_product_embeddings(params, cfg, str(tmp_path / "p.jsonl"))
    with pytest.raises(RuntimeError, match="CUDA"):
        export_user_embeddings(params, cfg, str(tmp_path / "u.jsonl"))
    assert not list(tmp_path.iterdir())
    # the API's server is a ModelServer: it takes the card by default too
    with pytest.raises(RuntimeError, match="CUDA"):
        RecommendationAPI(ModelServer(cfg, params=params))
    # asked for the CPU, they run there
    assert ProductSearch(emb, device="cpu").find_neighbors(emb[1], 1)[0][0][0] == 1
    server = ModelServer(cfg, params=params, device="cpu")
    try:
        assert RecommendationAPI(server).dispatch("GET", "/health",
                                                  None)[0] == 200
    finally:
        server.close()
    export_user_embeddings(params, cfg, str(tmp_path / "u.jsonl"),
                           device="cpu")
    assert (tmp_path / "u.jsonl").exists()


def test_sparse_entry_points_default_to_the_card(monkeypatch):
    from ncf_tpu_torch.models import get_model
    from ncf_tpu_torch.train import (make_optimizer, make_schedule,
                                     make_sparse_multi_train_step,
                                     make_sparse_train_step)
    from ncf_tpu_torch.utils.config import Config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config()
    cfg.train.embedding_optimizer = "rowwise_adagrad"
    for build in (make_sparse_train_step, make_sparse_multi_train_step):
        with pytest.raises(RuntimeError, match="CUDA"):
            build(get_model("advanced_ncf"), cfg, make_optimizer(cfg.train),
                  make_schedule(cfg.train, 10))


def test_parallel_entry_points_default_to_the_card(monkeypatch):
    """Without a card the parallel layer's entry points raise unless
    asked for the CPU; one process needs no process group."""
    from ncf_tpu_torch.parallel import initialize_distributed, make_mesh
    from ncf_tpu_torch.parallel import multihost
    from ncf_tpu_torch.parallel.launch import main as launch_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        multihost.rank_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        initialize_distributed(init_method="file:///nonexistent/store",
                               world_size=2, rank=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_main(["--single-process", "--device", "cuda"])
    assert initialize_distributed() == (0, 1)        # one process: no-op
    assert make_mesh().shape == {"dcn": 1, "ici": 1}
    assert multihost.rank_device("cpu").type == "cpu"
    assert multihost.choose_backend("cuda", 2, 1)[0] == "gloo"
    assert multihost.choose_backend("cuda", 4, 4)[0] == "nccl"
    assert multihost.choose_backend("cpu", 2, 0)[0] == "gloo"
