"""Sharded checkpoints between the packages and across topologies: the
port's 2-rank sharded checkpoint read by the JAX package's ``restore``
and ``consolidate`` and by the port on 4 ranks and on 1; a checkpoint of
the JAX package's ``(1, 2)``-sharded state read by the port on 2 ranks
and on 1.  Every leaf equal to what was saved.  The port's ranks are
gloo ranks on the CPU (``ncf_tpu_torch.parallel.workers``).
"""

import glob
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ncf_tpu.models import advanced_ncf as jmodel  # noqa: E402
from ncf_tpu.parallel import (param_shardings, shard_pytree,  # noqa: E402
                              state_shardings)
from ncf_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from ncf_tpu.train import checkpoint as jckpt  # noqa: E402
from ncf_tpu.train import optim as joptim  # noqa: E402
from ncf_tpu.utils.config import Config as JConfig  # noqa: E402
from ncf_tpu_torch.convert import params_from_numpy  # noqa: E402
from ncf_tpu_torch.parallel import workers  # noqa: E402
from ncf_tpu_torch.train import checkpoint as tckpt  # noqa: E402
from ncf_tpu_torch.train.checkpoint import _leaves_with_path  # noqa: E402
from ncf_tpu_torch.utils.config import Config  # noqa: E402


def _flat(tree, prefix):
    """``{prefix.path: array}`` under the checkpoint's leaf names."""
    return {f"{prefix}.{p}": (v.detach().numpy()
                              if isinstance(v, torch.Tensor)
                              else np.asarray(v))
            for p, v in _leaves_with_path(tree)}


def _ckpt_cfg():
    cfg, jcfg = Config(), JConfig()
    for c in (cfg, jcfg):
        c.model.num_users, c.model.num_items = 40, 24
        c.model.mf_dim = c.model.mlp_dim = 8
        c.model.temporal_dim, c.model.mlp_hidden_dims = 4, [16, 8]
    return cfg, jcfg


def _jax_state(jcfg, seed=0):
    rng = np.random.default_rng(seed)
    noisy = lambda x: (np.asarray(x) + rng.normal(size=x.shape)).astype(
        np.float32)
    params = jax.tree.map(noisy, jmodel.init(jax.random.PRNGKey(seed),
                                             jcfg.model))
    opt = joptim.make_optimizer(jcfg.train)
    state = opt.init(jax.tree.map(jnp.asarray, params))
    adam = [s for s in state if hasattr(s, "mu")][0]
    mu, nu = jax.tree.map(noisy, adam.mu), jax.tree.map(
        lambda x: np.abs(noisy(x)), adam.nu)
    return params, mu, nu, opt


def _restored(io, world):
    outs = [workers.load_outputs(io, r)[0] for r in range(world)]
    return outs


def _check_parts(outs, ici, full, prefix, sharded):
    """Rank r's part of every leaf equal to the saved whole."""
    for name, arr in full.items():
        for r, o in enumerate(outs):
            got = o[f"{prefix}.{name}"]
            if sharded(name):
                R = arr.shape[0] // ici
                i = r % ici
                np.testing.assert_array_equal(got, arr[i * R:(i + 1) * R],
                                              err_msg=name)
            else:
                np.testing.assert_array_equal(got, arr, err_msg=name)


def test_sharded_checkpoints_move_between_packages_and_topologies(tmp_path):
    cfg, jcfg = _ckpt_cfg()
    params, mu, nu, jopt = _jax_state(jcfg)
    is_table = lambda n: n.split(".")[-1] in ("user_emb", "item_emb")

    # the port's 2-rank sharded checkpoint
    d = str(tmp_path / "port")
    io = str(tmp_path / "save")
    workers.save_inputs(io, {**_flat(params, "params"), **_flat(mu, "mu"),
                             **_flat(nu, "nu")},
                        {"config": cfg.to_dict(), "count": 3, "step": 7,
                         "dir": d})
    workers.run("ckpt_save", 2, io, device="cpu")
    ck = tckpt.find_latest(d)
    man = json.load(open(os.path.join(ck, "manifest.json")))
    kinds = {k: v["kind"] for k, v in man["leaves"].items()}
    assert kinds["params.user_emb"] == kinds["opt_state.2.mu.item_emb"] == (
        "sharded")
    assert kinds["params.mlp.0.dense.w"] == "dense"
    assert len(glob.glob(os.path.join(ck, "*.shard*.npy"))) == 2 * 6

    # read by the JAX package: restore and consolidate
    jt = {"params": jax.tree.map(jnp.asarray, params),
          "opt_state": jopt.init(jax.tree.map(jnp.asarray, params))}
    state, _ = jckpt.restore(ck, jt)
    for (p, got), (_, want) in zip(
            jax.tree_util.tree_leaves_with_path(state["params"]),
            jax.tree_util.tree_leaves_with_path(params)):
        np.testing.assert_array_equal(np.asarray(got), want)
    jadam = [s for s in state["opt_state"] if hasattr(s, "mu")][0]
    for got, want in zip(jax.tree_util.tree_leaves(jadam.mu),
                         jax.tree_util.tree_leaves(mu)):
        np.testing.assert_array_equal(np.asarray(got), want)
    assert int(jadam.count) == 3
    cons = jckpt.consolidate(ck, str(tmp_path / "cons"))
    cman = json.load(open(os.path.join(cons, "manifest.json")))
    assert {v["kind"] for v in cman["leaves"].values()} <= {"dense",
                                                            "scalar"}
    np.testing.assert_array_equal(
        np.load(os.path.join(cons, "params.user_emb.npy")),
        params["user_emb"])

    # read by the port on 4 ranks (the 2-rank shards re-cut) and on 1
    full = _flat(params, "params")
    full = {k[len("params."):]: v for k, v in full.items()}
    io4 = str(tmp_path / "r4")
    workers.save_inputs(io4, {}, {"config": cfg.to_dict(), "dir": ck})
    workers.run("ckpt_restore", 4, io4, device="cpu")
    _check_parts(_restored(io4, 4), 4, full, "params", is_table)
    one, _ = tckpt.restore(ck, {"params": params_from_numpy(
        jax.tree.map(np.zeros_like, params), "cpu")}, device="cpu")
    for p, v in _leaves_with_path(one["params"]):
        np.testing.assert_array_equal(v.numpy(), full[p])

    # a checkpoint of the JAX package's (1, 2)-sharded state, read by the
    # port on 2 ranks and on 1
    mesh = jmake_mesh(dcn=1, ici=2, devices=jax.devices()[:2])
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jparams)
    jparams = shard_pytree(jparams, param_shardings(jparams, mesh))
    jstate = shard_pytree(jstate, state_shardings(jstate, mesh))
    jd = str(tmp_path / "jax")
    jck = jckpt.save(jd, {"params": jparams, "opt_state": jstate}, step=4)
    io2 = str(tmp_path / "r2")
    workers.save_inputs(io2, {}, {"config": cfg.to_dict(), "dir": jck})
    workers.run("ckpt_restore", 2, io2, device="cpu")
    _check_parts(_restored(io2, 2), 2, full, "params", is_table)
    one, _ = tckpt.restore(jck, {"params": params_from_numpy(
        jax.tree.map(np.zeros_like, params), "cpu")}, device="cpu")
    for p, v in _leaves_with_path(one["params"]):
        np.testing.assert_array_equal(v.numpy(), full[p])
