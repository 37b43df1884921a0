"""HSTU (``models/hstu.py``) on the CPU against the benchmark's plain
reference (``benchmark/reference/hstu.py``), without JAX.

At the published widths (item dimension 50, 2 heads of 25) with 2
blocks, N 64, jagged lengths of 1 to 64 and a 1,000-item table: the
encoder's output, the loss and every leaf's gradient (w_pos, w_ts and
the item table's touched rows included), then two steps of
``make_sparse_train_step`` against the reference's steps, rows left
untouched included; and one hand-worked case of the relative bias's
indexing.

Tolerances, and why:

- the forward (encoder output, loss): both run the same f32 arithmetic
  on the same bf16-rounded operands and differ only in the order of
  their f32 sums (the port's products are batched over heads and
  sequences, the reference's are not): 2e-5 of the largest entry, 1e-5
  of the loss;
- the gradients: the port's casts round the gradient to bf16 on its way
  back through each bf16 operand (autograd's rule for a cast), where the
  reference passes it in f32; an element may move by 2^-9 of itself, so
  each leaf's gradient is held to 1e-2 of its norm, by the norm of the
  difference;
- two steps: Adam's first steps move an element by about the learning
  rate whatever the size of its gradient, so an element whose gradient
  changes sign under those roundings moves 2 lr apart, and k such
  elements of n read 2 sqrt(k / n) (0.2% of a weight's elements here,
  0.09; one of a 50-element bias, 0.28): the median leaf's change is
  held to 5e-2 of its norm and every leaf's to 0.3; rowwise Adagrad scales a row by its own
  norm, so the table's touched rows are held to 1e-2; untouched rows
  keep their bits;
- the attention kernel on the card (``cuda`` marker, skipped without a
  card) against the op's plain path: both round Q, K, V and A to bf16
  and sum in f32 in other orders, and A's rounding can flip where z
  differs in its last bits: 2e-4 of the output's norm (3.9e-5 read at
  8,192 positions on an H100); its backward rounds dO and dS to bf16 for
  its products where autograd keeps the plain path's in f32, 2^-9 an
  element: each gradient within 1e-2 of its norm (3.0e-3 read); two
  runs of the backward agree bit for bit.
"""

import copy
import dataclasses
import math

import numpy as np
import pytest
import torch

from benchmark import weights as bench_weights
from benchmark.reference import hstu as ref
from ncf_tpu_torch.models import get_model, hstu
from ncf_tpu_torch.ops.hstu_attention import (Plan, hstu_attention,
                                              hstu_attention_ref,
                                              relative_bias, ts_bucket)
from ncf_tpu_torch.train import (init_sparse_opt_state, make_optimizer,
                                 make_schedule, make_sparse_train_step)
from ncf_tpu_torch.train.step import sparse_mode_available
from ncf_tpu_torch.utils.config import Config

N = 64
LENS = [1, 7, 64, 33, 2, 17, 50]


def _cfg():
    cfg = Config()
    m = cfg.model
    m.name = "hstu"
    m.num_items = 1000
    m.item_embedding_dim = 50
    m.num_heads, m.attention_dim, m.linear_dim = 2, 25, 25
    m.num_blocks, m.max_sequence_length = 2, N
    m.negative_samples = 16
    m.dropout = 0.2
    m.temperature = 0.05
    m.compute_dtype = "bfloat16"
    t = cfg.train
    t.embedding_optimizer = "rowwise_adagrad"
    t.embedding_learning_rate = 0.01
    t.embedding_weight_decay = 1e-5
    t.weight_decay = 1e-5
    t.learning_rate = 1e-3
    t.gradient_clip_norm = 5.0
    return cfg


def _batch(seed=3, lens=LENS):
    g = np.random.default_rng(seed)
    off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    T = int(off[-1])
    ts = []
    for L in lens:
        gaps = g.integers(3600, 5_000_000, L) * (g.random(L) < 0.5)
        gaps[0] = 0
        ts.append(1_500_000_000 + np.cumsum(gaps))
    return {"item_ids": torch.from_numpy(g.integers(0, 1000, T)),
            "timestamps": torch.from_numpy(np.concatenate(ts)),
            "offsets": off}


def _params(cfg, seed=0):
    return get_model("hstu").init(torch.Generator().manual_seed(seed),
                                  cfg.model)


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def test_the_relative_bias_by_hand():
    """4 positions at 0 s, 10 s, 1,000 s and 86,400 s; t_{i+1} - t_j in
    row i, with t_4 := t_3: the buckets floor(ln(gap) / 0.301) are 7
    (10 s), 22 (990 and 1,000 s), 37 (85,400 to 86,400 s), and 0 for a gap
    of 0, which counts as 1 s."""
    n = 8
    ts = torch.tensor([0, 10, 1000, 86400])
    want_bucket = [[7], [22, 22], [37, 37, 37], [37, 37, 37, 0]]
    w_pos = torch.arange(2 * n - 1, dtype=torch.float32) * 1000.0
    w_ts = torch.arange(129, dtype=torch.float32)
    for rab in (relative_bias(w_pos, w_ts, ts, n),
                ref.bias(w_pos, w_ts, ts, n)):
        for i in range(4):
            for j in range(i + 1):
                assert rab[i, j] == 1000.0 * (n - 1 + j - i) \
                    + want_bucket[i][j], (i, j, rab[i, j])
    assert ts_bucket(torch.tensor([0, 1, 2, -10, 10, 1000, 10**12])).tolist() \
        == [0, 0, 2, 7, 7, 22, 91]
    assert ts_bucket(torch.tensor([2**62])).item() == 128     # clamped


def test_the_encoder_matches_the_reference():
    cfg = _cfg()
    m = cfg.model
    params = _params(cfg)
    batch = hstu.batch_to(_batch(), "cpu")
    x = hstu.encode(params, m, batch, None, training=False)
    off = batch["offsets"]
    for s in range(len(off) - 1):
        a, b = int(off[s]), int(off[s + 1])
        want = ref.encode(params, m, params["item_emb"][
            batch["item_ids"][a:b]], batch["timestamps"][a:b], None,
            "bfloat16")
        got = x[a:b]
        assert (got - want).abs().max() <= 2e-5 * want.abs().max(), s


def test_the_loss_and_every_gradient_match_the_reference():
    cfg = _cfg()
    m = cfg.model
    params = _params(cfg)
    raw = _batch()
    gen = torch.Generator().manual_seed(11)
    model = get_model("hstu")
    loss_fn = model.make_loss_fn(model, cfg, True)
    leaves = [p.detach().requires_grad_(True)
              for _, p in bench_weights.leaves(params)]
    names = [k for k, _ in bench_weights.leaves(params)]
    it = iter(leaves)
    tracked = bench_weights._map(params, lambda path, _: next(it))
    batch = hstu.batch_to(raw, "cpu")
    loss, _, _ = loss_fn(tracked, batch, gen, {})
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    loss = float(loss.detach())

    run = ref.Reference(m, cfg.train, copy.deepcopy(params),
                        torch.Generator().manual_seed(11))
    want_loss, want_g, rows, totals = run.loss_and_grads(raw)
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    for name, g in want_g.items():
        assert _rel(grads[name], g) <= 1e-2, (name, _rel(grads[name], g))
    assert {"blocks/0/w_pos", "blocks/1/w_ts"} <= set(want_g)
    assert float(want_g["blocks/0/w_ts"].norm()) > 0
    table = grads["item_emb"]
    assert _rel(table[rows], totals) <= 1e-2
    untouched = torch.ones(m.num_items, dtype=torch.bool)
    untouched[rows] = False
    assert torch.count_nonzero(table[untouched]) == 0


def test_two_sparse_steps_match_the_reference():
    cfg = _cfg()
    m, t = cfg.model, cfg.train
    assert sparse_mode_available(cfg)
    params = _params(cfg, seed=1)
    start = copy.deepcopy(params)
    batches = [_batch(5), _batch(6, [64, 3, 40, 9])]
    model = get_model("hstu")
    opt = make_optimizer(dataclasses.replace(t, gradient_clip_norm=0.0), 2)
    state = init_sparse_opt_state(opt, params)
    assert set(state) == {"dense", "item_acc", "count"}
    step = make_sparse_train_step(model, cfg, opt, make_schedule(t, 2),
                                  device="cpu")
    gen = torch.Generator().manual_seed(21)
    for b in batches:
        params, state, gen, met = step(params, state, gen, b)
        assert math.isfinite(float(met["loss"]))

    run = ref.Reference(m, t, copy.deepcopy(start),
                        torch.Generator().manual_seed(21))
    for b in batches:
        run.step(b)
    got = dict(bench_weights.leaves(params))
    first = dict(bench_weights.leaves(start))
    gaps = {name: _rel(got[name] - first[name], want - first[name])
            for name, want in run.params.items() if name != "item_emb"}
    assert sorted(gaps.values())[len(gaps) // 2] <= 5e-2, gaps
    assert max(gaps.values()) <= 0.3, gaps
    touched = torch.zeros(m.num_items, dtype=torch.bool)
    for b in batches:
        touched[b["item_ids"]] = True
    moved = (run.params["item_emb"] != first["item_emb"]).any(1)
    assert bool(moved[touched].all())
    rows = moved
    assert _rel(got["item_emb"][rows] - first["item_emb"][rows],
                run.params["item_emb"][rows] - first["item_emb"][rows]) <= 1e-2
    assert torch.equal(got["item_emb"][~rows], first["item_emb"][~rows])
    assert torch.equal(state["item_acc"][~rows],
                       torch.zeros(int((~rows).sum())))


def test_one_position_sequences_have_no_target():
    src, tgt = hstu.targets(np.array([0, 1, 4, 5, 7]))
    assert src.tolist() == [1, 2, 5] and tgt.tolist() == [2, 3, 6]


@pytest.mark.parametrize("lens", [[1], [64], [65, 1, 130]])
def test_the_plan_lists_every_tile_once(lens):
    off = np.concatenate([[0], np.cumsum(lens)])
    plan = Plan(off, "cpu")
    tiles = sum(-(-L // 64) for L in lens)
    assert plan.n_tiles == tiles
    assert plan.pairs_useful == sum(L * (L + 1) // 2 for L in lens)
    assert plan.tile_pairs == sum(k * (k + 1) // 2
                                  for k in (-(-L // 64) for L in lens))


def test_the_shipped_config_loads_and_validates():
    """The port's own configuration (``ncf_tpu_torch/configs/``: the JAX
    package has no HSTU) holds HSTU-large's widths and takes the sparse
    table update."""
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = Config.from_yaml(os.path.join(
        root, "ncf_tpu_torch", "configs", "hstu_large_retail4m.yaml"))
    cfg.validate()
    m = cfg.model
    assert (m.item_embedding_dim, m.num_blocks, m.num_heads,
            m.attention_dim, m.linear_dim, m.dropout, m.negative_samples,
            m.temperature) == (50, 8, 2, 25, 25, 0.2, 128, 0.05)
    model = get_model(m.name)
    assert model.jagged and model.table_keys == ("item_emb",)
    assert not hasattr(model, "score_candidates")
    assert sparse_mode_available(cfg)


def test_the_trainer_trains_hstu_with_evaluation_off(tmp_path, caplog):
    import logging
    import os

    from ncf_tpu_torch.data.synthetic import generate_interactions
    from ncf_tpu_torch.train.trainer import Trainer

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = Config.from_yaml(os.path.join(root, "ncf_tpu_torch", "configs",
                                        "hstu_large_retail4m.yaml"))
    cfg.apply_overrides([
        "model.max_sequence_length=64", "model.num_blocks=2",
        "model.negative_samples=16", "train.batch_size=512",
        "train.num_epochs=2", f"train.checkpoint_dir={tmp_path}",
        "train.metrics_file=", "train.log_every_steps=2"])
    inter = generate_interactions(num_users=50, num_items=500,
                                  avg_txns_per_user=20, seed=0)
    with caplog.at_level(logging.INFO):
        best = Trainer(cfg, inter, device="cpu").train()
    assert "evaluation is off" in caplog.text
    assert math.isfinite(best["loss"]) and best["epoch"] == 1
    again = Trainer(cfg, inter, device="cpu")
    assert again.resume() and again.start_epoch == 2


@pytest.mark.cuda
@pytest.mark.parametrize("lens, n", [([1, 5, 64, 65, 130, 300], 512),
                                     ([2, 63, 127, 128, 129], 256),
                                     ([8192], 8192)])
def test_the_attention_kernel_matches_its_plain_version(lens, n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, H, D = torch.device("cuda"), 2, 25
    g = torch.Generator(device=dev).manual_seed(len(lens) + n)
    off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    T = int(off[-1])
    # q, k, v as the model passes them: column slices of one wider row
    uvqk = torch.randn((T, 4 * H * D), generator=g,
                       device=dev).requires_grad_(True)
    v, q, k = (uvqk[:, c * H * D:(c + 1) * H * D].reshape(T, H, D)
               for c in (1, 2, 3))
    w_pos = (torch.randn(2 * n - 1, generator=g, device=dev) * 0.5
             ).requires_grad_(True)
    w_ts = (torch.randn(129, generator=g, device=dev) * 0.5
            ).requires_grad_(True)
    gaps = torch.randint(0, 3 * 10**6, (T,), generator=g, device=dev) * (
        torch.rand((T,), generator=g, device=dev) < 0.4)
    ts = torch.cumsum(gaps, 0) + 1_500_000_000
    leaves = [uvqk, w_pos, w_ts]
    plan = Plan(off, dev)
    out = hstu_attention(q, k, v, w_pos, w_ts, ts, plan, n)
    go = torch.randn_like(out)
    got = torch.autograd.grad(out, leaves, go)
    want_out = hstu_attention_ref(q, k, v, w_pos, w_ts, ts, off, n)
    want = torch.autograd.grad(want_out, leaves, go)
    assert _rel(out, want_out) <= 2e-4
    for a, b in zip(got, want):
        assert _rel(a, b) <= 1e-2
    again = torch.autograd.grad(
        hstu_attention(q, k, v, w_pos, w_ts, ts, plan, n), leaves, go)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
