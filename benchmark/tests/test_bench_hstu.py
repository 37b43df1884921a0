"""The HSTU cell's yardstick, traffic, reference and limits, on the CPU.

- the rooflines', ``mfu.train_hstu``'s and ``hstu.useful_pair_share``'s
  counts at a tiny shape worked out by hand;
- the traffic generator: the same seed gives the same batches, and every
  batch trains exactly the mix's target positions;
- ``reference/hstu.py`` loads no JAX and nothing of the port;
- at a small size, the port agrees with the reference, and the control
  and each planted fault fail the cell's limits.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import run, spec
from benchmark.counts import hstu as counts_hstu
from benchmark.metrics import readers
from benchmark.traffic import jagged

CELL = "hstu-train-jagged-t262144"
SMALL = {"model": {"num_items": 1000, "max_sequence_length": 64,
                   "num_blocks": 2, "negative_samples": 8},
         "traffic": {"target_positions": 300, "min_len": 8, "max_len": 64,
                     "pool_batches": 3, "check_steps": 2}}
SEED = 2 ** 31 + 23

# two histories of 4 and 6 positions: 10 + 21 causal pairs
SHAPES = {"positions": 10, "sequences": 2, "pairs": 31, "heads": 2,
          "attention_dim": 25, "linear_dim": 25, "max_len": 8,
          "item_dim": 50, "blocks": 8, "targets": 8, "negatives": 128}


def _metric(name):
    cell = spec.load_cell(CELL)
    return readers.reader_of(next(m for m in cell.per_layer
                                  if m.name == name))


class _Slice:
    def __init__(self, ops, calls=1):
        self.ops, self.calls = ops, calls

    def device_s(self, names):
        return sum(e - s for n, s, e in self.ops
                   if any(k in n for k in names)) / 1e6


def test_the_attention_counts_by_hand():
    # forward: 31 pairs x 2 heads x 2 x (25 + 25); Q, K, V and O in bf16
    # (10 x 2 x 75 x 2 + 10 x 2 x 25 x 2), 13 int64 offsets and
    # timestamps, w_pos (15) and w_ts (129) in f32
    assert counts_hstu.attn_fwd(SHAPES) == (3000 + 1000 + 104 + 576, 6200.0)
    # backward: the scores again and four products, 2 (3 x 25 + 2 x 25)
    # a pair and head; Q, K, V, dO in and dQ, dK, dV out in bf16, the
    # tables read and their gradients written
    assert counts_hstu.attn_bwd(SHAPES) == (4000 + 3000 + 104 + 1152,
                                            15500.0)
    # W_uvqk (50 x 200) and W_o (50 x 50) over 10 positions
    assert counts_hstu.linear_flops(SHAPES) == 250000.0
    # 3 x (8 blocks x (6,200 + 250,000) + 8 targets x 129 x 2 x 50)
    assert counts_hstu.train_step_flops(SHAPES) == 6458400.0


def test_the_rooflines_read_the_kernels_they_name():
    fwd = _metric("hstu_attn_fwd_roofline")
    bwd = _metric("hstu_attn_bwd_roofline")
    ops = [("void hstu_attn_fwd_kernel(Args, float*)", 0.0, 10.0),
           ("void hstu_attn_bwd_dkdv_kernel(Args, float*, float*)", 10, 30),
           ("void hstu_attn_bwd_dq_kernel(Args)", 30, 50),
           ("void hstu_bias_reduce_kernel<1>(int const*)", 50, 60),
           ("elementwise_kernel", 60, 100)]
    ctx = {"shapes": dict(SHAPES),
           "launches": {"hstu_attn_fwd": 8, "hstu_attn_bwd": 8}}
    nbytes, flops = counts_hstu.attn_fwd(SHAPES)
    bound = 8 * max(nbytes / 3.35e12, flops / 989e12)
    assert fwd(_Slice(ops), ctx) == pytest.approx(100.0 * bound / 10e-6)
    nbytes, flops = counts_hstu.attn_bwd(SHAPES)
    bound = 8 * max(nbytes / 3.35e12, flops / 989e12)
    assert bwd(_Slice(ops), ctx) == pytest.approx(100.0 * bound / 50e-6)
    # a launch count other than a block's one, or no batches recorded
    assert fwd(_Slice(ops), {**ctx, "launches": {"hstu_attn_fwd": 7}}) \
        is None
    assert bwd(_Slice(ops), {**ctx, "shapes": {}}) is None


def test_the_step_peak_share_and_the_pair_share():
    mfu = _metric("mfu.train_hstu")
    ctx = {"shapes": dict(SHAPES), "window_call_s": 1e-3, "launches": {}}
    assert mfu(None, ctx) == pytest.approx(
        100.0 * 6458400.0 / 1e-3 / 989e12)
    share = _metric("hstu.useful_pair_share")
    assert share(None, {"launches": {}}) is None
    got = share(None, {"launches": {"hstu_pairs_useful": 62,
                                    "hstu_pairs_computed": 2 * 2 * 4096}})
    assert got == pytest.approx(100.0 * 62 / 16384)


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5, 3922000011])
def test_every_batch_trains_exactly_the_budget(seed):
    with open(os.path.join(spec.HERE, "traffic",
                           "train-hstu-t262144.json")) as f:
        mix = json.load(f)
    gen = torch.Generator().manual_seed(seed)
    for _ in range(3):
        lens = jagged.lengths(mix, gen)
        assert int((lens - 1).sum()) == mix["target_positions"] == 262144
        assert lens[-1] >= 2
        assert lens[:-1].min() >= 512 and lens.max() <= 8192
        assert 60 <= lens.size <= 140


def test_each_set_of_length_draws_takes_every_stratum_once():
    fractions = jagged._fractions(torch.Generator().manual_seed(SEED))
    for _ in range(4):
        got = [next(fractions) for _ in range(jagged.STRATA)]
        assert all(0.0 <= u < 1.0 for u in got)
        assert sorted(int(u * jagged.STRATA) for u in got) == list(
            range(jagged.STRATA))


def test_the_same_seed_gives_the_same_batches():
    mix = dict(spec.load_cell(CELL).traffic, **SMALL["traffic"])
    a = jagged.hstu_batches(mix, 1000, SEED, "cpu")
    b = jagged.hstu_batches(mix, 1000, SEED, "cpu")
    c = jagged.hstu_batches(mix, 1000, SEED + 1, "cpu")
    for x, y in zip(a, b):
        assert np.array_equal(x["offsets"], y["offsets"])
        assert torch.equal(x["item_ids"], y["item_ids"])
        assert torch.equal(x["timestamps"], y["timestamps"])
    assert not all(torch.equal(x["item_ids"], y["item_ids"])
                   for x, y in zip(a, c))
    for x in a:
        off = x["offsets"]
        assert int(off[-1]) - (off.size - 1) == 300
        ts = x["timestamps"]
        for s in range(off.size - 1):
            seq = ts[off[s]:off[s + 1]]
            assert bool((seq[1:] >= seq[:-1]).all())
            # baskets of at most 8 items share a timestamp
            runs = torch.unique_consecutive(seq, return_counts=True)[1]
            assert int(runs.max()) <= 8


def test_the_reference_loads_nothing_of_the_port():
    code = ("import json, sys; sys.path.insert(0, %r); "
            "import benchmark.reference.hstu, benchmark.hstu_weights, "
            "benchmark.traffic.jagged, benchmark.counts.hstu; "
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))" % spec.ROOT)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "torch" in top
    assert not {"ncf_tpu_torch", "ncf_tpu", "jax", "jaxlib"} & top


def test_the_port_agrees_with_the_reference():
    result = run.run_cell(spec.load_cell(CELL), SEED, 0.3, False, "cpu",
                          SMALL)
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"loss_gap", "grad_gap", "change_gap",
                                     "table_gap", "bias_gap"}


def test_the_control_and_every_fault_fail():
    from benchmark.drivers import train_hstu

    with open(os.path.join(spec.HERE, "reference", "limits",
                           CELL + ".json")) as f:
        limits = json.load(f)
    readings = train_hstu.Driver(spec.load_cell(CELL), SEED, "cpu",
                                 SMALL).control()
    assert set(readings) == {"control", "no_rab", "softmax", "mask_shift",
                             "half_batch", "tables_frozen", "rows_shifted"}
    for name, got in readings.items():
        assert any(got[k] > limits[k] for k in limits), (name, got)
