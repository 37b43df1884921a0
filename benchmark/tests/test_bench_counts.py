"""The yardstick's operation and byte counts at hand-worked shapes."""

import pytest

from benchmark import counts
from benchmark.metrics import b2_roofline, b4b_roofline, b5_roofline

RETRIEVE = {"users_per_call": 64, "num_items": 4_000_000, "mf_dim": 64,
            "k": 10, "fetch": 10}
ML1M = {"batch": 262_144, "slots": 5, "num_users": 6040,
        "num_items": 3706, "mf_dim": 64, "mlp_dim": 64, "temporal_dim": 32,
        "hidden": [256, 128, 64], "num_departments": 9,
        "num_categories": 30, "sparse": False, "joint": True,
        "precompute": True}
SPARSE = dict(ML1M, batch=131_072, num_users=12_000_000,
              num_items=4_000_000, sparse=True, precompute=False)


def test_b5_reads_the_table_once_and_is_bound_by_bytes():
    nbytes, flops, peak = b5_roofline.call(RETRIEVE)
    # table 4M x 64 f32, bias 4M f32, queries 64 x 64 f32, 64 x 10 x 8 out
    assert nbytes == 1_024_000_000 + 16_000_000 + 16_384 + 5_120
    assert flops == 2 * 64 * 4_000_000 * 64 == counts.retrieve_flops(
        RETRIEVE)
    assert peak == "tf32"
    assert b5_roofline.bound_s(RETRIEVE) == pytest.approx(
        1_040_021_504 / 3.35e12)


def test_the_tower_s_work():
    # 96 -> 256 -> 128 -> 64
    assert counts.tower_macs(ML1M) == 96 * 256 + 256 * 128 + 128 * 64 \
        == 65_536
    assert counts.tower_rows(ML1M) == 262_144
    assert counts.tower_rows(dict(ML1M, joint=False)) == 5 * 262_144


def test_b4b_counts_the_recompute_and_both_backward_products():
    nbytes, flops, peak = b4b_roofline.step(ML1M)
    n = 262_144
    assert flops == 6 * n * 65_536
    params = (96 * 256 + 3 * 256) + (256 * 128 + 3 * 128) + (128 * 64
                                                             + 3 * 64)
    assert nbytes == n * 96 * 2 + n * 64 * 4 + n * 96 * 2 + 2 * params * 4
    assert peak == "bfloat16"
    # bound by the products: 1.03e11 / 989e12 s against 1.68e8 / 3.35e12
    assert b4b_roofline.bound_s(ML1M) == pytest.approx(
        6 * n * 65_536 / 989e12)


def test_b2_counts_seven_launches_a_step_in_both_branches():
    dense = b2_roofline.step_launches(ML1M)
    sparse = b2_roofline.step_launches(SPARSE)
    assert len(dense) == len(sparse) == 7
    item = dense[1]
    assert (item["ids"], item["d"], item["rows"]) == (5 * 262_144, 128,
                                                      3706)
    # the combine of the item occurrences: two int64 ids a position
    assert sparse[1]["ids"] == sparse[1]["rows"] == 5 * 131_072
    assert sparse[1]["id_bytes"] == 16
    nbytes = 5 * 262_144 * (4 + 128 * 2) + 3706 * 128 * 4
    assert b2_roofline.bound_s(dict(ML1M, hidden=[1])) > nbytes / 3.35e12


def test_the_step_s_useful_flops_by_hand():
    sh = dict(ML1M, batch=2, num_items=3, mf_dim=1, mlp_dim=1,
              temporal_dim=1, hidden=[1])
    # hierarchy 3 items x 2 projections, q and o over 2 rows, k and v over
    # 10 slots, the tower 2 x (2 x 1), the heads 10 + 2 + 10 x 2
    macs = 3 * 2 + 2 * 2 + 10 * 2 + 2 * 2 + 10 + 2 + 20
    assert counts.train_step_flops(sh) == 3 * 2 * macs
    per_occ = dict(sh, precompute=False)
    assert counts.train_step_flops(per_occ) == 3 * 2 * (macs - 6 + 20)


@pytest.mark.parametrize("launches,want", [(1, 50.0), (2, None)])
def test_a_roofline_reads_only_the_route_its_bound_counts(launches, want):
    """Half a call's device time at the bound reads 50%; a launch count
    other than the bound assumes reads nothing."""
    from benchmark.metrics import readers
    from benchmark.trace import Slice

    t = b5_roofline.bound_s(RETRIEVE)
    slc = Slice(calls=2, wall_s=1.0,
                ops=[("seg_topk_tc_kernel", 0.0, 2 * t * 1e6),
                     ("merge_topk_kernel", 0.0, 2 * t * 1e6),
                     ("other", 0.0, 5.0)])
    ctx = {"shapes": RETRIEVE,
           "launches": {b5_roofline.LAUNCH_COUNTER: launches}}
    got = b5_roofline.read(slc, ctx)
    assert got == (None if want is None else pytest.approx(want))
    assert readers.roofline(slc, ctx, ("absent",), t, "x", 1) is None
