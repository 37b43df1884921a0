"""Port parity for the data modules: ``generate_interactions``,
``temporal_features`` and ``BatchIterator`` give identical arrays in both
packages from the same seed, and the port's copy of the native loader
agrees with the JAX package's.  All comparisons are exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

from ncf_tpu import native as jnative  # noqa: E402
from ncf_tpu.data.pipeline import BatchIterator as JBatchIterator  # noqa: E402
from ncf_tpu.data.synthetic import generate_interactions as jgen  # noqa: E402
from ncf_tpu.data.synthetic import temporal_features as jtemporal  # noqa: E402
from ncf_tpu_torch import native as tnative  # noqa: E402
from ncf_tpu_torch.data import BatchIterator, generate_interactions  # noqa: E402
from ncf_tpu_torch.data import temporal_features  # noqa: E402

FIELDS = ("user_ids", "item_ids", "timestamps", "amounts", "item_dept",
          "item_cat")


@pytest.fixture(scope="module")
def logs():
    kw = dict(num_users=150, num_items=70, num_days=40, avg_txns_per_user=9,
              seed=11)
    return jgen(**kw), generate_interactions(**kw)


def test_generate_interactions_is_identical(logs):
    j, t = logs
    assert len(j) == len(t) > 0
    for f in FIELDS:
        a, b = getattr(j, f, None), getattr(t, f, None)
        if a is None:
            assert b is None
            continue
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for got, want in zip(temporal_features(t.timestamps),
                         jtemporal(j.timestamps)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("batch,sort,drop", [(64, True, False),
                                             (100, False, False),
                                             (128, True, True)])
def test_batch_iterator_epochs_are_identical(logs, batch, sort, drop):
    j, t = logs
    # both packages shuffle natively when their loader builds, else NumPy
    assert tnative.available() == jnative.available()
    jit = JBatchIterator(j, batch, seed=3, sort_by_user=sort,
                         drop_remainder=drop)
    tit = BatchIterator(t, batch, seed=3, sort_by_user=sort,
                        drop_remainder=drop)
    assert len(jit) == len(tit)
    for epoch in (0, 1):
        jb, tb = list(jit.epoch(epoch)), list(tit.epoch(epoch))
        assert len(jb) == len(tb) == len(jit)
        for a, b in zip(jb, tb):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


def test_native_loader_copy_matches(logs):
    j, _ = logs
    np.testing.assert_array_equal(tnative.shuffled_indices(1000, 5),
                                  jnative.shuffled_indices(1000, 5))
    for a, b in zip(tnative.build_histories(j.user_ids, j.item_ids, 150),
                    jnative.build_histories(j.user_ids, j.item_ids, 150)):
        np.testing.assert_array_equal(a, b)
