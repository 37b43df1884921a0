"""Host batch iterator: shuffled, fixed-size int32 batches.

Port of ``ncf_tpu/data/pipeline.py::BatchIterator`` (NumPy only).  It
shuffles with the port's copy of the native library when that builds,
exactly as the JAX package does with its own, so both packages yield the
same batches from the same seed.  Batches are NumPy; the training step
moves them to its device.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from ncf_tpu_torch import native
from ncf_tpu_torch.data.interactions import Interactions
from ncf_tpu_torch.data.synthetic import temporal_features

Batch = Dict[str, np.ndarray]


class BatchIterator:
    """Shuffled, fixed-size batches over an interaction log.

    Every batch has exactly ``batch_size`` rows; the last batch is padded
    by repeating indices from the start of the shuffled order.
    ``sort_by_user`` (default on) orders each batch's rows by user id, which
    keeps each chunk of the user-table gradient scatter on few rows.
    """

    def __init__(
        self,
        interactions: Interactions,
        batch_size: int,
        seed: int = 0,
        shuffle: bool = True,
        drop_remainder: bool = False,
        extra_cols: Dict[str, np.ndarray] = None,
        sort_by_user: bool = True,
    ):
        self.inter = interactions
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.sort_by_user = sort_by_user
        self.drop_remainder = drop_remainder
        self._seed = int(seed)
        hour, day, month, doy = temporal_features(interactions.timestamps)
        self._cols: Batch = {
            "user_ids": interactions.user_ids,
            "item_ids": interactions.item_ids,
            "hour": hour,
            "day": day,
            "month": month,
            "day_of_year": doy,
        }
        for k, v in (extra_cols or {}).items():
            if len(v) != len(interactions):
                raise ValueError(
                    f"extra col {k!r} has {len(v)} rows, expected "
                    f"{len(interactions)}")
            self._cols[k] = v
        n = len(interactions)
        if drop_remainder:
            self.num_batches = n // self.batch_size
        else:
            self.num_batches = max(1, -(-n // self.batch_size))

    def __len__(self) -> int:
        return self.num_batches

    def epoch(self, epoch_idx: int = 0) -> Iterator[Batch]:
        n = len(self.inter)
        idx = np.arange(n)
        if self.shuffle:
            seed = (self._seed * 1_000_003 + epoch_idx + 1) & 0x7FFFFFFF
            if native.available():
                idx = native.shuffled_indices(n, seed)
            else:
                idx = np.random.default_rng(seed).permutation(n)
        B = self.batch_size
        total = self.num_batches * B
        mat = np.resize(idx, total).reshape(self.num_batches, B)
        if self.sort_by_user:
            users = self._cols["user_ids"][mat]
            order = np.argsort(users, axis=1, kind="stable")
            mat = np.take_along_axis(mat, order, axis=1)
        flat = {k: v[mat] for k, v in self._cols.items() if v.ndim == 1}
        wide = {k: v for k, v in self._cols.items() if v.ndim > 1}
        for b in range(self.num_batches):
            out = {k: v[b] for k, v in flat.items()}
            for k, v in wide.items():
                out[k] = v[mat[b]]
            yield out
