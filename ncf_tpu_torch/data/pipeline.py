"""Input pipelines: shuffled, fixed-size int32 batches.

Port of ``ncf_tpu/data/pipeline.py``.  ``BatchIterator`` (NumPy only)
shuffles with the port's copy of the native library when that builds,
exactly as the JAX package does with its own, so both packages yield the
same batches from the same seed.  Its batches are NumPy, which
``prefetch_to_device`` copies ahead to the device (``group_batches``
stacks them for a K-step dispatch).  ``DeviceEpochPipeline`` keeps the
columns on the device and builds each epoch's batches there.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterator

import numpy as np
import torch

from ncf_tpu_torch import native
from ncf_tpu_torch.data.interactions import Interactions
from ncf_tpu_torch.data.synthetic import temporal_features
from ncf_tpu_torch.utils.device import DeviceLike, resolve_device
from ncf_tpu_torch.utils.profiling import annotate

Batch = Dict[str, np.ndarray]


def _columns(interactions: Interactions, extra_cols) -> Batch:
    """The batch columns of a log: ids, temporal features and any extra
    per-row columns (e.g. causal histories)."""
    hour, day, month, doy = temporal_features(interactions.timestamps)
    cols: Batch = {
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
        cols[k] = v
    return cols


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
        self._cols = _columns(interactions, extra_cols)
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
            seed = epoch_key(self._seed, epoch_idx)
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


def epoch_key(seed: int, epoch_idx: int) -> int:
    """The per-epoch shuffle seed both packages use (the JAX package keys
    ``jax.random.PRNGKey`` with it, the port seeds a ``torch.Generator``)."""
    return (int(seed) * 1_000_003 + int(epoch_idx) + 1) & 0x7FFFFFFF


class DeviceEpochPipeline:
    """Device-resident input pipeline: the interaction columns are put on
    the device once, and each epoch's shuffled, padded, user-sorted batch
    matrix is built there.

    Per epoch: a permutation from a ``torch.Generator`` on the device
    seeded with ``epoch_key(seed, epoch)``, repeated to a whole number of
    batches (the last batch padded from the start of the order), each
    batch's rows stably sorted by user id, then every column taken.  The
    permutation cannot match the JAX package's (another generator), but
    ``build_from_permutation`` is the rest of the build, so a test can
    feed it the reference's own permutation.  Epoch matrices live in
    device memory ([num_batches, B] a column): gate with ``epoch_bytes()``.
    """

    def __init__(
        self,
        interactions: Interactions,
        batch_size: int,
        seed: int = 0,
        shuffle: bool = True,
        sort_by_user: bool = True,
        extra_cols: Dict[str, np.ndarray] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.batch_size = int(batch_size)
        self._seed = int(seed)
        self._shuffle = shuffle
        self._sort_by_user = sort_by_user
        self._n = len(interactions)
        self.num_batches = max(1, -(-self._n // self.batch_size))

        def put(v):
            v = np.asarray(v)
            if v.dtype == np.int64:       # int32 ids, as the reference keeps
                v = v.astype(np.int32)
            return torch.from_numpy(np.ascontiguousarray(v)).to(self.device)

        self._dev_cols = {k: put(v) for k, v in
                          _columns(interactions, extra_cols).items()}

    def __len__(self) -> int:
        return self.num_batches

    def epoch_bytes(self) -> int:
        """Device footprint of one epoch's materialized batch matrices."""
        total = self.num_batches * self.batch_size
        return sum(total * int(np.prod(v.shape[1:], dtype=np.int64))
                   * v.element_size() for v in self._dev_cols.values())

    def permutation(self, epoch_idx: int = 0) -> torch.Tensor:
        """The epoch's row order (int64 on the device)."""
        if not self._shuffle:
            return torch.arange(self._n, device=self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(epoch_key(self._seed, epoch_idx))
        return torch.randperm(self._n, generator=gen, device=self.device)

    def build_from_permutation(self, perm) -> Dict[str, torch.Tensor]:
        """[num_batches, B] columns from a row order of the log."""
        if not isinstance(perm, torch.Tensor):
            perm = torch.from_numpy(np.array(perm, np.int64))
        perm = perm.to(self.device).long()
        nb, B = self.num_batches, self.batch_size
        total = nb * B
        reps = -(-total // self._n)
        idx = perm.repeat(reps)[:total].reshape(nb, B)
        if self._sort_by_user:
            users = self._dev_cols["user_ids"][idx]
            order = torch.argsort(users, dim=1, stable=True)
            idx = torch.gather(idx, 1, order)
        return {k: v[idx] for k, v in self._dev_cols.items()}

    def epoch(self, epoch_idx: int = 0,
              steps_per_dispatch: int = 1) -> Iterator[Dict[str, torch.Tensor]]:
        """Yield device-resident batches: [B] columns when
        ``steps_per_dispatch == 1``, stacked [K, B] groups otherwise
        (a ragged final group at its own size, like ``group_batches``).
        The build is the span ``pipeline.epoch`` while a profiler
        records."""
        with annotate("pipeline.epoch"):
            arrays = self.build_from_permutation(
                self.permutation(epoch_idx))
        nb, K = self.num_batches, int(steps_per_dispatch)
        if K <= 1:
            for i in range(nb):
                yield {k: v[i] for k, v in arrays.items()}
        else:
            for i in range(0, nb, K):
                yield {k: v[i:i + K] for k, v in arrays.items()}


def prefetch_to_device(iterator: Iterator[Batch], size: int = 2,
                       device: DeviceLike = None) -> Iterator:
    """Overlap host-to-device copies with compute: keep ``size`` batches
    in flight, each column copied from pinned memory with
    ``non_blocking=True`` when the device is a card.  (The reference's
    ``sharding=`` placement comes with the parallel layer.)"""
    dev = resolve_device(device)
    pin = dev.type == "cuda"

    def put(v):
        t = torch.as_tensor(np.asarray(v))
        if pin:
            t = t.pin_memory()
        return t.to(dev, non_blocking=True)

    queue = collections.deque()
    for batch in iterator:
        queue.append({k: put(v) for k, v in batch.items()})
        if len(queue) >= size:
            yield queue.popleft()
    while queue:
        yield queue.popleft()


def group_batches(iterator: Iterator[Batch], k: int) -> Iterator[Batch]:
    """Stack ``k`` consecutive host batches into [k, B] arrays for a
    multi-step dispatch (``train.step.make_multi_train_step``).  A ragged
    final group is stacked at its own leading size."""
    buf: list = []

    def flush():
        return {key: np.stack([b[key] for b in buf]) for key in buf[0]}

    for b in iterator:
        buf.append(b)
        if len(buf) == k:
            yield flush()
            buf = []
    if buf:
        yield flush()
