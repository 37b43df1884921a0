"""Dataclass configuration system with YAML load + CLI overrides.

The port's own copy of ``ncf_tpu/utils/config.py`` (same dataclasses,
same keys, so every ``configs/*.yaml`` loads unchanged).  It is kept as a
copy because the port imports nothing of the JAX package.  The one
difference is ``Config.build_mesh``: the port's mesh is one of ranks of
the ``torch.distributed`` process group (``parallel/mesh.py``), so
``mesh.enable: auto`` builds one when the group has several ranks where
the reference counts devices.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

try:  # pyyaml is available in the image; gate anyway.
    import yaml
except ImportError:  # pragma: no cover
    yaml = None


@dataclass
class ModelConfig:
    """AdvancedNCF hyperparameters (reference: src/model/architecture.py:121-133)."""

    name: str = "advanced_ncf"  # one of: ncf | neumf | advanced_ncf
    num_users: int = 8031
    num_items: int = 366
    num_departments: int = 9
    num_categories: int = 30
    mf_dim: int = 64
    mlp_dim: int = 64
    temporal_dim: int = 32
    mlp_hidden_dims: List[int] = field(default_factory=lambda: [256, 128, 64])
    num_heads: int = 4
    dropout: float = 0.2
    negative_samples: int = 4
    # TPU-first additions (not in reference):
    compute_dtype: str = "bfloat16"  # activations dtype for matmul paths
    param_dtype: str = "float32"
    use_temporal: bool = True   # reference zeroes temporal in main fwd (bug §2.9.6); we train it
    use_category: bool = True   # reference never wires CategoryHierarchy into fwd; we do
    # sequence path: the reference instantiates sequence_attention and
    # builds 50-item histories (architecture.py:210-214,
    # training_data.py:72-81) but never calls them; here it is a working
    # optional path (attention over the user's recent items)
    use_sequence: bool = False
    history_len: int = 50       # reference LIMIT 50 (features.py:74)
    # rematerialize the MLP tower in backward (jax.checkpoint): trades
    # a second tower forward for not round-tripping its activations
    # through HBM — measured A/B in BENCH_NOTES round 4 (rejected: +9%)
    remat_tower: bool = False
    # fused Pallas MLP tower (ops/pallas_tower.py): whole
    # Linear->ReLU->LN->Dropout stack in one kernel per direction,
    # recompute backward, on-core PRNG dropout.  Measured -6.2% step
    # (joint) / -34% (independent), convergence-neutral (BENCH_NOTES
    # round 4).  "auto" (default) = on TPU with bf16 activations when
    # the shape fits; under a mesh the Trainer routes the kernel through
    # jax.shard_map over the batch axes (param grads psum'd) since a
    # bare pallas_call does not partition under pjit.  "on" forces
    # (errors off-TPU); "interpret" = CI-only Pallas interpret mode;
    # "off" = XLA layers.
    fused_tower: str = "auto"
    causal_history: bool = False  # strictly-causal per-example train
    #                               contexts ([N, H] host table) instead of
    #                               the static per-user table (which leaks
    #                               post-example items, like the reference)
    # candidate scoring mode during TRAINING:
    #   "joint"       — reference semantics (architecture.py:315-323):
    #                   attention pools over the (1+neg) slot group, so
    #                   the MLP path is identical across slots and only
    #                   the MF path ranks candidates;
    #   "independent" — eval-consistent per-candidate scoring (the MLP
    #                   path learns to rank; no train/eval semantics gap)
    candidate_mode: str = "joint"
    # HSTU (``name: hstu``, models/hstu.py; Zhai et al., ICML 2024): the
    # item embedding width d, the blocks, the widths of a head's query
    # and key (attention_dim) and of its value (linear_dim), the longest
    # history N (the positions table and the relative bias), and the
    # sampled softmax's temperature; num_heads, dropout and
    # negative_samples are shared with the fields above
    item_embedding_dim: int = 50
    num_blocks: int = 8
    attention_dim: int = 25
    linear_dim: int = 25
    max_sequence_length: int = 200
    temperature: float = 0.05


@dataclass
class DataConfig:
    """Dataset selection + splits (reference: src/model/data_prep.py:13-110)."""

    dataset: str = "synthetic"          # synthetic | movielens | parquet
    path: str = ""                      # movielens dir or parquet file
    validation_days: int = 10           # time-based split (data_prep.py:77-88)
    num_eval_negatives: int = 100       # leave-one-out eval candidates (fixes §2.9.9)
    eval_user_sample: int = 0           # >0: seeded sample of this many eval
    #                                     users for the ranking metrics (the
    #                                     full population is hours/epoch at
    #                                     the 100M-entity regime); 0 = all
    eval_batch_size: int = 2048         # user block per eval scan step
    # leave-one-out protocol: "sampled" ranks the positive against
    # num_eval_negatives sampled items (the reference's intended
    # protocol); "full" ranks it EXACTLY against the whole catalog minus
    # the user's history (evals/full_eval.py — unbiased; sampled
    # leave-one-out can re-order models, Krichene & Rendle KDD'20)
    eval_protocol: str = "sampled"
    full_eval_user_block: int = 512     # users per block (full protocol)
    full_eval_item_block: int = 2048    # catalog slice per scan step
    min_user_interactions: int = 2
    # synthetic generator scale (reference datagen defaults, scripts/1.*/02*)
    synthetic_users: int = 8031
    synthetic_items: int = 366
    synthetic_days: int = 90
    synthetic_seed: int = 0
    synthetic_avg_txns_per_user: int = 12


@dataclass
class TrainConfig:
    """Training loop settings (reference: config/config.yaml:62-75, trainer.py:27-95)."""

    batch_size: int = 256
    steps_per_dispatch: int = 1         # >1: lax.scan K optimizer steps per
    #                                     device call (amortizes dispatch);
    #                                     0 = measure overhead and autotune
    #                                     (train/autotune.py)
    loss: str = "bce"                   # bce | bpr (north-star training losses)
    learning_rate: float = 1e-3
    weight_decay: float = 1e-5
    embedding_optimizer: str = "adam"   # adam (2 f32 moments per element —
    #                                     3x table HBM) | rowwise_adagrad
    #                                     (fbgemm ROWWISE_ADAGRAD: one f32
    #                                     scalar per ROW — ~1.03x, max
    #                                     vocab) | partial_rowwise_adam
    #                                     (fbgemm PARTIAL_ROWWISE_ADAM:
    #                                     per-element momentum + rowwise
    #                                     2nd moment — 2x, Adam-class
    #                                     quality) | bf16_adam (both Adam
    #                                     moments bf16 — 2x; measured
    #                                     -0.04 HR@10 at ML-1M scale, see
    #                                     results/embopt_parity.jsonl).
    #                                     Dense params always get full
    #                                     Adam.  See train/optim.py.
    sparse_table_update: str = "auto"   # auto | on | off — update ONLY
    #                                     the rows a batch touches
    #                                     (train/sparse.py, the fbgemm
    #                                     fused-sparse-optimizer path):
    #                                     per-step HBM traffic O(batch)
    #                                     instead of O(vocab).  auto =
    #                                     on when step.sparse_mode_available
    #                                     (rowwise_adagrad + AdvancedNCF
    #                                     big-vocab regime, single chip).
    #                                     Table weight decay becomes
    #                                     decay-on-touch (fbgemm
    #                                     semantics).
    embedding_weight_decay: float = 0.0  # L2 on the TABLES under the
    #                                      memory-efficient optimizers
    #                                      (they default to fbgemm's
    #                                      no-table-decay; the full-Adam
    #                                      baseline decays tables via
    #                                      weight_decay, so set this to
    #                                      weight_decay for an exact
    #                                      regularization match)
    embedding_adagrad_eps: float = 1e-8  # rowwise-Adagrad denominator
    #                                      eps.  LARGE values (1e-2)
    #                                      change early dynamics: update
    #                                      ~ g/eps (SGD-like) until the
    #                                      accumulator grows past eps^2,
    #                                      avoiding the full-LR first
    #                                      step of the normalized form
    embedding_adagrad_init: float = 0.0  # rowwise-Adagrad initial
    #                                      accumulator: >0 damps the
    #                                      first updates (with 0 the
    #                                      first step moves every row by
    #                                      exactly the embedding LR —
    #                                      measured to spike HR early
    #                                      then dip, results/embopt_parity)
    embedding_learning_rate: float = 0.0  # table LR when it should differ
    #                                       from learning_rate (torchrec
    #                                       exposes per-table LRs the same
    #                                       way; Adagrad-family typically
    #                                       wants ~10x Adam's). 0 = inherit
    #                                       learning_rate.
    num_epochs: int = 50
    early_stopping_patience: int = 5
    early_stopping_metric: str = "val_loss"  # val_loss (min) or any ranking
    #                                          metric to maximize, e.g. hr@10:
    #                                          on the convergence runs hr@10
    #                                          kept improving ~8 epochs after
    #                                          val_loss bottomed
    gradient_clip_norm: float = 5.0
    lr_schedule: str = "constant"       # constant | cosine
    warmup_steps: int = 0
    negative_sampling: str = "iid"      # iid (reference semantics: per-slot
    #                                     independent draws + masked redraw)
    #                                     | stratified (pooled sorted order
    #                                     statistics, strided assignment —
    #                                     exact batch-level distribution,
    #                                     ~2x faster embedding-grad scatter;
    #                                     sampler.sample_negatives_stratified)
    embedding_scatter: str = "fast"     # fast (Pallas bf16 grads, TPU-only,
    #                                     convergence-validated) | exact
    #                                     (Pallas split for small tables
    #                                     only) | xla
    input_pipeline: str = "auto"        # auto (device-resident epochs when
    #                                     single-device and the epoch fits
    #                                     device_epoch_max_bytes; host
    #                                     BatchIterator otherwise) |
    #                                     device | host
    device_epoch_max_bytes: int = 2 << 30
    seed: int = 0
    eval_every_epochs: int = 1
    checkpoint_dir: str = "checkpoints"
    checkpoint_backend: str = "native"  # native | orbax | orbax_async
    checkpoint_every_dispatches: int = 0  # >0: also save every N device
    #                                       dispatches WITHIN an epoch
    #                                       (with the device PRNG key +
    #                                       dispatch index, so resume()
    #                                       continues mid-epoch
    #                                       bit-for-bit); 0 = epoch
    #                                       boundaries only.  The 100M
    #                                       regime's epochs are tens of
    #                                       minutes — reference only had
    #                                       per-epoch + emergency saves
    #                                       (trainer.py:493-546).
    keep_checkpoints: int = 3
    log_every_steps: int = 100
    metrics_file: str = ""              # JSONL metrics sink ("" = disabled)
    artifact_store: str = ""            # push best ckpt + metrics after
    #                                     training (reference GCS upload,
    #                                     train.py:71-107): file:// or
    #                                     bare dir; "" = off.  See
    #                                     utils/artifacts.py.
    job_name: str = ""                  # artifact prefix; "" = run-<seed>


@dataclass
class MeshConfig:
    """Device mesh / sharding (TPU-native; no reference equivalent —
    replaces torchrec DistributedModelParallel, trainer.py:85-88)."""

    # build a mesh in the single-process entrypoints (cli train,
    # scripts/train_bigvocab.py): 'off' = single-device, 'auto' = mesh
    # when >1 device is visible, 'on' = require a mesh (fail if the
    # (dcn, ici) shape doesn't fit the visible devices).  Multi-process
    # launches (scripts/launch_multiprocess.py) build their own mesh.
    enable: str = "off"
    dcn_axis: int = 1                   # hosts (data-parallel over DCN)
    ici_axis: int = -1                  # chips per host; -1 = all local devices
    shard_embeddings: bool = True       # row-shard tables over 'ici'
    # 'pjit': XLA chooses the lookup collectives from the NamedShardings.
    # 'explicit': route every sharded-table gather through the all-to-all
    # id/vector exchange (parallel.embedding_sharding.exchange_lookup) —
    # the integrated torchrec-DMP schedule (reference trainer.py:85-88).
    embedding_exchange: str = "pjit"
    # bucket capacity for the explicit exchange; <= 0 = exact (skew-proof,
    # required with the default sorted-batch pipeline)
    exchange_capacity_factor: float = 0.0


@dataclass
class ServingConfig:
    """Serving path (reference: config/config.yaml:161-187, src/inference/)."""

    top_k: int = 10
    candidate_batch: int = 4096         # item block size for streaming top-k
    user_batch: int = 256
    cache_feature_ttl_s: int = 3600     # cache.py:86-87
    cache_embedding_ttl_s: int = 86400
    host: str = "127.0.0.1"
    port: int = 8080
    model_version: str = "0.1.0"
    # optional redis backend for the feature/embedding cache
    # (reference: config/redis.yaml + cache.py:68); "" = in-process
    # TTL store only.  Every redis op falls back per-call on
    # connection errors (serving/cache.py).
    redis_url: str = ""
    # request coalescing: concurrent single-user /recommendations calls
    # micro-batch into shared device dispatches (the retrieval kernel is
    # batched; a [64, d] query block costs barely more than [1, d]) —
    # serving/server.py::_Coalescer
    coalesce_requests: bool = True
    coalesce_max_batch: int = 64
    coalesce_dispatchers: int = 4   # parallel dispatcher threads keep
    #                                 several coalesced batches in flight
    #                                 (pipelines the per-dispatch round
    #                                 trip; one dispatcher measured slower
    #                                 than direct threading)
    # streaming-kernel recall/speed preset: 'exact' (recall 1.0),
    # 'fast' (recall ~0.9998, ~1.7x retrieval QPS), 'int8' (recall
    # ~0.993, exact rescored scores, ~1.45x), or 'int8-fast' (recall
    # ~0.966, dequantized scores, ~2.7x) — see
    # serving.scorer.AdvancedNCFScorer
    retrieval: str = "exact"
    # use_sequence models: stage-1 over-fetch width for the two-stage
    # retrieve+rescore scorer (serving.scorer.SequenceRescoreScorer);
    # k + candidates <= 64 keeps stage 1 on the streaming kernel
    seq_rescore_candidates: int = 54


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    serving: ServingConfig = field(default_factory=ServingConfig)

    # ------------------------------------------------------------------ I/O

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        cfg = cls()
        for section_name, section_val in (d or {}).items():
            if not hasattr(cfg, section_name):
                logging.warning("config: unknown section %r ignored", section_name)
                continue
            section = getattr(cfg, section_name)
            if not dataclasses.is_dataclass(section):
                setattr(cfg, section_name, section_val)
                continue
            for k, v in (section_val or {}).items():
                if not hasattr(section, k):
                    logging.warning("config: unknown key %s.%s ignored", section_name, k)
                    continue
                setattr(section, k, v)
        return cfg

    @classmethod
    def from_yaml(cls, path: str) -> "Config":
        if yaml is None:  # pragma: no cover
            raise RuntimeError("pyyaml not available")
        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f) or {})

    def save_yaml(self, path: str) -> None:
        if yaml is None:  # pragma: no cover
            raise RuntimeError("pyyaml not available")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)

    # ------------------------------------------------------------- overrides

    def apply_overrides(self, overrides: Sequence[str]) -> "Config":
        """Apply ``section.key=value`` CLI overrides in place.

        Values are parsed with YAML rules so ``train.learning_rate=3e-4``,
        ``model.mlp_hidden_dims=[128,64]`` and ``mesh.shard_embeddings=false``
        all do the right thing.
        """
        for ov in overrides:
            if "=" not in ov:
                raise ValueError(f"override {ov!r} is not of the form path=value")
            path, raw = ov.split("=", 1)
            value = yaml.safe_load(raw) if yaml is not None else raw
            if isinstance(value, str):
                # YAML 1.1 misses floats like "3e-4" (no dot); coerce
                try:
                    value = float(value)
                except ValueError:
                    pass
            parts = path.split(".")
            obj: Any = self
            for p in parts[:-1]:
                if not hasattr(obj, p):
                    raise ValueError(f"unknown config path {path!r}")
                obj = getattr(obj, p)
            if not hasattr(obj, parts[-1]):
                raise ValueError(f"unknown config key {path!r}")
            setattr(obj, parts[-1], value)
        return self

    # ------------------------------------------------------------ validation

    def validate(self) -> "Config":
        """Fail fast on inconsistent settings (reference: trainer.py:33-52
        validates required keys at trainer construction; we validate types
        and invariants up front)."""
        m, t = self.model, self.train
        if m.mlp_dim % m.num_heads != 0:
            raise ValueError(
                f"mlp_dim ({m.mlp_dim}) must be divisible by num_heads ({m.num_heads})")
        if m.num_users <= 0 or m.num_items <= 0:
            raise ValueError("num_users and num_items must be positive")
        if t.batch_size <= 0 or t.learning_rate <= 0:
            raise ValueError("batch_size and learning_rate must be positive")
        if m.negative_samples < 1:
            raise ValueError("negative_samples must be >= 1")
        if t.embedding_optimizer not in (
                "adam", "rowwise_adagrad", "bf16_adam",
                "partial_rowwise_adam"):
            raise ValueError(
                f"train.embedding_optimizer must be adam | rowwise_adagrad "
                f"| bf16_adam | partial_rowwise_adam, "
                f"got {t.embedding_optimizer!r}")
        if t.sparse_table_update not in ("auto", "on", "off"):
            raise ValueError(
                f"train.sparse_table_update must be auto | on | off, "
                f"got {t.sparse_table_update!r}")
        if self.data.eval_protocol not in ("sampled", "full"):
            raise ValueError(
                f"data.eval_protocol must be sampled | full, "
                f"got {self.data.eval_protocol!r}")
        if self.mesh.embedding_exchange not in ("pjit", "explicit"):
            raise ValueError(
                f"mesh.embedding_exchange must be 'pjit' or 'explicit', "
                f"got {self.mesh.embedding_exchange!r}")
        if isinstance(self.mesh.enable, bool):
            # YAML 1.1 coerces bare on/off to booleans (both in config
            # files and dotted overrides); map them back
            self.mesh.enable = "on" if self.mesh.enable else "off"
        if self.mesh.enable not in ("off", "auto", "on"):
            raise ValueError(
                f"mesh.enable must be off | auto | on, "
                f"got {self.mesh.enable!r}")
        return self

    def build_mesh(self):
        """The configured mesh over the process group's ranks, or None
        (``mesh.enable``: ``off`` none, ``auto`` when several ranks run,
        ``on`` always, ``(1, 1)`` for one process)."""
        if isinstance(self.mesh.enable, bool):    # YAML on/off coercion
            self.mesh.enable = "on" if self.mesh.enable else "off"
        if self.mesh.enable == "off":
            return None
        from ncf_tpu_torch.parallel import make_mesh, multihost

        if self.mesh.enable == "auto" and multihost.process_count() <= 1:
            return None
        return make_mesh(dcn=self.mesh.dcn_axis, ici=self.mesh.ici_axis)


def setup_logging(level: str = "INFO", log_file: Optional[str] = None) -> None:
    """Console (+ optional file) logging, reference: src/utils/config.py:65-80."""
    handlers: List[logging.Handler] = [logging.StreamHandler()]
    if log_file:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        handlers.append(logging.FileHandler(log_file))
    logging.basicConfig(
        level=getattr(logging, level.upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        handlers=handlers,
        force=True,
    )
