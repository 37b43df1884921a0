"""Trainer: epoch loop, validation, early stopping, checkpoint/resume.

Port of ``ncf_tpu/train/trainer.py::Trainer``: ``train`` / ``train_epoch``
/ ``validate``, best-checkpoint tracking, early stopping on ``val_loss``
(minimised) or a ranking metric (maximised), mid-epoch, epoch and
emergency checkpoints, resume (mid-epoch re-entry included) and the
artifact push.  The per-batch work is the port's training step
(``train/step.py``), the ranking metrics come from the port's evaluators.

Where the reference threads immutable arrays and a JAX key, the port's
step updates the params and the Adam moments in place and advances a
``torch.Generator`` on the device (``self.rng``).  So the autotune probe
runs on copies of the state and a clone of the generator, ``save`` copies
every leaf to the host before the next step, and the epoch's permutation
comes from its own generator seeded per (seed, epoch): skipping the
dispatches a mid-epoch checkpoint already took draws nothing, and a
resumed run ends in the same bits as an uninterrupted one.

Under ``rowwise_adagrad`` tables in the big-vocabulary regime
(``sparse_table_update: auto`` or ``on``) the step is the sparse table
update of ``train/step.py``: the tables' touched rows take rowwise
Adagrad, the dense params the dense optimizer (built without a clip: the
step clips the whole set), ``steps_per_dispatch: 0`` means 8 and no
autotune, as in the reference.

Under a mesh (``mesh=``, ``parallel/mesh.py``; every rank of the process
group builds its own ``Trainer`` with the same config and log) the
reference's mesh branch runs SPMD: the params are initialized whole from
the seed on every rank and cut to the rank's part (tables row-sharded
over ici where their rows divide it), the optimizer state is built on
the parts, the lookups of sharded tables go through the explicit
exchange whatever ``mesh.embedding_exchange`` says (there is no XLA to
choose collectives), every rank reads the global batches of the host
pipeline and trains on its slice (``train/step.py``), the fused tower
folds the rank into its dropout seed, ``validate`` splits the eval users
over the ranks, and only the primary rank logs metrics, marks the best
checkpoint, collects old ones and pushes artifacts.  Checkpoints hold
each shard in its own file (``train/checkpoint.py``).  ``steps_per_dispatch:
0`` means 1 on the dense path under a mesh (autotune's timings could
differ between ranks, and every rank must take the same K).

A model whose batches are jagged (``jagged`` in its registry entry:
HSTU) trains on every user's history in time order, packed into
batches of ``batch_size`` target positions (``data/jagged.py``), through
the sparse table update, one step a dispatch, on one process; its step
moves each batch to the card itself (``batch_to``).  A model without
``score_candidates`` has no evaluator: evaluation is off, which the log
says, and each epoch is checkpointed with its training metrics.

The orbax checkpoint backends are not supported (orbax is a JAX
library): they raise at construction.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import time
from typing import Dict, Optional

import numpy as np
import torch

from ncf_tpu_torch.data.interactions import Interactions
from ncf_tpu_torch.data.jagged import JaggedBatches
from ncf_tpu_torch.data.pipeline import (BatchIterator, DeviceEpochPipeline,
                                         group_batches, prefetch_to_device)
from ncf_tpu_torch.data.sampler import make_sampling_cdf
from ncf_tpu_torch.evals.evaluate import (DeviceEvaluator, EvalSet,
                                          metrics_from_ranks,
                                          sample_eval_users)
from ncf_tpu_torch.evals.full_eval import (FullCatalogEvaluator,
                                           full_ranks_naive)
from ncf_tpu_torch.models import get_model
from ncf_tpu_torch.convert import tree_map
from ncf_tpu_torch.ops import embedding as embedding_ops
from ncf_tpu_torch.parallel import mesh as mesh_lib
from ncf_tpu_torch.train import checkpoint as ckpt_lib
from ncf_tpu_torch.train.optim import make_optimizer, make_schedule
from ncf_tpu_torch.train.step import (init_sparse_opt_state, make_eval_step,
                                      make_multi_train_step,
                                      make_sparse_multi_train_step,
                                      make_sparse_train_step,
                                      make_train_step, sparse_mode_available)
from ncf_tpu_torch.utils.config import Config
from ncf_tpu_torch.utils.device import DeviceLike, resolve_device
from ncf_tpu_torch.utils.logging import MetricsLogger

log = logging.getLogger(__name__)

# train.embedding_scatter -> ops.embedding.set_scatter_impl arguments
_SCATTER = {"fast": ("fast", "bf16"),
            "exact": ("auto", "split"),
            "xla": ("xla", "split")}


def _check_supported(cfg: Config, mesh) -> None:
    """Raise for what the port does not support, before any work."""
    if getattr(get_model(cfg.model.name), "jagged", False) and (
            cfg.train.sparse_table_update == "off"
            or not sparse_mode_available(cfg, mesh)):
        raise ValueError(
            f"{cfg.model.name} trains through the sparse table update on "
            "one process: embedding_optimizer rowwise_adagrad, "
            "sparse_table_update auto or on, no mesh")
    if (cfg.train.sparse_table_update == "on"
            and not sparse_mode_available(cfg, mesh)):
        raise ValueError(
            "sparse_table_update=on requires rowwise_adagrad tables, "
            "advanced_ncf in the big-vocab regime (static-table "
            "history only — causal_history is incompatible); "
            "under a mesh: shard_embeddings with table rows divisible "
            "by ici and batch divisible by the device count")
    if cfg.train.checkpoint_backend != "native":
        raise NotImplementedError(
            f"checkpoint_backend={cfg.train.checkpoint_backend!r} is not "
            "supported (orbax is a JAX library); use native")


class Trainer:
    """End-to-end training loop for one model + dataset.

    Usage::

        trainer = Trainer(cfg, interactions)          # on the card
        result = trainer.train()            # dict of best metrics

    ``device`` defaults to ``cuda``; without a card it raises unless the
    caller asks for ``"cpu"``.
    """

    def __init__(
        self,
        cfg: Config,
        interactions: Interactions,
        mesh=None,
        device: DeviceLike = None,
    ):
        cfg.validate()
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        self.model = get_model(cfg.model.name)
        self.mesh = mesh
        self.jagged = getattr(self.model, "jagged", False)
        self.evaluates = hasattr(self.model, "score_candidates")

        self.full = interactions
        cfg.model.num_users = interactions.num_users
        cfg.model.num_items = interactions.num_items
        if interactions.item_dept is not None:
            cfg.model.num_departments = interactions.num_departments
            cfg.model.num_categories = interactions.num_categories
        _check_supported(cfg, mesh)
        if self.jagged:
            self._init_jagged_data(interactions)
        else:
            self._init_data(interactions)
        if not self.evaluates:
            log.info("%s: evaluation is off (no HR@k evaluator or serving "
                     "path covers it yet); epochs are logged by their "
                     "training loss", cfg.model.name)

        # ---- params / optimizer / steps
        init_gen = torch.Generator(device=dev).manual_seed(cfg.train.seed)
        self.params = self.model.init(init_gen, cfg.model, device=dev)
        self.shardings = None
        self._exchange_rows = {}
        embedding_ops.clear_exchange()
        if mesh is not None:
            # every rank initialized the same whole params: keep its part
            self.shardings = mesh_lib.param_shardings(
                self.params, mesh, cfg.mesh.shard_embeddings)
            self._exchange_rows = {
                k: self.params[k].shape[0]
                for k, spec in self.shardings.items()
                if spec == mesh_lib.SHARDED}
            meta_params = tree_map(lambda p: torch.empty_like(
                p, device="meta"), self.params)
            self.params = mesh_lib.shard_pytree(self.params, self.shardings,
                                                mesh)
            self._register_exchange()
        mode = cfg.train.sparse_table_update
        self.sparse_tables = mode == "on" or (
            mode == "auto" and sparse_mode_available(cfg, mesh))
        steps = len(self.train_iter)
        if self.sparse_tables:
            # the dense params' optimizer: the step clips the whole set
            self.optimizer = make_optimizer(dataclasses.replace(
                cfg.train, gradient_clip_norm=0.0), steps)
            self._sparse_schedule = make_schedule(cfg.train, steps)
            self.opt_state = init_sparse_opt_state(self.optimizer,
                                                   self.params)
        else:
            self.optimizer = make_optimizer(cfg.train, steps)
            self.opt_state = self.optimizer.init(self.params)
        self._ckpt_specs = None
        if mesh is not None:
            # the checkpoint's spec tree, from the state's global shapes
            meta_state = (init_sparse_opt_state(self.optimizer, meta_params)
                          if self.sparse_tables
                          else self.optimizer.init(meta_params))
            self._ckpt_specs = {
                "params": self.shardings,
                "opt_state": mesh_lib.state_shardings(
                    self._named(meta_state), mesh,
                    cfg.mesh.shard_embeddings),
                "rng": mesh_lib.REPLICATED}
        # seeded alike on every rank: the replicated generator
        self.rng = torch.Generator(device=dev).manual_seed(cfg.train.seed + 1)

        embedding_ops.set_scatter_impl(*_SCATTER[cfg.train.embedding_scatter])

        if self.sparse_tables:
            if self.jagged and cfg.train.steps_per_dispatch != 1:
                # batches of different lengths do not stack
                log.info("jagged batches: steps_per_dispatch=1")
                cfg.train.steps_per_dispatch = 1
            elif cfg.train.steps_per_dispatch == 0:
                # the autotune probe builds the dense steps: skip it
                log.info("sparse_table_update: steps_per_dispatch=8")
                cfg.train.steps_per_dispatch = 8
            make_step = (make_sparse_multi_train_step
                         if cfg.train.steps_per_dispatch > 1
                         else make_sparse_train_step)
            self.train_step = make_step(
                self.model, cfg, self.optimizer, self._sparse_schedule,
                self.neg_cdf, self.item_dept, self.item_cat, mesh=mesh,
                user_history=self.user_history, device=dev)
        else:
            if cfg.train.steps_per_dispatch == 0 and mesh is not None:
                log.info("mesh: steps_per_dispatch=1 (every rank must "
                         "take the same K; autotune times each rank)")
                cfg.train.steps_per_dispatch = 1
            elif cfg.train.steps_per_dispatch == 0:
                cfg.train.steps_per_dispatch = self._autotune_dispatch()
            make_step = (make_multi_train_step
                         if cfg.train.steps_per_dispatch > 1
                         else make_train_step)
            self.train_step = make_step(*self._step_args(), device=dev,
                                        mesh=mesh, shardings=self.shardings)
        self.eval_step = make_eval_step(
            self.model, cfg, self.neg_cdf, self.item_dept, self.item_cat,
            self.user_history, device=dev, mesh=mesh)

        self.primary = mesh is None or mesh.rank == 0
        self.metrics_logger = MetricsLogger(
            (cfg.train.metrics_file or None) if self.primary else None)
        self.global_step = 0
        self._resume_dispatch = 0
        self.start_epoch = 0
        self.best_val = float("inf")
        self.best_metrics: Dict[str, float] = {}

    def _init_data(self, interactions: Interactions) -> None:
        """Rows of (user, item): a time split for the val loss,
        leave-one-out for ranking, the batch iterators and the step's
        constants."""
        cfg, dev, mesh = self.cfg, self.device, self.mesh
        train_inter, val_inter = interactions.time_split(
            cfg.data.validation_days)
        if len(val_inter) == 0 or len(train_inter) == 0:
            log.warning("degenerate time split; falling back to 90/10 by "
                        "time order")
            n = len(interactions)
            mask = np.arange(n) < int(n * 0.9)
            train_inter = interactions.select(mask)
            val_inter = interactions.select(~mask)
        loo_train, eval_users, eval_items = interactions.leave_one_out()
        self.train_inter = train_inter
        self.val_inter = val_inter
        eval_users, eval_items = sample_eval_users(
            eval_users, eval_items, cfg.data.eval_user_sample,
            seed=cfg.train.seed + 777)
        self.eval_set = EvalSet.build(
            interactions, eval_users, eval_items,
            num_negatives=cfg.data.num_eval_negatives, seed=cfg.train.seed)
        self._device_eval = None  # the evaluator, built on first validate

        train_extra = None
        if cfg.model.use_sequence and cfg.model.causal_history:
            train_extra = {"history": train_inter.causal_history(
                cfg.model.history_len)}
        self.train_iter = BatchIterator(
            train_inter, cfg.train.batch_size, seed=cfg.train.seed,
            extra_cols=train_extra)
        self.val_iter = BatchIterator(
            val_inter, cfg.train.batch_size, seed=cfg.train.seed,
            shuffle=False)

        # device-resident epochs: the columns go to the device once and
        # each epoch is built there
        # (a mesh keeps the host pipeline: every rank reads the global
        # batches and trains on its slice)
        self.device_pipeline = None
        if mesh is None and cfg.train.input_pipeline in ("auto", "device"):
            pipe = DeviceEpochPipeline(
                train_inter, cfg.train.batch_size, seed=cfg.train.seed,
                extra_cols=train_extra, device=dev)
            if (cfg.train.input_pipeline == "device"
                    or pipe.epoch_bytes() <= cfg.train.device_epoch_max_bytes):
                self.device_pipeline = pipe
            else:
                log.info(
                    "input_pipeline=auto: epoch (%d MB) exceeds "
                    "device_epoch_max_bytes; using the host pipeline",
                    pipe.epoch_bytes() >> 20)

        # ---- constants (item metadata and histories stay NumPy; each
        # step and evaluator moves its own copy to the device once)
        w = train_inter.inverse_popularity_weights()
        self.neg_cdf = make_sampling_cdf(w, device=dev)
        self.item_dept = (np.asarray(interactions.item_dept)
                          if interactions.item_dept is not None else None)
        self.item_cat = (np.asarray(interactions.item_cat)
                         if interactions.item_cat is not None else None)
        self.user_history = None
        self.eval_history = None
        if cfg.model.use_sequence:
            H = cfg.model.history_len
            self.user_history = train_inter.recent_history(H)
            self.eval_history = loo_train.recent_history(H)

    def _init_jagged_data(self, interactions: Interactions) -> None:
        """Every user's history, packed into batches of ``batch_size``
        target positions; no held-out split and no step constants."""
        cfg = self.cfg
        self.train_iter = JaggedBatches(
            interactions, cfg.train.batch_size,
            cfg.model.max_sequence_length, seed=cfg.train.seed)
        self.device_pipeline = None
        self.neg_cdf = self.item_dept = self.item_cat = None
        self.user_history = self.eval_history = None

    def _step_args(self):
        return (self.model, self.cfg, self.optimizer, self.neg_cdf,
                self.item_dept, self.item_cat, self.user_history)

    def _autotune_dispatch(self) -> int:
        """Measure dispatch overhead on a real-shaped probe batch and pick
        steps_per_dispatch (train/autotune.py); training state untouched."""
        from ncf_tpu_torch.train.autotune import choose_steps_per_dispatch

        dev = self.device
        probe = {k: torch.as_tensor(v).to(dev)
                 for k, v in next(iter(self.train_iter.epoch(0))).items()}

        def stack_batch(batch, k):
            return {key: torch.stack([v] * k) for key, v in batch.items()}

        args = self._step_args()
        return choose_steps_per_dispatch(
            make_single=lambda: make_train_step(*args, device=dev),
            make_multi=lambda: make_multi_train_step(*args, device=dev),
            params=self.params, opt_state=self.opt_state, rng=self.rng,
            probe_batch=probe, stack_batch=stack_batch)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------ training

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        """One epoch over the train split.  The step's metrics stay on the
        device and are read only at log windows."""
        cfg = self.cfg
        totals: Dict[str, float] = {}
        n_batches = 0
        t_epoch = time.perf_counter()
        t_window = t_epoch
        spd = cfg.train.steps_per_dispatch
        # mid-epoch resume: the epoch's batches are deterministic per
        # (seed, epoch), so continuing is "skip the dispatches already
        # taken" with the restored params, moments and generator
        skip = self._resume_dispatch
        self._resume_dispatch = 0
        if self.device_pipeline is not None:
            it = self.device_pipeline.epoch(epoch, steps_per_dispatch=spd)
            if skip:
                it = itertools.islice(it, skip, None)
        else:
            it = self.train_iter.epoch(epoch)
            if spd > 1:
                it = group_batches(it, spd)
            if skip:  # before prefetch: skipped groups are never copied
                it = itertools.islice(it, skip, None)
            if not self.jagged:   # a jagged step moves its own batch
                it = prefetch_to_device(it, device=self.device)
        dispatch = skip
        every = cfg.train.checkpoint_every_dispatches
        for batch in it:
            k = next(iter(batch.values())).shape[0] if spd > 1 else 1
            self.params, self.opt_state, self.rng, metrics = self.train_step(
                self.params, self.opt_state, self.rng, batch)
            n_batches += k
            prev_window = self.global_step // cfg.train.log_every_steps
            self.global_step += k
            dispatch += 1
            if every > 0 and dispatch % every == 0:
                self.save_checkpoint(
                    epoch, {"mid_epoch": 1.0},
                    extra={"dispatch": dispatch, "in_epoch": True})
            if self.global_step // cfg.train.log_every_steps != prev_window:
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t_window
                t_window = time.perf_counter()
                eps = (cfg.train.log_every_steps * cfg.train.batch_size
                       / max(dt, 1e-9))
                log.info(
                    "epoch %d step %d loss=%.4f acc=%.3f pos=%.3f neg=%.3f "
                    "examples/s=%.0f",
                    epoch, self.global_step, metrics["loss"],
                    metrics["accuracy"], metrics["pos_accuracy"],
                    metrics["neg_accuracy"], eps)
                self.metrics_logger.write(
                    kind="train", epoch=epoch, step=self.global_step,
                    examples_per_s=eps, **metrics)
                for k, v in metrics.items():
                    totals[k] = totals.get(k, 0.0) + v
        self._sync()                 # device work done before the clock
        epoch_s = time.perf_counter() - t_epoch
        n_logged = max(1, n_batches // max(1, cfg.train.log_every_steps))
        out = {k: v / n_logged for k, v in totals.items()}
        out["epoch_seconds"] = epoch_s
        out["examples_per_s"] = (n_batches * cfg.train.batch_size
                                 / max(epoch_s, 1e-9))
        return out

    def validate(self, epoch: int) -> Dict[str, float]:
        """Validation loss on the held-out time window, then the
        leave-one-out ranking metrics.  The negatives of the val loss come
        from a generator made afresh from ``seed + 12345`` on every call,
        so ``val_loss`` compares across epochs."""
        self._register_exchange()
        totals: Dict[str, torch.Tensor] = {}
        n = 0
        gen = torch.Generator(device=self.device).manual_seed(
            self.cfg.train.seed + 12345)
        for batch in prefetch_to_device(self.val_iter.epoch(0),
                                        device=self.device):
            gen, metrics = self.eval_step(self.params, gen, batch)
            for k, v in metrics.items():
                totals[k] = totals[k] + v if k in totals else v
            n += 1
        out = {f"val_{k}": float(v) / max(1, n) for k, v in totals.items()}

        if self._device_eval is None:
            if self.cfg.data.eval_protocol == "full":
                self._device_eval = self._build_full_evaluator()
            else:
                self._device_eval = DeviceEvaluator(
                    self.model, self.cfg.model, self.eval_set,
                    batch_size=self.cfg.data.eval_batch_size,
                    item_dept=self.item_dept, item_cat=self.item_cat,
                    user_history=self.eval_history, device=self.device,
                    mesh=self.mesh)
        out.update(self._device_eval(self.params))
        self.metrics_logger.write(kind="val", epoch=epoch,
                                  step=self.global_step, **out)
        return out

    def _build_full_evaluator(self):
        """The exact full-catalog evaluator (``data.eval_protocol:
        full``): the blocked pass for AdvancedNCF, whole-catalog scoring
        through ``full_ranks_naive`` for the other models."""
        eval_users = np.asarray(self.eval_set.users)
        eval_items = np.asarray(self.eval_set.candidates[:, 0])
        if self.cfg.model.name == "advanced_ncf":
            return FullCatalogEvaluator(
                self.cfg.model, self.full, eval_users, eval_items,
                user_history=self.eval_history,
                item_dept=self.item_dept, item_cat=self.item_cat,
                user_block=self.cfg.data.full_eval_user_block,
                item_block=self.cfg.data.full_eval_item_block,
                device=self.device, mesh=self.mesh,
                shardings=self.shardings)

        model, cfg_m, full = self.model, self.cfg.model, self.full
        hist, dept, cat = self.eval_history, self.item_dept, self.item_cat
        dev = self.device
        mesh, specs = self.mesh, self.shardings

        def _naive_eval(params, ks=(1, 5, 10)):
            if mesh is not None:
                params = mesh_lib.gather_pytree(params, specs, mesh)
            ranks = full_ranks_naive(
                model, params, cfg_m, full, eval_users, eval_items,
                user_history=hist, item_dept=dept, item_cat=cat, device=dev)
            out = metrics_from_ranks(ranks, ks)
            out["eval_protocol_full"] = 1.0
            return out

        return _naive_eval

    def train(self, num_epochs: Optional[int] = None) -> Dict[str, float]:
        """The loop with early stopping and best, periodic and emergency
        checkpoints; returns the best epoch's validation metrics."""
        cfg = self.cfg
        num_epochs = num_epochs or cfg.train.num_epochs
        patience = cfg.train.early_stopping_patience
        metric = cfg.train.early_stopping_metric
        # val_loss is minimised; ranking metrics (hr@k, ndcg@k, mrr@k,
        # map@k) are maximised
        maximize = metric != "val_loss"
        bad_epochs = 0
        self._register_exchange()
        try:
            for epoch in range(self.start_epoch, num_epochs):
                train_m = self.train_epoch(epoch)
                log.info("epoch %d done in %.1fs (%.0f examples/s)",
                         epoch, train_m["epoch_seconds"],
                         train_m["examples_per_s"])
                if not self.evaluates:
                    self.save_checkpoint(epoch, train_m)
                    self.best_metrics = {**train_m, "epoch": epoch}
                elif (epoch + 1) % cfg.train.eval_every_epochs == 0:
                    val_m = self.validate(epoch)
                    log.info(
                        "epoch %d val_loss=%.4f hr@10=%.4f ndcg@10=%.4f",
                        epoch, val_m["val_loss"], val_m["hr@10"],
                        val_m["ndcg@10"])
                    ckpt_dir = self.save_checkpoint(epoch, val_m)
                    score = val_m[metric]
                    if maximize:
                        improved = score > -self.best_val
                    else:
                        improved = score < self.best_val
                    if improved:
                        # stored negated for maximised metrics, so that a
                        # smaller best_val is always better
                        self.best_val = -score if maximize else score
                        self.best_metrics = {**val_m, "epoch": epoch}
                        if self.primary:
                            ckpt_lib.mark_best(cfg.train.checkpoint_dir,
                                               ckpt_dir)
                        bad_epochs = 0
                    else:
                        bad_epochs += 1
                        if bad_epochs >= patience:
                            log.info("early stopping at epoch %d "
                                     "(patience %d)", epoch, patience)
                            break
        except KeyboardInterrupt:
            raise
        except Exception:
            if self.mesh is not None and self.mesh.size > 1:
                # the other ranks may be inside a collective: a save
                # (which waits for every rank) could not finish
                log.exception("training failed on rank %d",
                              self.mesh.rank)
                raise
            log.exception("training failed; writing emergency checkpoint")
            self.save_checkpoint(epoch=-1, metrics={"emergency": 1.0})
            raise
        finally:
            ckpt_lib.wait_for_pending()
            # the routing table is process-wide: serving in this process
            # must not route through the training mesh
            embedding_ops.clear_exchange()
        if cfg.train.artifact_store and self.primary:
            from ncf_tpu_torch.utils.artifacts import push_training_artifacts

            job = cfg.train.job_name or f"run-{cfg.train.seed}"
            try:
                push_training_artifacts(
                    cfg.train.artifact_store, job,
                    checkpoint_dir=cfg.train.checkpoint_dir,
                    metrics_file=cfg.train.metrics_file or None)
            except Exception:
                log.exception("artifact push failed (training result kept)")
        return self.best_metrics or {"val_loss": self.best_val}

    # ---------------------------------------------------------- checkpoints

    def _named(self, state):
        t = self.cfg.train
        return ckpt_lib.named_opt_state(
            state, t.gradient_clip_norm, t.weight_decay,
            t.embedding_weight_decay, t.embedding_learning_rate)

    def _named_opt_state(self):
        return self._named(self.opt_state)

    def _register_exchange(self) -> None:
        """(Re)register this Trainer's exchange in the process-wide
        routing table (``ops/embedding.py``)."""
        if self._exchange_rows:
            embedding_ops.set_exchange(
                self.mesh, self._exchange_rows,
                self.cfg.mesh.exchange_capacity_factor)
            log.info("all-to-all embedding exchange on for %s",
                     sorted(self._exchange_rows))

    def _state(self):
        # the step's generator is part of the trajectory (negatives and
        # dropout): saving it is what makes mid-epoch resume bit for bit
        return {"params": self.params, "opt_state": self._named_opt_state(),
                "rng": self.rng.get_state()}

    def save_checkpoint(self, epoch: int, metrics: Dict[str, float],
                        extra: Optional[Dict] = None) -> str:
        path = ckpt_lib.save(
            self.cfg.train.checkpoint_dir, self._state(),
            step=self.global_step, epoch=epoch,
            metrics={k: v for k, v in metrics.items()
                     if isinstance(v, (int, float))},
            config=self.cfg.to_dict(), extra=extra, mesh=self.mesh,
            shardings=self._ckpt_specs)
        # mid-epoch saves collect only other mid-epoch checkpoints, so
        # they never cycle the epoch-boundary ones out
        if self.primary:
            ckpt_lib.garbage_collect(
                self.cfg.train.checkpoint_dir,
                self.cfg.train.keep_checkpoints,
                in_epoch_only=bool((extra or {}).get("in_epoch")))
        return path

    def resume(self, ckpt_dir: Optional[str] = None) -> bool:
        """Restore the latest (or given) checkpoint; True if resumed.
        Mid-epoch checkpoints (``extra.in_epoch``) re-enter their epoch at
        the recorded dispatch."""
        ckpt_dir = ckpt_dir or ckpt_lib.find_latest(
            self.cfg.train.checkpoint_dir)
        if ckpt_dir is None:
            return False
        try:
            state, manifest = ckpt_lib.restore(
                ckpt_dir, self._state(), device=self.device, mesh=self.mesh,
                shardings=self._ckpt_specs)
            self.rng.set_state(state["rng"].cpu())
        except Exception as err:    # noqa: BLE001 — see the fallback
            # no rng leaf, or another package's key (the JAX package saves
            # a uint32 key, the port a generator state): restore the rest
            # and keep this run's fresh generator
            specs = self._ckpt_specs
            try:
                state, manifest = ckpt_lib.restore(
                    ckpt_dir, {"params": self.params,
                               "opt_state": self._named_opt_state()},
                    device=self.device, mesh=self.mesh,
                    shardings=None if specs is None else {
                        "params": specs["params"],
                        "opt_state": specs["opt_state"]})
            except Exception:
                raise err
            log.warning("checkpoint has no rng key; resumed run will not "
                        "be bit-identical to an uninterrupted one")
        self.params = state["params"]
        self.opt_state = ckpt_lib.opt_state_from_named(state["opt_state"])
        self.global_step = manifest["step"]
        extra = manifest.get("extra") or {}
        if extra.get("in_epoch"):
            self.start_epoch = manifest["epoch"]
            self._resume_dispatch = int(extra["dispatch"])
        else:
            self.start_epoch = manifest["epoch"] + 1
        saved_cfg = manifest.get("config", {})
        if saved_cfg and saved_cfg.get("model") != self.cfg.to_dict().get(
                "model"):
            log.warning("checkpoint model config differs from current config")
        log.info("resumed from %s (epoch %d, step %d)",
                 ckpt_dir, manifest["epoch"], self.global_step)
        return True
