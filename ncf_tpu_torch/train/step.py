"""Training and validation steps.

Port of the dense half of ``ncf_tpu/train/step.py``: ``bce_loss``,
``bpr_loss``, ``make_loss``, ``make_train_step``,
``make_multi_train_step`` and ``make_eval_step``, with the reference's
call contract.  A step samples the negatives on the device (kernel B1),
runs ``apply`` in training mode (the table gradients go through the
scatter kernel B2, the temporal sum through B3, and under the default
``fused_tower: auto`` a bf16 tower on the card through B4f/B4b), clips, decays and takes
the Adam step (``train/optim.py``), and returns the batch's loss and
accuracy stats as device scalars.

Where the reference passes a JAX key and splits it, a step here takes a
``torch.Generator`` on the step's device and draws from it in order: the
negatives, then the dropout masks.  ``negatives`` (int ``[B, NEG]``)
replaces the draw, so a test can hand the port the reference's own
negatives.  Sequence models (``use_sequence``) take each example's
history from the batch (``"history"``, the causal per-example prefixes)
or else from the ``user_history`` table with the positive masked out,
as the reference does (``step.py:92-107``).  PyTorch runs eagerly, so there is no jit or donation: the
params and the Adam moments are updated in place and returned.

The sparse-table builders (``step.py:199-458``, one device): under
``rowwise_adagrad`` tables in the big-vocabulary regime
(``sparse_mode_available``) the step gathers the batch's table rows
outside the loss, injects them into ``apply`` (autograd then reaches the
rows and the dense params, never the tables), combines the duplicate
rows, clips over the dense gradients and the combined totals together,
and updates the touched rows with rowwise Adagrad (``train/sparse.py``)
and the dense params with the dense optimizer.  The history's rows are
more touched rows of the item table, as in the reference.

Every step here runs over a mesh (``mesh=``, ``parallel/mesh.py``; given
none, the ``(1, 1)`` mesh of this process, ``local_mesh``), takes the
GLOBAL batch, as the reference's jitted step takes a global array laid
out over the devices, and runs SPMD on every rank:

- the negatives are drawn for the whole batch from the generator, which
  every rank seeds alike (the reference replicates its key), and each
  rank keeps its contiguous slice of the rows, dcn-major: the stratified
  sampler's pool is the global one, so an N-rank step draws what the
  one-rank step draws;
- ``apply`` runs on the rank's rows (given ``mesh``, it picks the
  vocabulary branch the whole batch would and keeps the rank's rows of
  each dropout mask drawn for the whole batch), the lookups of
  row-sharded tables going through the exchange
  (``ops/embedding.py::set_exchange``);
- each rank's loss is scaled by ``local_B / global_B``, so the gradients
  summed over the ranks are those of the global mean: replicated leaves
  are summed over every rank, a table shard's over its dcn replicas
  (``shardings`` says which leaf is which);
- the clip's norm is the replicated leaves' plus the shards' summed
  over ici (``norm_fn``);
- the sparse step routes its row gradients to their owners
  (``train/sparse_sharded.py``);
- the metrics are the global batch's (one ``all_reduce``).

On the ``(1, 1)`` mesh every slice is the whole batch, the scale is 1 and
no collective runs, so the one-process step is this same code.

While a profiler records, a training step is the span ``step`` and its
phases are spans under it (``utils/profiling.py``): ``step.inputs`` (the
batch to the device, the negatives' draw, and the sparse step's row
gathers), ``step.forward`` (the loss), ``step.backward`` (autograd),
``step.reduce`` (the gradients' all-reduce, under a process group only),
``step.optimizer`` (the dense update), ``step.sparse_update`` (the
touched-row combine and rowwise Adagrad) and ``step.metrics``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ncf_tpu_torch.convert import tree_leaves, tree_map
from ncf_tpu_torch.data.sampler import (sample_negatives,
                                        sample_negatives_stratified)
from ncf_tpu_torch.evals.metrics import accuracy_stats
from ncf_tpu_torch.parallel.mesh import (DCN_AXIS, ICI_AXIS, SHARDED,
                                         WORLD, local_mesh, local_rows)
from ncf_tpu_torch.parallel.embedding_sharding import exchange_gather
from ncf_tpu_torch.train.optim import Adam, global_norm
from ncf_tpu_torch.train.sparse_sharded import (
    sharded_sparse_rowwise_adagrad_update)
from ncf_tpu_torch.utils.config import Config
from ncf_tpu_torch.utils.device import DeviceLike, resolve_device
from ncf_tpu_torch.utils.profiling import annotate

_TEMPORAL = ("hour", "day", "month", "day_of_year")


def bce_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Sigmoid BCE with logits, averaged."""
    return F.binary_cross_entropy_with_logits(logits, targets)


def bpr_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """-log sigmoid(pos - neg) over each row's (positive, negative) pairs;
    column 0 is the positive."""
    del targets
    return F.softplus(-(logits[:, :1] - logits[:, 1:])).mean()


def make_loss(name: str):
    if name == "bce":
        return bce_loss
    if name == "bpr":
        return bpr_loss
    raise ValueError(f"unknown loss {name!r}; use 'bce' or 'bpr'")


def _consts(dev, neg_cdf, item_dept, item_cat,
            user_history=None) -> Dict[str, torch.Tensor]:
    """The step's read-only device tensors."""
    out = {}
    for name, v in (("neg_cdf", neg_cdf), ("item_dept", item_dept),
                    ("item_cat", item_cat), ("user_history", user_history)):
        if v is not None:
            t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
                np.array(v))
            out[name] = t.to(dev)
    return out


def _batch_to(batch: Dict[str, Any], dev) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(dev, non_blocking=True)
            for k, v in batch.items()}


def _targets(B: int, S: int, dev) -> torch.Tensor:
    t = torch.zeros((B, S), dtype=torch.float32, device=dev)
    t[:, 0] = 1.0
    return t


def _make_loss_fn(model, cfg: Config, training: bool = True):
    """The step's loss; validation (``training=False``) draws iid
    negatives and runs ``apply`` without dropout, as the reference's
    ``make_eval_step`` does.  ``loss_fn.inputs`` draws a batch's
    candidates, temporal fields and history on its own; the sparse step
    takes them first and hands them back as ``drawn`` with its injected
    rows."""
    mcfg = cfg.model
    S = 1 + mcfg.negative_samples
    loss_impl = make_loss(cfg.train.loss)
    joint = mcfg.candidate_mode == "joint"
    sample = (sample_negatives_stratified
              if training and cfg.train.negative_sampling == "stratified"
              else sample_negatives)

    def inputs(batch, gen, consts, negatives=None):
        pos = batch["item_ids"]
        if negatives is None:
            negs = sample(gen, pos, mcfg.num_items, mcfg.negative_samples,
                          cdf=consts.get("neg_cdf"))
        else:
            negs = torch.as_tensor(negatives).to(pos.device)
        items = torch.cat([pos[:, None], negs.to(pos.dtype)], dim=1)
        temporal = {k: batch[k] for k in _TEMPORAL if k in batch} or None
        history = None
        if training and "history" in batch:
            # causal per-example prefixes: the positive is never in its
            # own prefix by construction
            history = batch["history"]
        elif "user_history" in consts:
            # the static per-user table, each positive masked out of its
            # own context
            history = consts["user_history"][batch["user_ids"].long()]
            history = torch.where(history == pos[:, None].to(history.dtype),
                                  torch.full_like(history, -1), history)
        return items, temporal, history

    def loss_fn(params, batch, gen, consts, negatives=None, drawn=None,
                **rows):
        items, temporal, history = drawn or inputs(batch, gen, consts,
                                                   negatives)
        logits = model.apply(
            params, mcfg, batch["user_ids"], items, temporal,
            consts.get("item_dept"), consts.get("item_cat"),
            candidate_attention=joint, deterministic=not training, rng=gen,
            history=history, **rows)
        targets = _targets(items.shape[0], S, items.device)
        return loss_impl(logits, targets), logits, targets

    loss_fn.inputs = inputs
    return loss_fn


def _track(tree: Any):
    """(leaves that require grad, the tree rebuilt on them)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(tree)]
    it = iter(leaves)
    return leaves, tree_map(lambda _: next(it), tree)


def _grads(loss_fn, params, *args, rows=None, scale=1.0, **kw):
    """(loss, logits, targets) and the gradient of every param leaf, in
    ``tree_leaves`` order (zeros where the loss does not reach a leaf,
    as ``jax.grad`` gives), then of each of ``rows`` (``apply``'s
    injected rows, by name; ``params`` then holds no table they stand
    in for).  The gradients are those of ``scale * loss``."""
    leaves, tracked = _track(params)
    rows = {k: r.detach().requires_grad_(True) for k, r in (rows or {}).items()}
    with torch.enable_grad():
        with annotate("step.forward"):
            loss, logits, targets = loss_fn(tracked, *args, **kw, **rows)
        with annotate("step.backward"):
            grads = torch.autograd.grad(
                loss if scale == 1.0 else loss * scale,
                leaves + list(rows.values()), allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(leaves, grads)] + list(
                         grads[len(leaves):])
    return loss.detach(), logits.detach(), targets, grads


class _MeshPlan:
    """What a step needs of the mesh (``local_mesh()`` when None): which
    leaves are table shards, the batch slicing, the loss scale and the
    reductions."""

    def __init__(self, mesh=None, shardings=None):
        self.mesh = mesh = local_mesh() if mesh is None else mesh
        self.world = mesh.size
        self.sharded = ([s == SHARDED for s in tree_leaves(shardings)]
                        if shardings is not None else None)

    def slice_batch(self, batch, drawn):
        """This rank's rows of the global batch and of its draws."""
        B = batch["item_ids"].shape[0]
        if B % self.world:
            raise ValueError(f"global batch {B} must divide the "
                             f"{self.world} ranks of the mesh")
        local = lambda x: None if x is None else local_rows(x, self.mesh)
        items, temporal, history = drawn
        return ({k: local(v) for k, v in batch.items()},
                (local(items),
                 None if temporal is None
                 else {k: local(v) for k, v in temporal.items()},
                 local(history)))

    @property
    def scale(self) -> float:
        return 1.0 / self.world

    def _is_sharded(self, i: int) -> bool:
        return self.sharded is not None and self.sharded[i]

    @torch.no_grad()
    def reduce_grads(self, grads):
        """Each leaf's gradient summed over the ranks that hold it: the
        replicated ones over the world (one flat buffer), the shards over
        their dcn replicas.  Outside a process group they are whole."""
        if not self.mesh.distributed:
            return grads
        with annotate("step.reduce"):
            rep = [i for i in range(len(grads)) if not self._is_sharded(i)]
            if rep:
                flat = torch.cat([grads[i].reshape(-1).to(torch.float32)
                                  for i in rep])
                flat = self.mesh.all_reduce(flat, WORLD)
                off = 0
                for i in rep:
                    n = grads[i].numel()
                    grads[i] = flat[off:off + n].view(grads[i].shape).to(
                        grads[i].dtype)
                    off += n
            for i in range(len(grads)):
                if self._is_sharded(i):
                    grads[i] = self.mesh.all_reduce(grads[i], DCN_AXIS)
            return grads

    def norm_fn(self):
        """The clip's global norm, or None where no leaf is a shard (then
        the optimizer's own, the same as without a mesh)."""
        if self.sharded is None or not any(self.sharded):
            return None

        def norm(grads):
            rep = [g for i, g in enumerate(grads) if not self.sharded[i]]
            shd = [g for i, g in enumerate(grads) if self.sharded[i]]
            sq = global_norm(shd).square()
            sq = self.mesh.all_reduce(sq, ICI_AXIS)
            if rep:
                sq = sq + global_norm(rep).square()
            return sq.sqrt()

        return norm

    @torch.no_grad()
    def metrics(self, loss, logits, targets):
        """The global batch's loss and accuracy stats."""
        local = {"loss": loss, **accuracy_stats(logits, targets)}
        keys = list(local)
        v = torch.stack([local[k].to(torch.float32) for k in keys])
        if self.world > 1:
            v = v * self.scale
        v = self.mesh.all_reduce(v, WORLD)
        return {k: v[i] for i, k in enumerate(keys)}


def make_train_step(
    model,
    cfg: Config,
    optimizer: Adam,
    neg_cdf=None,                  # [num_items] sampling CDF
    item_dept=None,
    item_cat=None,
    user_history=None,             # int [U, H] padded with -1
    device: DeviceLike = None,
    mesh=None,
    shardings=None,
) -> Callable:
    """Returns ``train_step(params, opt_state, gen, batch, negatives=None)
    -> (params, opt_state, gen, metrics)``.

    ``batch``: {user_ids [B], item_ids [B] (positives), hour, day, month,
    day_of_year, and for sequence models optionally history [B, H]},
    NumPy arrays or tensors; they move to the step's device
    (``cuda`` unless ``device`` says otherwise).  ``gen`` is a
    ``torch.Generator`` on that device.  ``metrics``: loss, accuracy,
    pos_accuracy and neg_accuracy as device scalars.

    ``mesh``: the step runs SPMD over it (module docstring); ``batch``
    and ``negatives`` are the global batch's, ``params`` and
    ``opt_state`` this rank's parts, ``shardings`` the params' spec tree
    (``parallel/mesh.py::param_shardings``; None: all replicated)."""
    dev = resolve_device(device)
    loss_fn = _make_loss_fn(model, cfg)
    consts = _consts(dev, neg_cdf, item_dept, item_cat, user_history)
    plan = _MeshPlan(mesh, shardings)

    def train_step(params, opt_state, gen, batch, negatives=None):
        with annotate("step"):
            with annotate("step.inputs"):
                batch = _batch_to(batch, dev)
                drawn = loss_fn.inputs(batch, gen, consts, negatives)
                lbatch, ldrawn = plan.slice_batch(batch, drawn)
            loss, logits, targets, grads = _grads(
                loss_fn, params, lbatch, gen, consts, None, ldrawn,
                scale=plan.scale, mesh=plan.mesh)
            grads = plan.reduce_grads(grads)
            with annotate("step.optimizer"):
                opt_state = optimizer.update(params, grads, opt_state,
                                             norm_fn=plan.norm_fn())
            with annotate("step.metrics"):
                metrics = plan.metrics(loss, logits, targets)
            return params, opt_state, gen, metrics

    return train_step


def _multi(step: Callable) -> Callable:
    """K calls of ``step`` per call, each entry of ``batches`` stacked
    ``[K, B]`` (``negatives``, if given, ``[K, B, NEG]``); the metrics
    are the means over the K steps."""
    def multi_train_step(params, opt_state, gen, batches, negatives=None):
        K = len(next(iter(batches.values())))
        per = []
        for i in range(K):
            negs = None if negatives is None else negatives[i]
            params, opt_state, gen, m = step(
                params, opt_state, gen, {k: v[i] for k, v in batches.items()},
                negs)
            per.append(m)
        metrics = {k: torch.stack([m[k] for m in per]).mean() for k in per[0]}
        return params, opt_state, gen, metrics

    return multi_train_step


def make_multi_train_step(
    model,
    cfg: Config,
    optimizer: Adam,
    neg_cdf=None,
    item_dept=None,
    item_cat=None,
    user_history=None,
    device: DeviceLike = None,
    mesh=None,
    shardings=None,
) -> Callable:
    """K steps per call: ``multi_train_step(params, opt_state, gen,
    batches, negatives=None)`` where every entry of ``batches`` is stacked
    ``[K, B]`` (and ``negatives``, if given, ``[K, B, NEG]``).  Returns
    the mean metrics over the K steps."""
    return _multi(make_train_step(model, cfg, optimizer, neg_cdf, item_dept,
                                  item_cat, user_history, device, mesh,
                                  shardings))


# ------------------------------------------------- the sparse table update

TABLE_KEYS = ("user_emb", "item_emb")


def sparse_mode_available(cfg: Config, mesh=None) -> bool:
    """Whether the sparse table update applies: rowwise-Adagrad tables,
    AdvancedNCF in the big-vocabulary (precompute-off) regime, and no
    strictly-causal per-example histories.  Under a mesh, the reference's
    static-shape rule too: sharded tables, both tables' rows dividing
    ici and the batch dividing the ranks."""
    m, t = cfg.model, cfg.train
    base = (t.embedding_optimizer == "rowwise_adagrad"
            and m.name == "advanced_ncf"
            and not (m.use_sequence and m.causal_history)
            and m.num_users + m.num_items
            > 4 * t.batch_size * (1 + m.negative_samples))
    if not base or mesh is None:
        return base
    E = int(mesh.shape[ICI_AXIS])
    G = int(mesh.shape.get(DCN_AXIS, 1))
    return bool(getattr(cfg.mesh, "shard_embeddings", True)
                and m.num_users % E == 0
                and m.num_items % E == 0
                and t.batch_size % (E * G) == 0)


def init_sparse_opt_state(dense_optimizer, params) -> Dict[str, Any]:
    """The sparse path's state: the dense optimizer's over the dense
    params, a zero f32 accumulator a table row, and the schedule's
    count."""
    dense = {k: v for k, v in params.items() if k not in TABLE_KEYS}
    dev = params["user_emb"].device
    return {"dense": dense_optimizer.init(dense),
            "user_acc": torch.zeros(params["user_emb"].shape[0],
                                    dtype=torch.float32, device=dev),
            "item_acc": torch.zeros(params["item_emb"].shape[0],
                                    dtype=torch.float32, device=dev),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def _make_sparse_body(model, cfg: Config, dense_optimizer, schedule,
                      mesh=None):
    """One sparse step (``ncf_tpu/train/step.py::_make_sparse_body``).
    It draws from ``gen`` in the dense step's order (negatives, then
    dropout), so the two paths take the same draws.  The tables are this
    rank's shards: with ici > 1 the rows come through the exchange, and
    the row gradients go to their owners (``train/sparse_sharded.py``;
    on one rank that is the local combine)."""
    tcfg = cfg.train
    loss_fn = _make_loss_fn(model, cfg)
    clip = tcfg.gradient_clip_norm or 0.0
    emb_scale = ((tcfg.embedding_learning_rate / tcfg.learning_rate)
                 if tcfg.embedding_learning_rate else 1.0)
    ewd = getattr(tcfg, "embedding_weight_decay", 0.0) or 0.0
    eps = getattr(tcfg, "embedding_adagrad_eps", 1e-8)
    plan = _MeshPlan(mesh)
    mesh = plan.mesh

    def gather(table, ids):
        if mesh.shape[ICI_AXIS] > 1:
            return exchange_gather(mesh, table, ids)
        return table[ids.long()]

    def body(params, opt_state, gen, batch, consts, negatives=None):
        tables = {k: params[k] for k in TABLE_KEYS}
        dense = {k: v for k, v in params.items() if k not in TABLE_KEYS}
        with annotate("step.inputs"):
            batch, drawn = plan.slice_batch(
                batch, loss_fn.inputs(batch, gen, consts, negatives))
            items, _, history = drawn
            uids = batch["user_ids"]
            item_ids = items.reshape(-1)
            rows = {"user_rows": gather(tables["user_emb"], uids),
                    "item_rows": gather(tables["item_emb"],
                                        item_ids).reshape(
                                            items.shape + (-1,))}
            h_ids = None
            if history is not None:
                # padded slots alias the example's positive row (touched
                # anyway) and get exactly-zero gradients
                h_ids = torch.where(history >= 0, history,
                                    items[:, :1].to(history.dtype)
                                    ).reshape(-1)
                rows["history_rows"] = gather(
                    tables["item_emb"], h_ids).reshape(
                        history.shape + (-1,))
        loss, logits, targets, grads = _grads(
            lambda d, *a, **r: loss_fn({**d, **tables}, *a, **r), dense,
            batch, gen, consts, None, drawn, rows=rows, scale=plan.scale,
            mesh=mesh)
        nd = len(grads) - len(rows)
        g_dense, g_u = grads[:nd], grads[nd]
        g_i = grads[nd + 1].reshape(-1, grads[nd + 1].shape[-1])
        item_upd_ids = item_ids
        if h_ids is not None:
            g_i = torch.cat([g_i, grads[nd + 2].reshape(-1, g_i.shape[-1])])
            item_upd_ids = torch.cat([item_ids, h_ids.to(item_ids.dtype)])
        with torch.no_grad():
            g_dense = plan.reduce_grads(list(g_dense))
            with annotate("step.sparse_update"):
                # optax's schedule is read at the count before the
                # increment
                lr_t = schedule(opt_state["count"]) * emb_scale
                # the clip norm is the dense path's: over the dense
                # gradients and the per-row totals
                dense_sq = (torch.stack([g.to(torch.float32).square().sum()
                                         for g in g_dense]).sum()
                            if clip > 0 and g_dense else None)
                _, _, gscale = sharded_sparse_rowwise_adagrad_update(
                    mesh, [tables["user_emb"], tables["item_emb"]],
                    [opt_state["user_acc"], opt_state["item_acc"]],
                    [uids, item_upd_ids], [g_u, g_i], lr_t, eps, ewd,
                    clip=clip, dense_sq=dense_sq)
            with annotate("step.metrics"):
                metrics = plan.metrics(loss, logits, targets)
            with annotate("step.optimizer"):
                if clip > 0:
                    for g in g_dense:
                        g.mul_(gscale.to(g.dtype))
                dense_state = dense_optimizer.update(dense, g_dense,
                                                     opt_state["dense"])
        opt_state = {"dense": dense_state, "user_acc": opt_state["user_acc"],
                     "item_acc": opt_state["item_acc"],
                     "count": (opt_state["count"] + 1).to(torch.int32)}
        return params, opt_state, gen, metrics

    return body


def make_sparse_train_step(
    model, cfg: Config, dense_optimizer, schedule, neg_cdf=None,
    item_dept=None, item_cat=None, mesh=None, user_history=None,
    device: DeviceLike = None,
) -> Callable:
    """The sparse table update with ``make_train_step``'s contract,
    ``train_step(params, opt_state, gen, batch, negatives=None)``:
    ``opt_state`` from ``init_sparse_opt_state``, ``dense_optimizer`` the
    dense params' optimizer (built without a clip: the step clips the
    whole set), ``schedule`` the learning rate's.  Tables and
    accumulators are updated in place, touched rows only.  Under a mesh
    ``batch`` is the global batch and the tables and accumulators are
    this rank's shards."""
    if mesh is not None and not sparse_mode_available(cfg, mesh):
        raise ValueError("the sparse update over this mesh needs sharded "
                         "tables whose rows divide ici and a batch that "
                         "divides the ranks")
    dev = resolve_device(device)
    body = _make_sparse_body(model, cfg, dense_optimizer, schedule, mesh)
    consts = _consts(dev, neg_cdf, item_dept, item_cat, user_history)

    def train_step(params, opt_state, gen, batch, negatives=None):
        with annotate("step"):
            with annotate("step.inputs"):
                batch = _batch_to(batch, dev)
            return body(params, opt_state, gen, batch, consts, negatives)

    return train_step


def make_sparse_multi_train_step(
    model, cfg: Config, dense_optimizer, schedule, neg_cdf=None,
    item_dept=None, item_cat=None, mesh=None, user_history=None,
    device: DeviceLike = None,
) -> Callable:
    """K sparse steps per call (``make_multi_train_step``'s contract)."""
    return _multi(make_sparse_train_step(
        model, cfg, dense_optimizer, schedule, neg_cdf, item_dept, item_cat,
        mesh, user_history, device))


def make_eval_step(
    model,
    cfg: Config,
    neg_cdf=None,
    item_dept=None,
    item_cat=None,
    user_history=None,
    device: DeviceLike = None,
    mesh=None,
) -> Callable:
    """Validation loss and accuracy stats on held-out interactions with
    freshly sampled (iid) negatives: ``eval_step(params, gen, batch,
    negatives=None) -> (gen, metrics)``.  Sequence models take history
    from ``user_history`` only, as the reference's eval step does.
    Under a mesh, ``batch`` is the global batch (the train step's
    contract) and the metrics are its own."""
    dev = resolve_device(device)
    loss_fn = _make_loss_fn(model, cfg, training=False)
    consts = _consts(dev, neg_cdf, item_dept, item_cat, user_history)
    plan = _MeshPlan(mesh)

    @torch.no_grad()
    def eval_step(params, gen, batch, negatives=None):
        batch = _batch_to(batch, dev)
        lbatch, ldrawn = plan.slice_batch(
            batch, loss_fn.inputs(batch, gen, consts, negatives))
        loss, logits, targets = loss_fn(params, lbatch, gen, consts, None,
                                        ldrawn, mesh=plan.mesh)
        return gen, plan.metrics(loss, logits, targets)

    return eval_step
