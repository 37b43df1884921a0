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
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ncf_tpu_torch.convert import tree_leaves, tree_map
from ncf_tpu_torch.data.sampler import (sample_negatives,
                                        sample_negatives_stratified)
from ncf_tpu_torch.evals.metrics import accuracy_stats
from ncf_tpu_torch.train.optim import Adam
from ncf_tpu_torch.train.sparse import (combine_duplicate_rows,
                                        sparse_rowwise_adagrad_apply)
from ncf_tpu_torch.utils.config import Config
from ncf_tpu_torch.utils.device import DeviceLike, resolve_device

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


def _grads(loss_fn, params, *args, rows=None):
    """(loss, logits, targets) and the gradient of every param leaf, in
    ``tree_leaves`` order (zeros where the loss does not reach a leaf,
    as ``jax.grad`` gives), then of each of ``rows`` (``apply``'s
    injected rows, by name; ``params`` then holds no table they stand
    in for)."""
    leaves, tracked = _track(params)
    rows = {k: r.detach().requires_grad_(True) for k, r in (rows or {}).items()}
    with torch.enable_grad():
        loss, logits, targets = loss_fn(tracked, *args, **rows)
        grads = torch.autograd.grad(loss, leaves + list(rows.values()),
                                    allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)] + list(grads[len(leaves):])
    return loss.detach(), logits.detach(), targets, grads


def make_train_step(
    model,
    cfg: Config,
    optimizer: Adam,
    neg_cdf=None,                  # [num_items] sampling CDF
    item_dept=None,
    item_cat=None,
    user_history=None,             # int [U, H] padded with -1
    device: DeviceLike = None,
) -> Callable:
    """Returns ``train_step(params, opt_state, gen, batch, negatives=None)
    -> (params, opt_state, gen, metrics)``.

    ``batch``: {user_ids [B], item_ids [B] (positives), hour, day, month,
    day_of_year, and for sequence models optionally history [B, H]},
    NumPy arrays or tensors; they move to the step's device
    (``cuda`` unless ``device`` says otherwise).  ``gen`` is a
    ``torch.Generator`` on that device.  ``metrics``: loss, accuracy,
    pos_accuracy and neg_accuracy as device scalars."""
    dev = resolve_device(device)
    loss_fn = _make_loss_fn(model, cfg)
    consts = _consts(dev, neg_cdf, item_dept, item_cat, user_history)

    def train_step(params, opt_state, gen, batch, negatives=None):
        batch = _batch_to(batch, dev)
        loss, logits, targets, grads = _grads(
            loss_fn, params, batch, gen, consts, negatives)
        opt_state = optimizer.update(params, grads, opt_state)
        with torch.no_grad():
            metrics = {"loss": loss, **accuracy_stats(logits, targets)}
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
) -> Callable:
    """K steps per call: ``multi_train_step(params, opt_state, gen,
    batches, negatives=None)`` where every entry of ``batches`` is stacked
    ``[K, B]`` (and ``negatives``, if given, ``[K, B, NEG]``).  Returns
    the mean metrics over the K steps."""
    return _multi(make_train_step(model, cfg, optimizer, neg_cdf, item_dept,
                                  item_cat, user_history, device))


# ------------------------------------------------- the sparse table update

TABLE_KEYS = ("user_emb", "item_emb")


def sparse_mode_available(cfg: Config, mesh=None) -> bool:
    """Whether the sparse table update applies: rowwise-Adagrad tables,
    AdvancedNCF in the big-vocabulary (precompute-off) regime, and no
    strictly-causal per-example histories.  The port has no mesh yet
    (ROADMAP A5): given one, it raises."""
    if mesh is not None:
        raise NotImplementedError(
            "the sparse update over a mesh is not ported yet (ROADMAP A5)")
    m, t = cfg.model, cfg.train
    return (t.embedding_optimizer == "rowwise_adagrad"
            and m.name == "advanced_ncf"
            and not (m.use_sequence and m.causal_history)
            and m.num_users + m.num_items
            > 4 * t.batch_size * (1 + m.negative_samples))


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


def _make_sparse_body(model, cfg: Config, dense_optimizer, schedule):
    """One sparse step (``ncf_tpu/train/step.py::_make_sparse_body``
    without a mesh).  It draws from ``gen`` in the dense step's order
    (negatives, then dropout), so the two paths take the same draws."""
    tcfg = cfg.train
    loss_fn = _make_loss_fn(model, cfg)
    clip = tcfg.gradient_clip_norm or 0.0
    emb_scale = ((tcfg.embedding_learning_rate / tcfg.learning_rate)
                 if tcfg.embedding_learning_rate else 1.0)
    ewd = getattr(tcfg, "embedding_weight_decay", 0.0) or 0.0
    eps = getattr(tcfg, "embedding_adagrad_eps", 1e-8)

    def body(params, opt_state, gen, batch, consts, negatives=None):
        tables = {k: params[k] for k in TABLE_KEYS}
        dense = {k: v for k, v in params.items() if k not in TABLE_KEYS}
        drawn = loss_fn.inputs(batch, gen, consts, negatives)
        items, _, history = drawn
        uids = batch["user_ids"]
        item_ids = items.reshape(-1)
        rows = {"user_rows": tables["user_emb"][uids.long()],
                "item_rows": tables["item_emb"][item_ids.long()].reshape(
                    items.shape + (-1,))}
        h_ids = None
        if history is not None:
            # padded slots alias the example's positive row (touched
            # anyway) and get exactly-zero gradients
            h_ids = torch.where(history >= 0, history,
                                items[:, :1].to(history.dtype)).reshape(-1)
            rows["history_rows"] = tables["item_emb"][h_ids.long()].reshape(
                history.shape + (-1,))
        loss, logits, targets, grads = _grads(
            lambda d, *a, **r: loss_fn({**d, **tables}, *a, **r), dense,
            batch, gen, consts, None, drawn, rows=rows)
        nd = len(grads) - len(rows)
        g_dense, g_u = grads[:nd], grads[nd]
        g_i = grads[nd + 1].reshape(-1, grads[nd + 1].shape[-1])
        item_upd_ids = item_ids
        if h_ids is not None:
            g_i = torch.cat([g_i, grads[nd + 2].reshape(-1, g_i.shape[-1])])
            item_upd_ids = torch.cat([item_ids, h_ids.to(item_ids.dtype)])
        with torch.no_grad():
            # optax's schedule is read at the count before the increment
            lr_t = schedule(opt_state["count"]) * emb_scale
            # combine first: the clip norm is the dense path's, over
            # per-row totals
            u_rep, u_tot = combine_duplicate_rows(
                uids, g_u, tables["user_emb"].shape[0])
            i_rep, i_tot = combine_duplicate_rows(
                item_upd_ids, g_i, tables["item_emb"].shape[0])
            if clip > 0:
                sq = [g.to(torch.float32).square().sum()
                      for g in g_dense + [u_tot, i_tot]]
                trigger = torch.clamp(clip / torch.stack(sq).sum().sqrt(),
                                      max=1.0)
                for g in g_dense:
                    g.mul_(trigger.to(g.dtype))
                u_tot = u_tot * trigger
                i_tot = i_tot * trigger
            sparse_rowwise_adagrad_apply(
                tables["user_emb"], opt_state["user_acc"], u_rep, u_tot,
                lr_t, eps, ewd)
            sparse_rowwise_adagrad_apply(
                tables["item_emb"], opt_state["item_acc"], i_rep, i_tot,
                lr_t, eps, ewd)
            dense_state = dense_optimizer.update(dense, g_dense,
                                                 opt_state["dense"])
            metrics = {"loss": loss, **accuracy_stats(logits, targets)}
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
    accumulators are updated in place, touched rows only."""
    sparse_mode_available(cfg, mesh)            # raises on a mesh
    dev = resolve_device(device)
    body = _make_sparse_body(model, cfg, dense_optimizer, schedule)
    consts = _consts(dev, neg_cdf, item_dept, item_cat, user_history)

    def train_step(params, opt_state, gen, batch, negatives=None):
        return body(params, opt_state, gen, _batch_to(batch, dev), consts,
                    negatives)

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
) -> Callable:
    """Validation loss and accuracy stats on held-out interactions with
    freshly sampled (iid) negatives: ``eval_step(params, gen, batch,
    negatives=None) -> (gen, metrics)``.  Sequence models take history
    from ``user_history`` only, as the reference's eval step does."""
    dev = resolve_device(device)
    loss_fn = _make_loss_fn(model, cfg, training=False)
    consts = _consts(dev, neg_cdf, item_dept, item_cat, user_history)

    @torch.no_grad()
    def eval_step(params, gen, batch, negatives=None):
        loss, logits, targets = loss_fn(params, _batch_to(batch, dev), gen,
                                        consts, negatives)
        return gen, {"loss": loss, **accuracy_stats(logits, targets)}

    return eval_step
