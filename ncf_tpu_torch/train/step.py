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

The sparse-table builders (``step.py:199-458``) belong to the big-vocab
slice and are not here.
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
    ``make_eval_step`` does."""
    mcfg = cfg.model
    S = 1 + mcfg.negative_samples
    loss_impl = make_loss(cfg.train.loss)
    joint = mcfg.candidate_mode == "joint"
    sample = (sample_negatives_stratified
              if training and cfg.train.negative_sampling == "stratified"
              else sample_negatives)

    def loss_fn(params, batch, gen, consts, negatives=None):
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
        logits = model.apply(
            params, mcfg, batch["user_ids"], items, temporal,
            consts.get("item_dept"), consts.get("item_cat"),
            candidate_attention=joint, deterministic=not training, rng=gen,
            history=history)
        targets = _targets(pos.shape[0], S, pos.device)
        return loss_impl(logits, targets), logits, targets

    return loss_fn


def _grads(loss_fn, params, *args):
    """(loss, logits, targets) and the gradient of every param leaf, in
    ``tree_leaves`` order (zeros where the loss does not reach a leaf,
    as ``jax.grad`` gives)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    tracked = tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        loss, logits, targets = loss_fn(tracked, *args)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
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
    step = make_train_step(model, cfg, optimizer, neg_cdf, item_dept,
                           item_cat, user_history, device)

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
