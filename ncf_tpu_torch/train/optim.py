"""Optimizers: global-norm clip, L2 decay, Adam or a table optimizer,
learning-rate schedule.

Port of ``ncf_tpu/train/optim.py``.  The chain runs in the reference's
order (``optim.py:215-268``):

1. clip by global norm, optax's rule: when the norm reaches ``max_norm``
   every gradient is scaled by ``max_norm / norm``, below it nothing
   changes (``clip_grad_norm_`` would divide by ``norm + 1e-6``);
2. L2 decay into the gradient, ``g + wd * p`` (torch Adam's
   ``weight_decay``, not decoupled AdamW); under a table optimizer other
   than ``adam`` only the dense params decay;
3. Adam, optax's ``scale_by_adam``: ``m / (sqrt(v) + eps)`` of the
   bias-corrected moments at the incremented count; or, with
   ``embedding_optimizer`` other than ``adam`` or a separate
   ``embedding_learning_rate``, the reference's ``multi_transform``:
   Adam on the dense params, and on the tables (``embedding_labels``)
   ``embedding_weight_decay``, then the table rule, then the factor
   ``embedding_learning_rate / learning_rate``;
4. the learning rate of the schedule at the count BEFORE the increment
   (optax's ``scale_by_learning_rate``).

The table rules (fbgemm's fused table optimizers, reference
``optim.py:58-200``): ``rowwise_adagrad`` (one f32 accumulator a row, the
running sum of the row's mean squared gradient, ``g / (sqrt(G) + eps)``
in the gradient's dtype), ``partial_rowwise_adam`` (an f32 first moment a
value, a second moment a row) and ``bf16_adam`` (both moments stored in
bf16, arithmetic in f32).

``Adam``'s state is ``{"count", "mu", "nu"}``; ``TableOptimizer``'s is
``{"count", "dense": {"mu", "nu"}, "embedding": {...}}`` with the table
rule's leaves under ``embedding`` (``sum_sq``; ``mu`` and ``nu_row``;
``mu`` and ``nu``), each a tree of the table leaves.  Every leaf lives on
the params' device and is updated in place; ``train/checkpoint.py``
writes both under optax's leaf names.  The schedule is evaluated on the
device from the count tensor, so a step never waits for the host.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List

import torch

from ncf_tpu_torch.convert import tree_leaves, tree_map
from ncf_tpu_torch.utils.config import TrainConfig

Schedule = Callable[[torch.Tensor], torch.Tensor]


def _f32(count: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(count).to(torch.float32)


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax ``linear_schedule(init, end, steps)``."""
    def schedule(count):
        c = torch.clamp(_f32(count), 0.0, float(steps))
        return (init - end) * (1.0 - c / steps) + end
    return schedule


def _cosine(init: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """optax ``cosine_decay_schedule(init, decay_steps, alpha)``."""
    if decay_steps <= 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got "
                         f"{decay_steps}")

    def schedule(count):
        c = torch.clamp(_f32(count), max=float(decay_steps))
        cos = 0.5 * (1.0 + torch.cos(math.pi * c / decay_steps))
        return init * ((1.0 - alpha) * cos + alpha)
    return schedule


def make_schedule(cfg: TrainConfig, steps_per_epoch: int) -> Schedule:
    """The learning rate as a function of the step count (a tensor):
    constant, or cosine decay over ``num_epochs * steps_per_epoch`` steps,
    after a linear warm-up from 0 when ``warmup_steps > 0``."""
    total = max(1, cfg.num_epochs * steps_per_epoch)
    lr = cfg.learning_rate
    if cfg.lr_schedule == "cosine":
        warmup = cfg.warmup_steps
        if warmup <= 0:
            return _cosine(lr, total)
        ramp, decay = _linear(0.0, lr, warmup), _cosine(lr, total - warmup)

        def schedule(count):
            c = torch.as_tensor(count)
            return torch.where(c < warmup, ramp(c), decay(c - warmup))
        return schedule
    if cfg.lr_schedule == "constant":
        return lambda count: torch.full_like(_f32(count), lr)
    raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")




EMBEDDING_OPTIMIZERS = ("adam", "rowwise_adagrad", "bf16_adam",
                        "partial_rowwise_adam")
# param-path substrings that mark a table (the port's copy of
# ``ncf_tpu/parallel/mesh.py::EMBEDDING_TABLE_KEYS``)
EMBEDDING_TABLE_KEYS = (
    "user_emb", "item_emb",                         # AdvancedNCF fused tables
    "mf_user", "mf_item", "mlp_user", "mlp_item",   # NCF/NeuMF tables
    "gmf_user", "gmf_item",
)


_NONE = object()


def _labelled(tree: Any, prefix: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _labelled(v, f"{prefix}.{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_labelled(v, f"{prefix}.{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    return ("embedding" if any(k in prefix for k in EMBEDDING_TABLE_KEYS)
            else "dense")


def embedding_labels(tree: Any) -> Any:
    """Label every leaf ``"embedding"`` (a table) or ``"dense"`` by its
    dotted path, the reference's rule."""
    return _labelled(tree)


def select(tree: Any, label: str) -> Any:
    """The sub-tree of the leaves labelled ``label``: dict entries with
    none of them are dropped (as optax's mask drops its masked leaves
    from a state's paths), list positions kept."""
    def keep(node, lab):
        if isinstance(node, dict):
            out = {k: keep(v, lab[k]) for k, v in node.items()}
            return {k: v for k, v in out.items() if v is not _NONE} or _NONE
        if isinstance(node, (list, tuple)):
            out = [keep(v, lb) for v, lb in zip(node, lab)]
            kept = [v is not _NONE for v in out]
            if any(kept) and not all(kept):
                raise ValueError("a list mixes tables and dense leaves")
            return type(node)(out) if all(kept) else _NONE
        return node if lab == label else _NONE

    out = keep(tree, embedding_labels(tree))
    return {} if out is _NONE else out


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """optax's ``global_norm``: the f32 norm of every leaf together."""
    return torch.linalg.vector_norm(torch.stack(
        [n.to(torch.float32) for n in torch._foreach_norm(grads)]))


def _clip(grads: List[torch.Tensor], clip_norm: float,
          norm_fn=None) -> None:
    """optax's ``clip_by_global_norm`` in place over ``grads``;
    ``norm_fn(grads)`` gives the norm where the leaves are split over a
    mesh (``train/step.py``)."""
    norm = (norm_fn or global_norm)(grads)
    scale = torch.where(norm < clip_norm, torch.ones_like(norm),
                        clip_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))


def _bias_corrections(count: torch.Tensor, b1: float, b2: float):
    c = count.to(torch.float32)
    return (1.0 - torch.full_like(c, b1).pow(c),
            1.0 - torch.full_like(c, b2).pow(c))


def _adam(mu, nu, grads, inc, b1, b2, eps) -> List[torch.Tensor]:
    """optax's ``scale_by_adam``: moments updated in place, the updates
    returned (new tensors)."""
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, grads, alpha=1.0 - b1)
    torch._foreach_mul_(nu, b2)
    torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
    bc1, bc2 = _bias_corrections(inc, b1, b2)
    den = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    upd = torch._foreach_div(mu, bc1)
    torch._foreach_div_(upd, den)
    return upd


def _row_mean_sq(g: torch.Tensor) -> torch.Tensor:
    g32 = g.to(torch.float32)
    return g32.square().mean(dim=tuple(range(1, g32.dim())))


def _per_row(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return v.reshape(v.shape + (1,) * (like.dim() - 1))


class Adam:
    """The chain above with Adam on every leaf (``embedding_optimizer:
    adam``, no separate table learning rate)."""

    def __init__(self, schedule: Schedule, clip_norm: float = 0.0,
                 weight_decay: float = 0.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.schedule = schedule
        self.clip_norm = clip_norm or 0.0
        self.weight_decay = weight_decay or 0.0
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Any) -> Dict[str, Any]:
        return {"count": _count(params),
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(self, params: Any, grads: List[torch.Tensor],
               state: Dict[str, Any], norm_fn=None) -> Dict[str, Any]:
        """One step: ``grads`` in the order of ``tree_leaves(params)``
        (consumed); params, ``mu`` and ``nu`` are updated in place.
        Returns the state with the incremented count.  ``norm_fn`` gives
        the clip's global norm of ``grads`` under a mesh."""
        ps = tree_leaves(params)
        count = state["count"]
        if self.clip_norm > 0:
            _clip(grads, self.clip_norm, norm_fn)
        if self.weight_decay > 0:
            torch._foreach_add_(grads, ps, alpha=self.weight_decay)
        inc = count + 1
        upd = _adam(tree_leaves(state["mu"]), tree_leaves(state["nu"]),
                    grads, inc, self.b1, self.b2, self.eps)
        torch._foreach_mul_(upd, -self.schedule(count).to(inc.device))
        torch._foreach_add_(ps, upd)
        return {"count": inc.to(torch.int32), "mu": state["mu"],
                "nu": state["nu"]}


def _count(params: Any) -> torch.Tensor:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=dev)


class TableOptimizer:
    """The reference's ``multi_transform`` chain: Adam on the dense
    params, ``kind`` (one of ``EMBEDDING_OPTIMIZERS``) on the tables."""

    def __init__(self, schedule: Schedule, kind: str, clip_norm: float = 0.0,
                 weight_decay: float = 0.0,
                 embedding_weight_decay: float = 0.0,
                 embedding_scale: float = 1.0, adagrad_eps: float = 1e-8,
                 adagrad_init: float = 0.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        if kind not in EMBEDDING_OPTIMIZERS:
            raise ValueError(f"unknown embedding_optimizer {kind!r}; "
                             f"use one of {EMBEDDING_OPTIMIZERS}")
        self.schedule, self.kind = schedule, kind
        self.clip_norm = clip_norm or 0.0
        self.weight_decay = weight_decay or 0.0
        self.embedding_weight_decay = embedding_weight_decay or 0.0
        self.embedding_scale = embedding_scale
        self.adagrad_eps, self.adagrad_init = adagrad_eps, adagrad_init
        self.b1, self.b2, self.eps = b1, b2, eps

    def _table_state(self, tables: Any) -> Dict[str, Any]:
        if self.kind == "rowwise_adagrad":
            return {"sum_sq": tree_map(lambda p: torch.full(
                p.shape[:1], self.adagrad_init, dtype=torch.float32,
                device=p.device), tables)}
        if self.kind == "partial_rowwise_adam":
            return {"mu": tree_map(lambda p: torch.zeros_like(
                        p, dtype=torch.float32), tables),
                    "nu_row": tree_map(lambda p: torch.zeros(
                        p.shape[:1], dtype=torch.float32, device=p.device),
                        tables)}
        dt = torch.bfloat16 if self.kind == "bf16_adam" else None
        return {"mu": tree_map(lambda p: torch.zeros_like(p, dtype=dt),
                               tables),
                "nu": tree_map(lambda p: torch.zeros_like(p, dtype=dt),
                               tables)}

    def init(self, params: Any) -> Dict[str, Any]:
        dense = select(params, "dense")
        return {"count": _count(params),
                "dense": {"mu": tree_map(torch.zeros_like, dense),
                          "nu": tree_map(torch.zeros_like, dense)},
                "embedding": self._table_state(select(params, "embedding"))}

    def _table_updates(self, gs, st, inc) -> List[torch.Tensor]:
        """The table rule's updates (new tensors); its state in place."""
        b1, b2 = self.b1, self.b2
        if self.kind == "rowwise_adagrad":
            out = []
            for g, s in zip(gs, tree_leaves(st["sum_sq"])):
                s.add_(_row_mean_sq(g))
                den = _per_row(s.sqrt() + self.adagrad_eps, g)
                out.append((g.to(torch.float32) / den).to(g.dtype))
            return out
        if self.kind == "adam":
            return _adam(tree_leaves(st["mu"]), tree_leaves(st["nu"]), gs,
                         inc, b1, b2, self.eps)
        c1, c2 = _bias_corrections(inc, b1, b2)
        out = []
        if self.kind == "partial_rowwise_adam":
            for g, m, v in zip(gs, tree_leaves(st["mu"]),
                               tree_leaves(st["nu_row"])):
                m.mul_(b1).add_((1 - b1) * g.to(torch.float32))
                v.mul_(b2).add_((1 - b2) * _row_mean_sq(g))
                den = _per_row((v / c2).sqrt() + self.eps, m)
                out.append(((m / c1) / den).to(g.dtype))
            return out
        for g, m, v in zip(gs, tree_leaves(st["mu"]), tree_leaves(st["nu"])):
            g32 = g.to(torch.float32)                       # bf16_adam
            m32 = b1 * m.to(torch.float32) + (1 - b1) * g32
            v32 = b2 * v.to(torch.float32) + (1 - b2) * g32.square()
            out.append((m32 / c1) / ((v32 / c2).sqrt() + self.eps))
            m.copy_(m32)
            v.copy_(v32)
        return out

    @torch.no_grad()
    def update(self, params: Any, grads: List[torch.Tensor],
               state: Dict[str, Any], norm_fn=None) -> Dict[str, Any]:
        """``Adam.update``'s contract over this chain."""
        labels = tree_leaves(embedding_labels(params))
        ps = tree_leaves(params)
        pick = lambda xs, lab: [x for x, lb in zip(xs, labels) if lb == lab]
        count = state["count"]
        inc = count + 1
        if self.clip_norm > 0:
            _clip(grads, self.clip_norm, norm_fn)
        if self.weight_decay > 0:
            # the table modes decay the dense params only; Adam tables
            # with their own learning rate decay with them
            scope = grads if self.kind == "adam" else pick(grads, "dense")
            torch._foreach_add_(scope, ps if self.kind == "adam"
                                else pick(ps, "dense"),
                                alpha=self.weight_decay)
        dense_g, table_g = pick(grads, "dense"), pick(grads, "embedding")
        dense_p, table_p = pick(ps, "dense"), pick(ps, "embedding")
        upd = _adam(tree_leaves(state["dense"]["mu"]),
                    tree_leaves(state["dense"]["nu"]), dense_g, inc,
                    self.b1, self.b2, self.eps) if dense_g else []
        if self.embedding_weight_decay > 0:
            table_g = [g + self.embedding_weight_decay * p
                       for g, p in zip(table_g, table_p)]
        t_upd = (self._table_updates(table_g, state["embedding"], inc)
                 if table_g else [])
        if t_upd and self.embedding_scale != 1.0:
            torch._foreach_mul_(t_upd, self.embedding_scale)
        lr = -self.schedule(count).to(inc.device)
        for u, p in zip(list(upd) + list(t_upd), dense_p + table_p):
            u.mul_(lr.to(u.dtype))
            p.add_(u)
        return {"count": inc.to(torch.int32), "dense": state["dense"],
                "embedding": state["embedding"]}


def make_optimizer(cfg: TrainConfig, steps_per_epoch: int = 1000):
    """The reference's optimizer for ``cfg``: ``Adam`` for ``adam`` tables
    without a separate table learning rate, else ``TableOptimizer``."""
    schedule = make_schedule(cfg, steps_per_epoch)
    emb_opt = getattr(cfg, "embedding_optimizer", "adam")
    if emb_opt not in EMBEDDING_OPTIMIZERS:
        raise ValueError(f"unknown embedding_optimizer {emb_opt!r}; "
                         f"use one of {EMBEDDING_OPTIMIZERS}")
    emb_lr = getattr(cfg, "embedding_learning_rate", 0.0) or 0.0
    clip, wd = cfg.gradient_clip_norm or 0.0, cfg.weight_decay or 0.0
    if emb_opt == "adam" and not emb_lr:
        return Adam(schedule, clip_norm=clip, weight_decay=wd)
    return TableOptimizer(
        schedule, emb_opt, clip_norm=clip, weight_decay=wd,
        embedding_weight_decay=getattr(cfg, "embedding_weight_decay", 0.0),
        embedding_scale=emb_lr / cfg.learning_rate if emb_lr else 1.0,
        adagrad_eps=getattr(cfg, "embedding_adagrad_eps", 1e-8),
        adagrad_init=getattr(cfg, "embedding_adagrad_init", 0.0))
