"""Optimizer: global-norm clip, L2 decay, Adam, learning-rate schedule.

Port of the dense path of ``ncf_tpu/train/optim.py`` (``make_schedule``,
``make_optimizer`` with ``embedding_optimizer: adam``).  The chain runs in
the reference's order (``optim.py:225-267``):

1. clip by global norm, optax's rule: when the norm reaches ``max_norm``
   every gradient is scaled by ``max_norm / norm``, below it nothing
   changes (``clip_grad_norm_`` would divide by ``norm + 1e-6``);
2. L2 decay into the gradient, ``g + wd * p`` (torch Adam's
   ``weight_decay``, not decoupled AdamW);
3. Adam, optax's ``scale_by_adam``: ``m / (sqrt(v) + eps)`` of the
   bias-corrected moments at the incremented count;
4. the learning rate of the schedule at the count BEFORE the increment
   (optax's ``scale_by_learning_rate``).

The state is ``{"count": int32 scalar, "mu": tree, "nu": tree}`` on the
params' device; ``convert.adam_state_from_numpy`` and
``adam_state_to_numpy`` carry it to and from optax's.  ``Adam.update``
writes the new params and moments in place (no second copy of either).
The schedule is evaluated on the device from the count tensor, so a step
never waits for the host.  The table optimizers (rowwise Adagrad,
partial-rowwise Adam, bf16 Adam) and a separate table learning rate raise
until the big-vocabulary slice.
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


class Adam:
    """The chain above over a param tree (nested dicts and lists)."""

    def __init__(self, schedule: Schedule, clip_norm: float = 0.0,
                 weight_decay: float = 0.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.schedule = schedule
        self.clip_norm = clip_norm or 0.0
        self.weight_decay = weight_decay or 0.0
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Any) -> Dict[str, Any]:
        first = tree_leaves(params)[0]
        return {"count": torch.zeros((), dtype=torch.int32,
                                     device=first.device),
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def _clip(self, grads: List[torch.Tensor]) -> None:
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        scale = torch.where(norm < self.clip_norm, torch.ones_like(norm),
                            self.clip_norm / norm)
        torch._foreach_mul_(grads, scale)

    @torch.no_grad()
    def update(self, params: Any, grads: List[torch.Tensor],
               state: Dict[str, Any]) -> Dict[str, Any]:
        """One step: ``grads`` in the order of ``tree_leaves(params)``
        (consumed); params, ``mu`` and ``nu`` are updated in place.
        Returns the state with the incremented count."""
        ps = tree_leaves(params)
        mu, nu = tree_leaves(state["mu"]), tree_leaves(state["nu"])
        count = state["count"]
        if self.clip_norm > 0:
            self._clip(grads)
        if self.weight_decay > 0:
            torch._foreach_add_(grads, ps, alpha=self.weight_decay)
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
        inc = count + 1
        c = inc.to(torch.float32)
        bc1 = 1.0 - torch.full_like(c, self.b1).pow(c)
        bc2 = 1.0 - torch.full_like(c, self.b2).pow(c)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, -self.schedule(count).to(c.device))
        torch._foreach_add_(ps, upd)
        return {"count": inc.to(torch.int32), "mu": state["mu"],
                "nu": state["nu"]}


def make_optimizer(cfg: TrainConfig, steps_per_epoch: int = 1000) -> Adam:
    """The reference's optimizer for ``embedding_optimizer: adam``."""
    emb_opt = getattr(cfg, "embedding_optimizer", "adam")
    if emb_opt != "adam":
        raise NotImplementedError(
            f"embedding_optimizer={emb_opt!r} is not ported yet")
    if getattr(cfg, "embedding_learning_rate", 0.0):
        raise NotImplementedError(
            "a separate embedding_learning_rate is not ported yet")
    return Adam(make_schedule(cfg, steps_per_epoch),
                clip_norm=cfg.gradient_clip_norm or 0.0,
                weight_decay=cfg.weight_decay or 0.0)
