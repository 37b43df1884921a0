"""Carry parameter trees between numpy and the port.

A param tree is a nested dict/list (the JAX pytree's structure: the same
keys, list indices for tower layers, ``[in, out]`` weights).  The JAX
package's params convert with ``jax.tree.map(np.asarray, params)`` on
its side; this module takes it from there.

The Adam state moves the same way: ``adam_state_from_numpy`` reads the
``count``, ``mu`` and ``nu`` of optax's ``ScaleByAdamState`` out of an
optimizer state (mapped to numpy), and ``adam_state_to_numpy`` writes the
port's back into such a state, schedule counts included.  Any other state
of the reference's optimizers (the ``multi_transform`` chain of the table
optimizers, the sparse path's dict) goes through its leaf names:
``named_tree`` names an optax state's leaves as the JAX package's
checkpoints do, ``opt_state_from_numpy`` reads the port's state from it
and ``opt_state_to_numpy`` writes the port's into an optax template
(``train/checkpoint.py::named_opt_state`` holds the naming).
"""

from __future__ import annotations

from typing import Any, Callable, List

import numpy as np
import torch

from ncf_tpu_torch.utils.device import DeviceLike, resolve_device


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a nested dict/list/tuple."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a nested dict/list/tuple, in ``tree_map``'s order
    (dict keys as stored)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def array_to_tensor(arr, device: torch.device) -> torch.Tensor:
    shape = np.shape(arr)
    # ascontiguousarray makes a 0-d array 1-d: keep the shape
    arr = np.ascontiguousarray(arr).reshape(shape)
    if not arr.flags.writeable:            # torch tensors alias writable memory
        arr = arr.copy()
    # copy=True: the tensor never aliases the caller's array (the
    # optimizer updates params in place)
    if arr.dtype.name == "bfloat16":       # ml_dtypes: reinterpret the bits
        t = torch.from_numpy(arr.view(np.uint16))
        return t.view(torch.bfloat16).to(device, copy=True)
    return torch.from_numpy(arr).to(device, copy=True)


def params_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """Nested dict/list of numpy arrays -> the port's param tree on
    ``device`` (default ``cuda``), keeping keys, shapes and dtypes."""
    dev = resolve_device(device)
    return tree_map(lambda a: array_to_tensor(a, dev), tree)


def _to_numpy(t: Any) -> np.ndarray:
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:          # numpy has no bf16: widen exactly
        t = t.to(torch.float32)
    return t.numpy()


def params_to_numpy(tree: Any) -> Any:
    """The port's param tree -> nested dict/list of numpy arrays (bf16
    leaves widen to float32, which is exact)."""
    return tree_map(_to_numpy, tree)


def params_to_device(tree: Any, device: DeviceLike = None) -> Any:
    """Move every tensor leaf to ``device``; numpy leaves convert."""
    dev = resolve_device(device)
    return tree_map(lambda a: a.to(dev) if isinstance(a, torch.Tensor)
                    else array_to_tensor(a, dev), tree)


def _fields(node: Any) -> tuple:
    """A NamedTuple's field names (optax states are NamedTuples)."""
    return getattr(node, "_fields", ())


def _is_adam(node: Any) -> bool:
    return all(f in _fields(node) for f in ("count", "mu", "nu"))


def _find_adam(state: Any):
    """The ``ScaleByAdamState`` (a NamedTuple with ``count``, ``mu`` and
    ``nu``) inside an optax optimizer state."""
    if _is_adam(state):
        return state
    if isinstance(state, (list, tuple)):
        for s in state:
            found = _find_adam(s)
            if found is not None:
                return found
    return None


def adam_state_from_numpy(opt_state: Any, device: DeviceLike = None) -> dict:
    """optax state (mapped to numpy) -> the port's Adam state on
    ``device``: ``{"count": int32 scalar, "mu": tree, "nu": tree}``."""
    adam = _find_adam(opt_state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in this state")
    dev = resolve_device(device)
    return {"count": torch.tensor(int(np.asarray(adam.count)),
                                  dtype=torch.int32, device=dev),
            "mu": params_from_numpy(adam.mu, dev),
            "nu": params_from_numpy(adam.nu, dev)}


def adam_state_to_numpy(state: dict, template: Any) -> Any:
    """The port's Adam state written into ``template``, an optax state of
    the same optimizer (numpy or JAX leaves): the Adam moments and every
    step count (Adam's and the schedule's) replaced, numpy leaves."""
    count = np.asarray(int(state["count"]), np.int32)
    mu, nu = params_to_numpy(state["mu"]), params_to_numpy(state["nu"])

    def fill(node):
        if _is_adam(node):
            return node._replace(count=count, mu=mu, nu=nu)
        if hasattr(node, "_fields"):          # another optax state
            return (node._replace(count=count) if "count" in node._fields
                    else node)
        if isinstance(node, (tuple, list)):
            return type(node)(fill(n) for n in node)
        return node

    return fill(template)


def named_tree(state: Any) -> Any:
    """An optax state (numpy leaves; NamedTuples, tuples, dicts) as nested
    dicts keyed as the JAX package's checkpoint paths (field names, list
    indices as strings, dict keys), sub-trees without leaves dropped."""
    if hasattr(state, "_fields"):
        items = [(f, getattr(state, f)) for f in state._fields]
    elif isinstance(state, dict):
        items = list(state.items())
    elif isinstance(state, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(state)]
    else:
        return state
    out = {}
    for k, v in items:
        sub = named_tree(v)
        if not (isinstance(sub, dict) and not sub):
            out[str(k)] = sub
    return out


def opt_state_from_numpy(opt_state: Any, device: DeviceLike = None) -> Any:
    """The port's state of any of the reference's optimizers (an optax
    state or the sparse path's dict, numpy leaves) on ``device``."""
    from ncf_tpu_torch.train.checkpoint import opt_state_from_named

    dev = resolve_device(device)
    return opt_state_from_named(
        tree_map(lambda a: array_to_tensor(a, dev), named_tree(opt_state)))


def opt_state_to_numpy(state: Any, template: Any, cfg) -> Any:
    """The port's optimizer state written into ``template``, the state of
    the reference's optimizer for the train config ``cfg`` (numpy or JAX
    leaves): every leaf replaced by the port's of the same name, as
    numpy.  The sparse path's dict keeps its dense optimizer unclipped,
    as the reference's does."""
    from ncf_tpu_torch.train.checkpoint import (_leaves_with_path,
                                                named_opt_state)

    named = dict(_leaves_with_path(named_opt_state(
        state, cfg.gradient_clip_norm, cfg.weight_decay,
        cfg.embedding_weight_decay, cfg.embedding_learning_rate)))

    def fill(node, prefix):
        def sub(k):
            return f"{prefix}.{k}" if prefix else str(k)
        if hasattr(node, "_fields"):
            return node._replace(**{f: fill(getattr(node, f), sub(f))
                                    for f in node._fields})
        if isinstance(node, dict):
            return {k: fill(v, sub(k)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(fill(v, sub(i)) for i, v in enumerate(node))
        return _to_numpy(named[prefix]).astype(np.asarray(node).dtype)

    return fill(template, "")
