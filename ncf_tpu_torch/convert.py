"""Carry parameter trees between numpy and the port.

A param tree is a nested dict/list (the JAX pytree's structure: the same
keys, list indices for tower layers, ``[in, out]`` weights).  The JAX
package's params convert with ``jax.tree.map(np.asarray, params)`` on
its side; this module takes it from there.

The Adam state moves the same way: ``adam_state_from_numpy`` reads the
``count``, ``mu`` and ``nu`` of optax's ``ScaleByAdamState`` out of an
optimizer state (mapped to numpy), and ``adam_state_to_numpy`` writes the
port's back into such a state, schedule counts included.
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
