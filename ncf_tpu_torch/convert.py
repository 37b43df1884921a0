"""Carry parameter trees between numpy and the port.

A param tree is a nested dict/list (the JAX pytree's structure: the same
keys, list indices for tower layers, ``[in, out]`` weights).  The JAX
package's params convert with ``jax.tree.map(np.asarray, params)`` on
its side; this module takes it from there.
"""

from __future__ import annotations

from typing import Any, Callable

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


def array_to_tensor(arr, device: torch.device) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:            # torch tensors alias writable memory
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":       # ml_dtypes: reinterpret the bits
        t = torch.from_numpy(arr.view(np.uint16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


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
