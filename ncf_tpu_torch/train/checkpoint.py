"""Checkpoint restore and discovery in the JAX package's npy manifest
format (``ncf_tpu/train/checkpoint.py``): a directory of ``.npy`` leaves
keyed by their tree path plus ``manifest.json``.  Checkpoints written by
the JAX package load here unchanged.

``restore`` is template-driven (a tree of like leaves, e.g. from
``init(..., device="meta")``) and checks every shape.  ``save`` comes with
the training slice; the orbax backend is not supported.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ncf_tpu_torch.convert import array_to_tensor
from ncf_tpu_torch.utils.device import DeviceLike, resolve_device

MANIFEST = "manifest.json"
BEST_LINK = "best"
_CKPT_RE = re.compile(r"^ckpt_(\d+)$")


def _leaves_with_path(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(dotted path, leaf) pairs, the JAX package's ``_path_str`` naming."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix or "leaf", tree
        return
    for k, v in items:
        yield from _leaves_with_path(v, f"{prefix}.{k}" if prefix else str(k))


def _rebuild(tree: Any, leaves: Dict[str, Any], prefix: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, f"{prefix}.{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            _rebuild(v, leaves, f"{prefix}.{i}" if prefix else str(i))
            for i, v in enumerate(tree))
    return leaves[prefix or "leaf"]


def _load_leaf(ckpt_dir: str, meta: Dict[str, Any]) -> np.ndarray:
    if meta["kind"] == "sharded":
        arr = np.zeros(meta["global_shape"], dtype=np.dtype(meta["dtype"]))
        for sh in meta["shards"]:
            sl = tuple(slice(a, b) for a, b in sh["index"])
            arr[sl] = np.load(os.path.join(ckpt_dir, sh["file"]))
        return arr
    return np.load(os.path.join(ckpt_dir, meta["file"]))


def restore(ckpt_dir: str, template: Any,
            device: DeviceLike = None) -> Tuple[Any, Dict[str, Any]]:
    """Load a checkpoint into the structure of ``template`` on ``device``
    (default ``cuda``).  Returns (tree, manifest).  Shape mismatches
    against the template raise; leaves take the template's dtype."""
    dev = resolve_device(device)
    with open(os.path.join(ckpt_dir, MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("backend") == "orbax":
        raise NotImplementedError("orbax checkpoints are not supported")
    leaf_meta = manifest["leaves"]

    loaded: Dict[str, Any] = {}
    for path_s, leaf in _leaves_with_path(template):
        if path_s not in leaf_meta:
            raise KeyError(f"checkpoint missing leaf {path_s!r}")
        meta = leaf_meta[path_s]
        if meta["kind"] == "scalar":
            loaded[path_s] = (
                torch.tensor(meta["value"], dtype=leaf.dtype, device=dev)
                if isinstance(leaf, torch.Tensor) else type(leaf)(meta["value"]))
            continue
        arr = _load_leaf(ckpt_dir, meta)
        shape = tuple(leaf.shape)
        if tuple(arr.shape) != shape:
            raise ValueError(
                f"shape mismatch for {path_s}: checkpoint {arr.shape} "
                f"vs template {shape}")
        t = array_to_tensor(arr, dev)
        loaded[path_s] = t.to(leaf.dtype) if isinstance(leaf, torch.Tensor) else t
    return _rebuild(template, loaded), manifest


def find_latest(directory: str) -> Optional[str]:
    """Newest ``ckpt_*`` with a manifest under ``directory``."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        m = _CKPT_RE.match(name)
        if m and os.path.exists(os.path.join(directory, name, MANIFEST)):
            steps.append((int(m.group(1)), name))
    if not steps:
        return None
    return os.path.join(directory, max(steps)[1])


def find_best(directory: str) -> Optional[str]:
    link = os.path.join(directory, BEST_LINK)
    if os.path.islink(link):
        return os.path.join(directory, os.readlink(link))
    return None
