"""Checkpoint save, restore, discovery and retention in the JAX
package's npy manifest format (``ncf_tpu/train/checkpoint.py``): a
directory ``ckpt_{step:08d}`` of ``.npy`` leaves keyed by their tree path
plus ``manifest.json`` (``format_version`` 1; step, epoch, metrics,
config, ``extra``).  Checkpoints move between the packages both ways;
``consolidate`` merges a sharded one into dense leaves for serving.

``restore`` is template-driven (a tree of like leaves, e.g. from
``init(..., device="meta")``) and checks every shape.  ``save`` copies
every leaf to the host before it returns, so the next in-place step
cannot reach a leaf being written.  The optimizer state is written under
optax's names (``named_opt_state``), so that the JAX package's ``Trainer``
reads the port's Adam moments, table-optimizer states and sparse-path
accumulators, and the port reads the reference's.  The
orbax backend is not supported: it is a JAX library.

Under a mesh (``save(..., mesh=, shardings=)``) each rank of dcn replica
0 writes its rows of every row-sharded leaf to a file of its own; after a
barrier the primary rank writes the replicated leaves and the manifest,
whose ``"kind": "sharded"`` entries list each shard's file and its index
ranges in the global shape, as the JAX package's multi-host save does;
a last barrier lets no rank go on before the checkpoint is whole.
``restore(..., mesh=, shardings=)`` reads each rank's rows of a sharded
leaf from whatever layout the checkpoint has (dense, or sharded over
another number of ranks), so a checkpoint moves across topologies, and
``consolidate`` and the JAX package's ``restore`` read it.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ncf_tpu_torch.convert import _to_numpy, array_to_tensor
from ncf_tpu_torch.utils.device import DeviceLike, resolve_device

log = logging.getLogger(__name__)

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


def _leaf_filename(path_s: str) -> str:
    return path_s.replace("/", "_") + ".npy"


def _nest(inner: Dict[str, Any], ewd: float, elr: float) -> Dict[str, Any]:
    """Where the table rule's state sits inside optax's chain of table
    transforms: ``chain(chain(decay, rule), scale)`` puts it at ``0.1``,
    ``chain(decay, rule)`` at ``1``, ``chain(rule, scale)`` at ``0``."""
    if ewd and elr:
        return {"0": {"1": inner}}
    if ewd:
        return {"1": inner}
    if elr:
        return {"0": inner}
    return inner


def named_opt_state(state: Dict[str, Any], clip_norm: float,
                    weight_decay: float, embedding_weight_decay: float = 0.0,
                    embedding_learning_rate: float = 0.0) -> Dict[str, Any]:
    """The port's optimizer state under the leaf names of the reference's
    optax chain (``ncf_tpu/train/optim.py::make_optimizer``): the clip and
    the L2 decay hold no leaves, the Adam or ``multi_transform`` state
    sits at index ``[clip > 0] + [decay > 0]`` and the schedule's count
    one after it.  A ``multi_transform`` state holds Adam's under
    ``inner_states.dense.inner_state`` and the table rule's under
    ``inner_states.embedding.inner_state`` (nested as ``_nest`` says).
    The sparse path's state (``train/step.py::init_sparse_opt_state``:
    an ``*_acc`` accumulator a table) keeps its keys, its dense optimizer's state named the same way
    (that optimizer never clips)."""
    if "item_acc" in state:
        return {"dense": named_opt_state(
                    state["dense"], 0.0, weight_decay,
                    embedding_weight_decay, embedding_learning_rate),
                **{k: v for k, v in state.items() if k.endswith("_acc")},
                "count": state["count"]}
    a = int((clip_norm or 0) > 0) + int((weight_decay or 0) > 0)
    count = state["count"]
    if "dense" not in state:                              # Adam
        inner = {"count": count, "mu": state["mu"], "nu": state["nu"]}
    else:
        emb = dict(state["embedding"])
        if "sum_sq" not in emb:                # the Adam-like table rules
            emb = {"count": count, **emb}
        inner = {"inner_states": {
            "dense": {"inner_state": {"count": count, **state["dense"]}},
            "embedding": {"inner_state": _nest(
                emb, embedding_weight_decay, embedding_learning_rate)}}}
    return {str(a): inner, str(a + 1): {"count": count}}


def opt_state_from_named(named: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of ``named_opt_state``.  The port keeps one count (optax
    advances all of a chain's counts together): Adam's."""
    if "item_acc" in named:
        return {"dense": opt_state_from_named(named["dense"]),
                **{k: v for k, v in named.items() if k.endswith("_acc")},
                "count": named["count"]}
    node = named[min(named, key=int)]
    if "inner_states" not in node:
        return {"count": node["count"], "mu": node["mu"], "nu": node["nu"]}
    dense = node["inner_states"]["dense"]["inner_state"]
    emb = node["inner_states"]["embedding"]["inner_state"]
    while emb and set(emb) <= {"0", "1"}:
        emb = emb["1"] if "1" in emb else emb["0"]
    return {"count": dense["count"],
            "dense": {"mu": dense["mu"], "nu": dense["nu"]},
            "embedding": {k: v for k, v in emb.items() if k != "count"}}


def wait_for_pending() -> None:
    """No-op: the port saves synchronously (the reference waits here for
    its asynchronous orbax saves)."""


def save(
    directory: str,
    tree: Any,
    step: int = 0,
    epoch: int = 0,
    metrics: Optional[Dict[str, float]] = None,
    config: Optional[Dict[str, Any]] = None,
    process_index: Optional[int] = None,
    backend: str = "native",
    async_save: bool = False,
    extra: Optional[Dict[str, Any]] = None,
    mesh=None,
    shardings: Any = None,
) -> str:
    """Write ``tree`` under ``directory/ckpt_{step:08d}``: one ``.npy`` a
    leaf (tensors copied to the host; bf16 widened to f32, which is
    exact; Python numbers as ``scalar`` entries) and the manifest.
    Returns the checkpoint directory.  Under ``mesh``, ``tree`` holds
    this rank's parts and ``shardings`` its spec tree
    (``parallel/mesh.py``); every rank calls ``save``."""
    if backend != "native" or async_save:
        raise NotImplementedError(
            f"checkpoint backend {backend!r} is not supported; use native")
    ranks = mesh is not None and mesh.size > 1
    if process_index is None:
        process_index = mesh.rank if ranks else 0
    ckpt_dir = os.path.join(directory, f"ckpt_{step:08d}")
    os.makedirs(ckpt_dir, exist_ok=True)
    specs = dict(_leaves_with_path(shardings)) if shardings is not None \
        else {}
    leaf_meta: Dict[str, Dict[str, Any]] = {}
    dense = []
    for path_s, leaf in _leaves_with_path(tree):
        if not hasattr(leaf, "shape"):      # a Python number
            leaf_meta[path_s] = {"kind": "scalar", "value": float(leaf)}
            continue
        if ranks and specs.get(path_s) == "ici":
            E, i = mesh.shape["ici"], mesh.ici_index
            R = leaf.shape[0]
            shape = [R * E] + list(leaf.shape[1:])
            if mesh.dcn_index == 0:         # the dcn replicas hold the same
                arr = _to_numpy(leaf)
                np.save(os.path.join(ckpt_dir, _shard_file(path_s, i)), arr)
            dtype = ("float32" if leaf.dtype == torch.bfloat16
                     else str(_np_dtype(leaf.dtype)))
            leaf_meta[path_s] = {
                "kind": "sharded", "global_shape": shape, "dtype": dtype,
                "shards": [{"file": _shard_file(path_s, j),
                            "index": [[j * R, (j + 1) * R]]
                            + [[0, d] for d in shape[1:]]}
                           for j in range(E)]}
            continue
        dense.append((path_s, leaf))
    if ranks:
        mesh.barrier()                      # every shard written
    for path_s, leaf in dense:
        arr = _to_numpy(leaf)
        fname = _leaf_filename(path_s)
        if process_index == 0:
            np.save(os.path.join(ckpt_dir, fname), arr)
        leaf_meta[path_s] = {"kind": "dense", "file": fname,
                             "dtype": str(arr.dtype)}
    manifest = {
        "step": int(step),
        "epoch": int(epoch),
        "metrics": {k: float(v) for k, v in (metrics or {}).items()},
        "config": config or {},
        "extra": extra or {},
        "leaves": leaf_meta,
        "format_version": 1,
    }
    if process_index == 0:
        with open(os.path.join(ckpt_dir, MANIFEST), "w") as f:
            json.dump(manifest, f, indent=1)
    if ranks:
        mesh.barrier()                      # the manifest is written
    log.info("checkpoint saved: %s", ckpt_dir)
    return ckpt_dir


def _shard_file(path_s: str, shard: int) -> str:
    return _leaf_filename(f"{path_s}.shard{shard}")


def _np_dtype(dt: torch.dtype):
    return torch.empty((), dtype=dt).numpy().dtype


def _load_leaf(ckpt_dir: str, meta: Dict[str, Any],
               rows: Optional[slice] = None) -> np.ndarray:
    """A leaf, or only its ``rows``, from a dense or sharded entry (the
    shard files are mapped, so a rank reads the rows it keeps)."""
    if meta["kind"] == "sharded":
        shape = list(meta["global_shape"])
        lo, hi = (0, shape[0]) if rows is None else (rows.start, rows.stop)
        arr = np.zeros([hi - lo] + shape[1:], dtype=np.dtype(meta["dtype"]))
        for sh in meta["shards"]:
            (a, b), rest = sh["index"][0], sh["index"][1:]
            s, e = max(a, lo), min(b, hi)
            if s >= e:
                continue
            part = np.load(os.path.join(ckpt_dir, sh["file"]), mmap_mode="r")
            arr[(slice(s - lo, e - lo),) + tuple(
                slice(x, y) for x, y in rest)] = part[s - a:e - a]
        return arr
    arr = np.load(os.path.join(ckpt_dir, meta["file"]),
                  mmap_mode=None if rows is None else "r")
    if rows is not None:
        arr = np.array(arr[rows])
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        # a bf16 leaf of the JAX package (``.npy`` keeps it as 2-byte
        # voids): its bits are the high half of an f32, widened exactly
        arr = (arr.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return arr


def restore(ckpt_dir: str, template: Any, device: DeviceLike = None,
            mesh=None, shardings: Any = None
            ) -> Tuple[Any, Dict[str, Any]]:
    """Load a checkpoint into the structure of ``template`` on ``device``
    (default ``cuda``).  Returns (tree, manifest).  Shape mismatches
    against the template raise; leaves take the template's dtype.  Under
    ``mesh`` the template holds this rank's parts and ``shardings`` its
    spec tree: a sharded leaf is read as this rank's rows of the global
    leaf, whatever layout the checkpoint has."""
    dev = resolve_device(device)
    with open(os.path.join(ckpt_dir, MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("backend") == "orbax":
        raise NotImplementedError("orbax checkpoints are not supported")
    leaf_meta = manifest["leaves"]
    specs = dict(_leaves_with_path(shardings)) if shardings is not None \
        else {}
    E = 1 if mesh is None else mesh.shape["ici"]

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
        shape = tuple(leaf.shape)
        rows = None
        if E > 1 and specs.get(path_s) == "ici":
            i, R = mesh.ici_index, shape[0]
            rows = slice(i * R, (i + 1) * R)
            glob = meta.get("global_shape") or list(np.load(
                os.path.join(ckpt_dir, meta["file"]), mmap_mode="r").shape)
            if tuple(glob) != (R * E,) + shape[1:]:
                raise ValueError(
                    f"shape mismatch for {path_s}: checkpoint "
                    f"{tuple(glob)} vs template {(R * E,) + shape[1:]}")
        arr = _load_leaf(ckpt_dir, meta, rows)
        if tuple(arr.shape) != shape:
            raise ValueError(
                f"shape mismatch for {path_s}: checkpoint {arr.shape} "
                f"vs template {shape}")
        t = array_to_tensor(arr, dev)
        loaded[path_s] = t.to(leaf.dtype) if isinstance(leaf, torch.Tensor) else t
    return _rebuild(template, loaded), manifest


def consolidate(ckpt_dir: str, out_dir: str) -> str:
    """Merge a checkpoint whose leaves may be split into shard files
    (``"sharded"`` entries: each shard's file and its index ranges in the
    global shape) into one dense ``.npy`` a leaf under ``out_dir``, with
    the manifest rewritten to match (host NumPy; the reference's
    ``checkpoint.consolidate``).  Returns ``out_dir``."""
    with open(os.path.join(ckpt_dir, MANIFEST)) as f:
        manifest = json.load(f)
    os.makedirs(out_dir, exist_ok=True)
    new_meta: Dict[str, Any] = {}
    for path_s, meta in manifest["leaves"].items():
        if meta["kind"] == "scalar":
            new_meta[path_s] = meta
            continue
        arr = _load_leaf(ckpt_dir, meta)
        fname = _leaf_filename(path_s)
        np.save(os.path.join(out_dir, fname), arr)
        new_meta[path_s] = {"kind": "dense", "file": fname,
                            "dtype": str(arr.dtype)}
    manifest["leaves"] = new_meta
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return out_dir


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


def mark_best(directory: str, ckpt_dir: str) -> None:
    """Point ``directory/best`` at the given checkpoint (a relative
    symlink, replaced atomically)."""
    link = os.path.join(directory, BEST_LINK)
    target = os.path.basename(ckpt_dir)
    tmp = link + ".tmp"
    if os.path.islink(tmp) or os.path.exists(tmp):
        os.remove(tmp)
    os.symlink(target, tmp)
    os.replace(tmp, link)


def find_best(directory: str) -> Optional[str]:
    link = os.path.join(directory, BEST_LINK)
    if os.path.islink(link):
        return os.path.join(directory, os.readlink(link))
    return None


def _is_mid_epoch(directory: str, name: str) -> bool:
    try:
        with open(os.path.join(directory, name, MANIFEST)) as f:
            return bool((json.load(f).get("extra") or {}).get("in_epoch"))
    except OSError:
        return False


def garbage_collect(directory: str, keep: int = 3,
                    in_epoch_only: bool = False) -> List[str]:
    """Delete old checkpoints, keeping the newest ``keep`` plus whatever
    ``best`` points at.  ``in_epoch_only=True`` deletes only mid-epoch
    checkpoints (manifest ``extra.in_epoch``), so frequent mid-epoch saves
    never cycle the epoch-boundary ones out."""
    if not os.path.isdir(directory):
        return []
    best = find_best(directory)
    best_name = os.path.basename(best) if best else None
    ckpts = sorted(
        (name for name in os.listdir(directory) if _CKPT_RE.match(name)),
        key=lambda n: int(_CKPT_RE.match(n).group(1)))
    if in_epoch_only:
        ckpts = [n for n in ckpts if _is_mid_epoch(directory, n)]
    removed = []
    for name in ckpts[:-keep] if keep > 0 else []:
        if name == best_name:
            continue
        shutil.rmtree(os.path.join(directory, name), ignore_errors=True)
        removed.append(name)
    return removed
