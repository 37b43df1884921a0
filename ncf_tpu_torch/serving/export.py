"""Embedding export: normalized item/user vectors -> JSONL.

Port of ``ncf_tpu/serving/export.py``: the whole catalog is embedded in
batches on the device (``get_product_embeddings`` /
``get_user_embeddings`` of the configured model), L2-normalized on the
host and written as ``{"id": ..., "embedding": [...]}`` lines, values
rounded to 6 digits.  ``export_interactions_jsonl`` writes the
interaction log as newline JSON.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np
import torch

from ncf_tpu_torch.convert import params_to_device
from ncf_tpu_torch.data.interactions import Interactions
from ncf_tpu_torch.models import get_model
from ncf_tpu_torch.utils.config import Config
from ncf_tpu_torch.utils.device import DeviceLike, resolve_device


def l2_normalize(x: np.ndarray, axis: int = -1) -> np.ndarray:
    """L2 normalization."""
    n = np.linalg.norm(x, axis=axis, keepdims=True)
    return x / np.maximum(n, 1e-12)


def _write_rows(f, vecs: np.ndarray, ids: range, ext_ids) -> None:
    for row, i in zip(vecs, ids):
        f.write(json.dumps({
            "id": str(ext_ids[i]),
            "embedding": [round(float(v), 6) for v in row],
        }) + "\n")


@torch.no_grad()
def export_product_embeddings(
    params,
    cfg: Config,
    out_path: str,
    item_dept: Optional[np.ndarray] = None,
    item_cat: Optional[np.ndarray] = None,
    item_ids: Optional[List] = None,
    which: str = "mlp",          # mlp | mf | category
    batch: int = 8192,
    device: DeviceLike = None,
) -> str:
    """Embed every product and write the JSONL on ``device`` (default
    ``cuda``).  Returns the path."""
    dev = resolve_device(device)
    params = params_to_device(params, dev)
    model = get_model(cfg.model.name)
    I = cfg.model.num_items
    ext_ids = item_ids if item_ids is not None else list(range(I))
    dept = (torch.as_tensor(item_dept, device=dev)
            if item_dept is not None else None)
    cat = (torch.as_tensor(item_cat, device=dev)
           if item_cat is not None else None)

    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        for start in range(0, I, batch):
            stop = min(start + batch, I)
            ids = torch.arange(start, stop, dtype=torch.long, device=dev)
            embs = model.get_product_embeddings(
                params, cfg.model, ids, dept, cat)
            vecs = l2_normalize(
                embs[which].to(torch.float32).cpu().numpy())
            _write_rows(f, vecs, range(start, stop), ext_ids)
    return out_path


@torch.no_grad()
def export_user_embeddings(
    params, cfg: Config, out_path: str,
    user_ids: Optional[List] = None, which: str = "mlp", batch: int = 8192,
    device: DeviceLike = None,
) -> str:
    """Embed every user and write the JSONL on ``device`` (default
    ``cuda``).  Returns the path."""
    dev = resolve_device(device)
    params = params_to_device(params, dev)
    model = get_model(cfg.model.name)
    U = cfg.model.num_users
    ext_ids = user_ids if user_ids is not None else list(range(U))
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        for start in range(0, U, batch):
            stop = min(start + batch, U)
            ids = torch.arange(start, stop, dtype=torch.long, device=dev)
            embs = model.get_user_embeddings(params, ids)
            vecs = l2_normalize(
                embs[which].to(torch.float32).cpu().numpy())
            _write_rows(f, vecs, range(start, stop), ext_ids)
    return out_path


def load_embeddings_jsonl(path: str):
    """Read an embeddings JSONL back into (ids, matrix)."""
    ids, rows = [], []
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            ids.append(rec["id"])
            rows.append(rec["embedding"])
    return ids, np.asarray(rows, np.float32)


def export_interactions_jsonl(inter: Interactions, out_path: str,
                              limit: Optional[int] = None) -> str:
    """Dataset -> newline-JSON export."""
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    n = len(inter) if limit is None else min(limit, len(inter))
    with open(out_path, "w") as f:
        for r in range(n):
            f.write(json.dumps({
                "user_id": int(inter.user_ids[r]),
                "item_id": int(inter.item_ids[r]),
                "timestamp": int(inter.timestamps[r]),
                "amount": float(inter.amounts[r]),
            }) + "\n")
    return out_path
