"""Pluggable artifact store: push/pull training artifacts to a durable
location.

A copy of ``ncf_tpu/utils/artifacts.py`` over the port's checkpoint
discovery (``ncf_tpu_torch.train.checkpoint``).

Reference analogue: ``save_model_artifacts`` uploads checkpoints +
metadata to GCS ``models/{job_id}/`` after training
(reference: src/train.py:71-107) and task.py uploads the best model
(task.py:146-150).  This environment has no object store and zero
egress, so the shipped backend is a local directory tree with the same
shape (``<root>/<job>/<artifact>``); the scheme dispatch is the seam a
real deployment extends (a ``gs://``/``s3://`` backend is one subclass
away — the trainer/CLI call sites don't change).

URIs: ``file:///abs/path`` or a bare path -> LocalArtifactStore.
Unknown schemes raise with a message naming the seam.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import time
from typing import Dict, List, Optional
from urllib.parse import urlparse

log = logging.getLogger(__name__)


class LocalArtifactStore:
    """Directory-tree artifact store (``file://`` scheme or bare path)."""

    scheme = "file"

    def __init__(self, root: str):
        self.root = root

    def _dest(self, name: str) -> str:
        return os.path.join(self.root, name)

    def push(self, local_path: str, name: Optional[str] = None) -> str:
        """Copy a file or directory into the store; returns the stored
        path.  Directory pushes are atomic-ish (tmp + rename) so a
        concurrent pull never sees a half-written artifact."""
        name = name or os.path.basename(os.path.normpath(local_path))
        dest = self._dest(name)
        os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
        if os.path.isdir(local_path):
            tmp = dest + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            shutil.copytree(local_path, tmp)
            if os.path.exists(dest):
                shutil.rmtree(dest)
            os.replace(tmp, dest)
        else:
            shutil.copy2(local_path, dest)
        log.info("artifact pushed: %s -> %s", local_path, dest)
        return dest

    def pull(self, name: str, local_path: str) -> str:
        src = self._dest(name)
        if os.path.isdir(src):
            if os.path.exists(local_path):
                shutil.rmtree(local_path)
            shutil.copytree(src, local_path)
        else:
            os.makedirs(os.path.dirname(local_path) or ".", exist_ok=True)
            shutil.copy2(src, local_path)
        return local_path

    def list(self, prefix: str = "") -> List[str]:
        base = self._dest(prefix) if prefix else self.root
        if not os.path.isdir(base):
            return []
        out = []
        for dirpath, _dirnames, filenames in os.walk(base):
            rel = os.path.relpath(dirpath, self.root)
            for f in filenames:
                out.append(os.path.normpath(os.path.join(rel, f)))
        return sorted(out)

    def exists(self, name: str) -> bool:
        return os.path.exists(self._dest(name))


def get_store(uri: str):
    """Resolve an artifact-store URI to a backend instance."""
    parsed = urlparse(uri)
    if parsed.scheme in ("", "file"):
        root = parsed.path if parsed.scheme == "file" else uri
        return LocalArtifactStore(root)
    raise ValueError(
        f"no artifact-store backend for scheme {parsed.scheme!r} "
        f"(this environment is egress-free; add a subclass of "
        f"LocalArtifactStore's interface for {parsed.scheme}://)")


def push_training_artifacts(
    uri: str,
    job_name: str,
    checkpoint_dir: Optional[str] = None,
    metrics_file: Optional[str] = None,
    extra: Optional[Dict[str, str]] = None,
) -> List[str]:
    """Push the reference's post-training artifact set (train.py:71-107):
    the best checkpoint, the metrics stream, and a job manifest.  Returns
    the stored paths."""
    from ncf_tpu_torch.train import checkpoint as ckpt_lib

    store = get_store(uri)
    stored: List[str] = []
    manifest: Dict[str, object] = {
        "job": job_name, "pushed_unix": time.time(), "artifacts": []}
    if checkpoint_dir:
        best = (ckpt_lib.find_best(checkpoint_dir)
                or ckpt_lib.find_latest(checkpoint_dir))
        if best:
            stored.append(store.push(
                best, f"{job_name}/checkpoint/{os.path.basename(best)}"))
            manifest["artifacts"].append(
                f"checkpoint/{os.path.basename(best)}")
    if metrics_file and os.path.isfile(metrics_file):
        stored.append(store.push(metrics_file, f"{job_name}/metrics.jsonl"))
        manifest["artifacts"].append("metrics.jsonl")
    for name, path in (extra or {}).items():
        if os.path.exists(path):
            stored.append(store.push(path, f"{job_name}/{name}"))
            manifest["artifacts"].append(name)
    mpath = os.path.join(store.root, job_name, "manifest.json")
    os.makedirs(os.path.dirname(mpath), exist_ok=True)
    with open(mpath, "w") as f:
        json.dump(manifest, f, indent=1)
    stored.append(mpath)
    return stored
