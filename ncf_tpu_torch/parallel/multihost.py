"""Process-group start-up, barriers, batch slicing and the rank launcher.

Port of ``ncf_tpu/parallel/multihost.py``.  The JAX package runs one
controller a host (``jax.distributed.initialize``) over a mesh of
devices; the port runs one process a rank (``torch.distributed``), and a
rank is what a device of the mesh was.  ``initialize_distributed`` reads
torchrun's ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``,
``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``, or takes them as arguments with
an ``init_method``; for one process it does nothing.

The backend follows one rule (``choose_backend``): ``nccl`` when every
rank on a host has a card of its own, ``gloo`` when ranks share a card
(NCCL refuses two ranks on one device) or run on the CPU.  Under gloo
every collective on a CUDA tensor is staged through host memory by the
mesh's helpers (``parallel/mesh.py``): the kernels stay on the card, the
exchange of their inputs and outputs does not.  Each rank prints its
backend, its device and the rule once.

``run_ranks`` starts N ranks of a module's entry point as fresh
processes (never forked), each with its rank, the world size and a
``file://`` store, and kills the rest when one fails or the time runs
out.
"""

from __future__ import annotations

import datetime
import logging
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

log = logging.getLogger(__name__)


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() else None


def is_initialized() -> bool:
    d = _dist()
    return d is not None and d.is_initialized()


def process_index() -> int:
    return _dist().get_rank() if is_initialized() else 0


def process_count() -> int:
    return _dist().get_world_size() if is_initialized() else 1


def choose_backend(device_type: str, local_world_size: int,
                   cards: int) -> Tuple[str, str]:
    """(backend, the rule's reason) for ranks on ``device_type``."""
    if device_type == "cuda" and local_world_size <= cards:
        return "nccl", (f"nccl: each of the {local_world_size} ranks on this "
                        f"host has its own card ({cards} visible)")
    if device_type == "cuda":
        return "gloo", (f"gloo: {local_world_size} ranks share {cards} "
                        "card(s) (NCCL refuses two ranks on one device); "
                        "collectives are staged through host memory")
    return "gloo", "gloo: the ranks run on the CPU"


def rank_device(device=None) -> torch.device:
    """The device a rank works on: ``cuda`` means the card
    ``LOCAL_RANK mod cards``; anything else is taken as it is.  Raises
    without a card unless the caller asks for the CPU."""
    from ncf_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = _int_env("LOCAL_RANK")
        if local is None:
            local = process_index()
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def initialize_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device=None,
    timeout_s: float = 300.0,
) -> Tuple[int, int]:
    """Join the process group when several ranks run; returns (rank,
    world size).  Arguments default to torchrun's environment; one
    process is a no-op.  ``device`` (default ``cuda``) picks the backend
    by ``choose_backend``; ``timeout_s`` bounds every collective, so a
    rank left waiting fails instead of hanging."""
    d = _dist()
    if d is not None and d.is_initialized():
        return d.get_rank(), d.get_world_size()
    world = world_size or _int_env("WORLD_SIZE") or 1
    r = rank if rank is not None else (_int_env("RANK") or 0)
    if world <= 1 and init_method is None:
        return 0, 1
    if d is None:
        raise RuntimeError("torch.distributed is not available")
    os.environ.setdefault("LOCAL_RANK", str(r))
    os.environ.setdefault("LOCAL_WORLD_SIZE", str(world))
    dev = rank_device(device)
    local_world = _int_env("LOCAL_WORLD_SIZE") or world
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    name, rule = choose_backend(dev.type, local_world, cards)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    d.init_process_group(
        name, init_method=init_method or "env://", world_size=world, rank=r,
        timeout=datetime.timedelta(seconds=timeout_s))
    # one write: under unbuffered output ``print`` writes the text and the
    # newline apart, and ranks that share a pipe (``torch.distributed.run``
    # hands its own on) then run two ranks' lines into one
    sys.stdout.write(f"[rank {r}/{world}] backend {name} on {dev}: {rule}\n")
    sys.stdout.flush()
    return r, world


def backend() -> Optional[str]:
    """The process group's backend, or None without one."""
    return _dist().get_backend() if is_initialized() else None


def is_primary() -> bool:
    return process_index() == 0


def sync_hosts(tag: str = "barrier") -> None:
    """A barrier over every rank (a no-op for one process)."""
    del tag
    if process_count() > 1:
        _dist().barrier()


def local_batch_slice(global_batch_size: int) -> Tuple[int, int]:
    """(start, size) of this rank's contiguous slice of the global batch."""
    n = process_count()
    if global_batch_size % n != 0:
        raise ValueError(
            f"global batch {global_batch_size} must divide process count {n}")
    size = global_batch_size // n
    return process_index() * size, size


def mesh_shape_for_hosts(devices_per_host: Optional[int] = None
                         ) -> Tuple[int, int]:
    """(dcn, ici) = (hosts, ranks a host): data-parallel across hosts,
    table shards across the ranks of a host."""
    world = process_count()
    per_host = devices_per_host or _int_env("LOCAL_WORLD_SIZE") or world
    return max(1, world // per_host), per_host


# the process groups ``new_group`` made, by their ranks: the one place a
# handle to a group lives outside torch.distributed (see ``destroy``)
_GROUPS: Dict[Tuple[int, ...], object] = {}


def new_group(ranks: Sequence[int]) -> Tuple[int, ...]:
    """Make the process group of ``ranks`` (every rank of the world calls
    this, in the same order) and return its key for ``group``."""
    key = tuple(int(r) for r in ranks)
    _GROUPS[key] = _dist().new_group(list(key))
    return key


def group(key: Optional[Tuple[int, ...]]):
    """The process group ``new_group`` returned ``key`` for; ``None`` is
    the world (torch.distributed's default group)."""
    if key is None:
        return None
    try:
        return _GROUPS[key]
    except KeyError:
        raise RuntimeError(f"no process group of ranks {key}: it was "
                           "destroyed, or never made") from None


def destroy() -> None:
    """Drop every group handle, then destroy the process group.  The
    handles go first so that gloo's groups are torn down here, inside
    ``destroy_process_group``: a handle that outlives it is destroyed at
    interpreter exit, where gloo's teardown now and then aborts the
    process (``terminate called without an active exception``, exit
    -6)."""
    _GROUPS.clear()
    if is_initialized():
        _dist().destroy_process_group()


# ------------------------------------------------------------- launcher

def run_ranks(module: str, world: int, argv: Sequence[str] = (),
              store: Optional[str] = None, timeout: float = 300.0,
              threads: int = 1, capture: bool = False,
              local_world: Optional[int] = None) -> List[str]:
    """Run ``python -m module --rank r --world N --store S *argv`` for
    every rank, each a fresh interpreter.  When one rank exits non-zero
    or ``timeout`` passes, the others are killed and RuntimeError is
    raised with every rank's output.  Returns each rank's output when
    ``capture`` (else the ranks write to this process's streams).
    ``local_world`` ranks make a host (default: all of them), as
    ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` tell each rank."""
    local_world = local_world or world
    import tempfile

    own = store is None
    if own:
        fd, store = tempfile.mkstemp(prefix="ncf_store_")
        os.close(fd)
        os.remove(store)
    base = dict(os.environ)
    base["OMP_NUM_THREADS"] = str(threads)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    base["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in base.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    outs = []
    procs = []
    try:
        for r in range(world):
            cmd = [sys.executable, "-m", module, "--rank", str(r),
                   "--world", str(world), "--store", store, *argv]
            e = dict(base, LOCAL_RANK=str(r % local_world),
                     LOCAL_WORLD_SIZE=str(local_world))
            out = (tempfile.TemporaryFile(mode="w+") if capture else None)
            outs.append(out)
            procs.append(subprocess.Popen(
                cmd, env=e, stdout=out, stderr=subprocess.STDOUT
                if capture else None, text=True))
        deadline = time.monotonic() + timeout
        failed = None
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
                break
            if time.monotonic() > deadline:
                failed = f"the ranks did not finish in {timeout:.0f} s"
                break
            time.sleep(0.05)
        if failed is None:
            bad = [r for r, p in enumerate(procs) if p.returncode != 0]
            if bad:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        texts = []
        for out in outs:
            if out is None:
                texts.append("")
                continue
            out.seek(0)
            texts.append(out.read())
            out.close()
        if failed is not None:
            detail = "".join(f"\n--- rank {r} ---\n{t}"
                             for r, t in enumerate(texts))
            raise RuntimeError(f"{module}: {failed}{detail}")
        return texts
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        if own and os.path.exists(store):
            os.remove(store)


def rank_args(argv: Optional[Sequence[str]] = None):
    """Parse the ``--rank --world --store`` arguments ``run_ranks`` gives
    and return (rank, world, store, the rest)."""
    import argparse

    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--store", required=True)
    ns, rest = ap.parse_known_args(argv)
    return ns.rank, ns.world, ns.store, rest
