"""The ``('dcn', 'ici')`` mesh over the process group, the sharding
rules, and the collectives.

Port of ``ncf_tpu/parallel/mesh.py``.  The JAX package declares a mesh of
devices and lets GSPMD place ``NamedSharding``s; the port runs one
process a rank, so a device of the mesh is a rank and a ``P('ici',
None)`` array is each rank holding its own rows.  Rank ``r`` sits at
``(r // ici, r % ici)``, dcn-major, as ``np.array(devices).reshape(dcn,
ici)`` orders devices.  ``Mesh`` holds one group a row of ici ranks (the
table shards) and one a column of dcn ranks (the replicas); without a
process group it is the ``(1, 1)`` mesh, and a step given no mesh runs
over ``local_mesh()``, so one code path runs everywhere.

A spec is a string, so that a tree of specs has the leaves of the tree
it describes: ``SHARDED = "ici"`` for a table's rows split over ici (the
reference's ``P('ici', None)``), ``REPLICATED = ""`` for a leaf every
rank holds whole (``P()``).  The
rules (``param_spec``, ``state_spec``) are the reference's, by leaf name:
a table whose rows divide ici shards, any other leaf is replicated.  A
sharded leaf on rank ``r`` is rows ``[i * R, (i + 1) * R)``, ``i`` the
rank's ici index and ``R`` the rows over ici.

The collectives (``all_reduce``, ``all_gather``, ``all_to_all``) run on
the named axis's group; under gloo a CUDA tensor goes through host
memory (``parallel/multihost.py``).  An axis of one rank is the identity,
except the world's, which runs even on one rank: an ``all_reduce`` over
one rank is a copy, and it shows the backend came up.
"""

from __future__ import annotations

import logging
from typing import Any

import torch

from ncf_tpu_torch.convert import tree_leaves, tree_map
from ncf_tpu_torch.parallel import multihost

log = logging.getLogger(__name__)

DCN_AXIS = "dcn"
ICI_AXIS = "ici"
WORLD = "world"
SHARDED = ICI_AXIS
REPLICATED = ""

# leaf-name substrings of row-shardable tables (the reference's)
EMBEDDING_TABLE_KEYS = (
    "user_emb", "item_emb",
    "mf_user", "mf_item", "mlp_user", "mlp_item",
    "gmf_user", "gmf_item",
)
# optimizer-state-only leaves that shard with their table's rows
EMBEDDING_STATE_KEYS = EMBEDDING_TABLE_KEYS + ("user_acc", "item_acc")


class Mesh:
    """A ``(dcn, ici)`` arrangement of the process group's ranks."""

    def __init__(self, dcn: int = 1, ici: int = 1, local: bool = False):
        self.shape = {DCN_AXIS: int(dcn), ICI_AXIS: int(ici)}
        self.size = int(dcn) * int(ici)
        self.distributed = multihost.is_initialized() and not local
        world = multihost.process_count() if self.distributed else 1
        if self.size != world:
            raise ValueError(f"mesh {dcn}x{ici} needs {self.size} ranks; the "
                             f"process group has {world}")
        self.rank = multihost.process_index() if self.distributed else 0
        self.dcn_index, self.ici_index = divmod(self.rank, int(ici))
        self.backend = multihost.backend() if self.distributed else None
        self.host_staged = self.backend == "gloo"
        # each axis's group by its key in multihost (None: the world's
        # default group); the mesh holds no group handle of its own, so
        # ``multihost.destroy`` can drop them all
        self._groups = {WORLD: None, ICI_AXIS: None, DCN_AXIS: None}
        if self.distributed:
            # every rank creates every group, in the same order
            for d in range(dcn):
                ranks = [d * ici + i for i in range(ici)]
                g = multihost.new_group(ranks) if ici > 1 else None
                if d == self.dcn_index:
                    self._groups[ICI_AXIS] = g
            for i in range(ici):
                ranks = [d * ici + i for d in range(dcn)]
                g = multihost.new_group(ranks) if dcn > 1 else None
                if i == self.ici_index:
                    self._groups[DCN_AXIS] = g

    def __repr__(self) -> str:
        return (f"Mesh(dcn={self.shape[DCN_AXIS]}, ici={self.shape[ICI_AXIS]},"
                f" rank={self.rank}, backend={self.backend})")

    def axis_size(self, axis: str) -> int:
        return self.size if axis == WORLD else self.shape[axis]

    def axis_index(self, axis: str) -> int:
        return {WORLD: self.rank, ICI_AXIS: self.ici_index,
                DCN_AXIS: self.dcn_index}[axis]

    def _live(self, axis: str) -> bool:
        if not self.distributed:
            return False
        return axis == WORLD or self.axis_size(axis) > 1

    def _staged(self, t: torch.Tensor):
        """``t`` where the backend takes it: under gloo a CUDA tensor is
        copied to pinned host memory (from PyTorch's caching host
        allocator: faster both ways than pageable memory)."""
        if self.host_staged and t.is_cuda:
            return self._pinned(t.shape, t.dtype).copy_(t)
        return t

    def _pinned(self, shape, dtype) -> torch.Tensor:
        return torch.empty(tuple(shape), dtype=dtype, pin_memory=True)

    def _out_like(self, src: torch.Tensor, shape) -> torch.Tensor:
        if src.is_pinned():
            return self._pinned(shape, src.dtype)
        return torch.empty(tuple(shape), dtype=src.dtype, device=src.device)

    def all_reduce(self, t: torch.Tensor, axis: str = WORLD) -> torch.Tensor:
        """The sum over ``axis``; returns a tensor on ``t``'s device
        (``t`` itself may be summed in place)."""
        if not self._live(axis):
            return t
        import torch.distributed as dist

        buf = self._staged(t).contiguous()
        dist.all_reduce(buf, group=multihost.group(self._groups[axis]))
        return buf if buf.device == t.device else buf.to(t.device)

    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Every rank's ``t`` along ``axis``, stacked on dim 0 in axis
        order: ``[n * t.shape[0], ...]``."""
        if not self._live(axis) or self.axis_size(axis) == 1:
            return t
        import torch.distributed as dist

        src = self._staged(t).contiguous()
        out = self._out_like(src, (self.axis_size(axis) * src.shape[0],)
                             + tuple(src.shape[1:]))
        # all_gather_single is all_gather_into_tensor's newer name
        gather = getattr(dist, "all_gather_single", None) or \
            dist.all_gather_into_tensor
        gather(out, src, group=multihost.group(self._groups[axis]))
        return out if out.device == t.device else out.to(t.device)

    def all_to_all(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Equal splits of dim 0: block ``e`` goes to the axis's rank
        ``e``; block ``e`` of the result came from rank ``e``."""
        if not self._live(axis) or self.axis_size(axis) == 1:
            return t
        import torch.distributed as dist

        src = self._staged(t).contiguous()
        out = self._out_like(src, src.shape)
        dist.all_to_all_single(out, src,
                               group=multihost.group(self._groups[axis]))
        return out if out.device == t.device else out.to(t.device)

    def barrier(self) -> None:
        if self.distributed:
            import torch.distributed as dist

            dist.barrier()


def local_mesh() -> Mesh:
    """The ``(1, 1)`` mesh of this process alone, in a process group or
    not: what a step runs over when it is given no mesh.  No collective
    runs on it."""
    return Mesh(1, 1, local=True)


def make_mesh(dcn: int = 1, ici: int = -1) -> Mesh:
    """The ``(dcn, ici)`` mesh over every rank of the process group.
    ``ici=-1`` takes the ranks left; ``dcn=-1`` the hosts.  With no
    process group it is ``(1, 1)``."""
    world = multihost.process_count()
    if dcn == -1:
        dcn = multihost.mesh_shape_for_hosts()[0]
    if ici == -1:
        ici = world // dcn
    if dcn * ici != world:
        raise ValueError(f"mesh {dcn}x{ici} needs {dcn * ici} ranks, have "
                         f"{world}")
    return Mesh(dcn, ici)


# ------------------------------------------------------------- the rules

def param_spec(name: str, leaf, mesh: Mesh,
               shard_embeddings: bool = True) -> str:
    """A table's rows split over ici (when they divide it), any other
    leaf replicated.  ``leaf`` has its global shape."""
    ici = mesh.shape[ICI_AXIS]
    if (shard_embeddings and ici > 1 and getattr(leaf, "ndim", 0) == 2
            and any(k in name for k in EMBEDDING_TABLE_KEYS)):
        if leaf.shape[0] % ici == 0:
            return SHARDED
        log.warning("table %s rows=%d not divisible by ici=%d; replicating "
                    "(pad the table with pad_rows())", name, leaf.shape[0],
                    ici)
    return REPLICATED


def state_spec(name: str, leaf, mesh: Mesh,
               shard_embeddings: bool = True) -> str:
    """An optimizer-state leaf naming a table, whose leading axis is the
    table's rows, shards with it (Adam moments and rowwise
    accumulators)."""
    ici = mesh.shape[ICI_AXIS]
    if (shard_embeddings and ici > 1 and getattr(leaf, "ndim", 0) in (1, 2)
            and any(k in name for k in EMBEDDING_STATE_KEYS)
            and leaf.shape[0] % ici == 0):
        return SHARDED
    return REPLICATED


def _specs(tree: Any, rule, mesh, shard_embeddings, prefix: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _specs(v, rule, mesh, shard_embeddings,
                          f"{prefix}.{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            _specs(v, rule, mesh, shard_embeddings,
                   f"{prefix}.{i}" if prefix else str(i))
            for i, v in enumerate(tree))
    return rule(prefix, tree, mesh, shard_embeddings)


def param_shardings(params: Any, mesh: Mesh,
                    shard_embeddings: bool = True) -> Any:
    """The tree of specs for ``params`` (global shapes)."""
    return _specs(params, param_spec, mesh, shard_embeddings)


def state_shardings(state: Any, mesh: Mesh,
                    shard_embeddings: bool = True) -> Any:
    """The tree of specs for an optimizer state (global shapes)."""
    return _specs(state, state_spec, mesh, shard_embeddings)


def batch_sharding(mesh: Mesh) -> str:
    """The batch's leading axis split over every rank, dcn-major (the
    reference's ``P(('dcn', 'ici'))``; see ``local_rows``)."""
    return f"{DCN_AXIS},{ICI_AXIS}"


def replicated(mesh: Mesh) -> str:
    return REPLICATED


def rows_of(mesh: Mesh, num_rows: int, axis: str = ICI_AXIS) -> slice:
    """The slice of ``num_rows`` this rank holds along ``axis``."""
    n = mesh.axis_size(axis)
    if num_rows % n:
        raise ValueError(f"{num_rows} rows must divide {axis}={n}")
    per = num_rows // n
    i = mesh.axis_index(axis)
    return slice(i * per, (i + 1) * per)


def local_rows(x, mesh: Mesh, dim: int = 0):
    """This rank's contiguous slice of a batch split over every rank."""
    sl = rows_of(mesh, x.shape[dim], WORLD)
    return x[sl] if dim == 0 else x[(slice(None),) * dim + (sl,)]


def shard_leaf(x: torch.Tensor, spec: str, mesh: Mesh) -> torch.Tensor:
    """This rank's part of a leaf of global shape under ``spec``."""
    if spec != SHARDED:
        return x
    return x[rows_of(mesh, x.shape[0])].clone()


def shard_pytree(tree: Any, shardings: Any, mesh: Mesh) -> Any:
    """Every leaf cut to this rank's part: a sharded leaf's rows (a
    copy); a replicated leaf is the same tensor."""
    it = iter(tree_leaves(shardings))
    return tree_map(lambda x: shard_leaf(x, next(it), mesh), tree)


def gather_leaf(x: torch.Tensor, spec: str, mesh: Mesh) -> torch.Tensor:
    """The whole leaf from this rank's part (an all_gather over ici)."""
    if spec != SHARDED:
        return x
    return mesh.all_gather(x, ICI_AXIS)


def gather_pytree(tree: Any, shardings: Any, mesh: Mesh) -> Any:
    """Every sharded leaf gathered whole (a collective: every rank calls
    it)."""
    it = iter(tree_leaves(shardings))
    return tree_map(lambda x: gather_leaf(x, next(it), mesh), tree)


def pad_rows(num_rows: int, ici: int) -> int:
    """A row count rounded up so it divides ici (ids beyond the true
    vocabulary are never looked up)."""
    return -(-num_rows // ici) * ici
