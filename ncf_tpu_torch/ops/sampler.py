"""Weighted negative draws by inverse CDF, with first-non-positive
rejection: kernel B1.

Port of ``ncf_tpu/ops/pallas_sampler.py::tree_sample_negatives``.  For
each slot ``n`` and round ``r`` the draw is ``#{i : cdf[i] <= u[r, n]}``
clipped to ``num_items - 1``; the slot keeps the first round whose draw is
not its row's positive, else the last round's draw.  On a nondecreasing
CDF that count is what the TPU kernel's 128-ary tree descent computes, so
the ids are identical given the same uniforms.

CUDA tensors launch ``csrc/tree_sampler.cu`` or raise; CPU tensors take
``tree_sample_ref``, the plain version, which counts by comparison.  Each
block of the kernel stages only the stretch of the CDF its run of
uniforms falls in: a few dozen entries when the uniforms ascend, as the
stratified sampler's pooled draw gives them, the whole CDF for iid
uniforms.  The TPU's 32768-item gate (a VMEM limit) has no counterpart:
the kernel serves every vocabulary.

The CDF must be nondecreasing, as ``data.sampler.make_sampling_cdf`` (a
sequential sum on the CPU) makes it: the kernel searches it, and where it
decreases a search and the plain version's count may differ, for the
uniforms that ``ordered_for`` marks False.
"""

from __future__ import annotations

import torch

from ncf_tpu_torch.ops import _kernels

_REF_CHUNK_ELEMS = 1 << 26     # compares per chunk of the plain version


def _draws_ref(u: torch.Tensor, cdf: torch.Tensor,
               num_items: int) -> torch.Tensor:
    """``#{i : cdf[i] <= u}`` per element of ``u``, clipped: int32."""
    flat = u.reshape(-1)
    out = torch.empty(flat.shape, dtype=torch.int32, device=u.device)
    step = max(1, _REF_CHUNK_ELEMS // max(1, cdf.shape[0]))
    for s in range(0, flat.shape[0], step):
        cnt = (cdf[None, :] <= flat[s:s + step, None]).sum(dim=1)
        out[s:s + step] = torch.clamp(cnt, 0, num_items - 1).to(torch.int32)
    return out.reshape(u.shape)


def _reject(cands: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """cands [R, N], pos [N] -> the first round's draw that is not the
    positive, else the last round's (the reference's where-chain)."""
    pick = cands[-1]
    for r in range(cands.shape[0] - 2, -1, -1):
        pick = torch.where(cands[r] != pos, cands[r], pick)
    return pick


def tree_sample_ref(u: torch.Tensor, pos: torch.Tensor, cdf: torch.Tensor,
                    num_items: int) -> torch.Tensor:
    """Plain version of the kernel: u f32 [R, N], pos int [N] -> int32
    [N]."""
    return _reject(_draws_ref(u, cdf, num_items), pos.to(torch.int32))


def ordered_for(u: torch.Tensor, cdf: torch.Tensor) -> torch.Tensor:
    """bool of ``u``'s shape: True where ``cdf`` is ordered with respect to
    the uniform (no i < j with ``cdf[i] > u >= cdf[j]``), so that any
    search of it counts ``#{i : cdf[i] <= u}`` as the plain version does.
    A nondecreasing CDF is ordered for every uniform; one summed by a
    parallel scan may fall by an ulp here and there, and is not ordered
    for the uniforms in those gaps."""
    head = torch.cummax(cdf, 0).values[:-1]          # max of cdf[:k]
    tail = torch.flip(torch.cummin(torch.flip(cdf, (0,)), 0).values,
                      (0,))[1:]                      # min of cdf[k:]
    gap = head > tail
    lo, hi = tail[gap], head[gap]
    inside = torch.zeros(u.numel(), dtype=torch.bool, device=u.device)
    for a, b in zip(lo.tolist(), hi.tolist()):       # a few gaps at most
        inside |= (u.reshape(-1) >= a) & (u.reshape(-1) < b)
    return ~inside.reshape(u.shape)


def _tree_sample_cuda(u, pos, cdf, num_items, neg):
    if u.dtype != torch.float32 or cdf.dtype != torch.float32:
        raise TypeError("the sampler kernel takes f32 uniforms and CDF")
    if not (u.device == pos.device == cdf.device):
        raise ValueError("u, pos and cdf must share one device")
    R, N = u.shape
    if N == 0:
        return torch.empty((0,), dtype=torch.int32, device=u.device)
    u = u.contiguous()
    pos = pos.to(torch.int32).contiguous()
    cdf = cdf.contiguous()
    out = torch.empty((N,), dtype=torch.int32, device=u.device)
    with torch.cuda.device(u.device):
        _kernels.launch(
            *C_ENTRY, u.data_ptr(), R, N, pos.data_ptr(), neg, cdf.shape[0],
            cdf.data_ptr(), num_items, out.data_ptr(), _kernels.stream_of(u))
    tree_sample_negatives.launches.add()
    return out


def tree_sample_negatives(u: torch.Tensor, pos_items: torch.Tensor,
                          cdf: torch.Tensor, num_items: int) -> torch.Tensor:
    """Fused draw and reject: u f32 [R, B, NEG] or [R, B*NEG], pos_items
    int [B], cdf f32 nondecreasing -> int32 [B, NEG] (the reference's
    signature, without ``interpret``).  Each kernel launch adds one to
    ``tree_sample_negatives.launches``."""
    if u.dim() == 3:
        R, B, NEG = u.shape
        u = u.reshape(R, B * NEG)
    else:
        B = pos_items.shape[0]
        NEG = u.shape[1] // max(B, 1)
    if pos_items.shape != (B,) or u.shape[1] != B * NEG:
        raise ValueError(f"u {tuple(u.shape)} does not cover pos_items "
                         f"{tuple(pos_items.shape)}")
    if u.device.type == "cpu":
        pos_bn = pos_items.to(torch.int32)[:, None].expand(B, NEG).reshape(-1)
        return tree_sample_ref(u, pos_bn, cdf, num_items).reshape(B, NEG)
    if u.device.type != "cuda":
        raise RuntimeError(f"no sampler kernel for {u.device}")
    return _tree_sample_cuda(u, pos_items, cdf, num_items, NEG).reshape(B, NEG)


tree_sample_negatives.launches = _kernels.LaunchCounter()
# (library, C function, argument codes of ``_kernels.bind``)
C_ENTRY = ("tree_sampler", "ncf_tree_sample", "piipiipipp")
