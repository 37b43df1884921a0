"""HSTU's jagged causal attention: SiLU(QK^T + rab) / N over sequences
packed end to end, with the relative bias built from two small tables.

For a sequence of L positions (rows ``[start, start + L)`` of the packed
``[T, H, D]`` operands) with timestamps ``t``, each head computes

    A[i, j] = SiLU(q_i . k_j + rab[i, j]) / N    for j <= i, else 0
    rab[i, j] = w_pos[N - 1 + j - i] + w_ts[b(t_{i+1} - t_j)]
    b(x) = clamp(floor(ln(max(|x|, 1)) / 0.301), 0, 128),  t_L := t_{L-1}
    out_i = sum_j A[i, j] v_j

(Zhai et al., ICML 2024, arXiv:2402.17152; N is the configuration's
``max_sequence_length``).  The bias is shared by a block's heads.  The
operands of both products are rounded to bf16 and the products
accumulate in f32, as ``compute_dtype: bfloat16`` states; A is rounded
to bf16 before its product with v.

CUDA tensors launch ``csrc/hstu_attention.cu`` (one forward kernel, and
for the backward two kernels and a two-stage reduce of the bias tables'
gradients, without atomics: two runs agree bit for bit).  The launch
plan (``Plan``) lists the 64-row tiles of every sequence, made on the
host from the batch's offsets once a step: no block is spent on a tile
above the diagonal or past a sequence's end.  CPU tensors take the
plain version, ``hstu_attention_ref``, one sequence at a time.

While a profiler records, each forward adds the plan's causal pairs of
real positions times heads to ``hstu_attention.pairs_useful`` and the
score entries its tiles compute (padding and masked entries included)
to ``hstu_attention.pairs_computed`` (``ops/__init__.py``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ncf_tpu_torch.ops import _kernels
from ncf_tpu_torch.utils.profiling import RecordedCount, recording

TILE = 64                 # csrc/hstu_attention.cu's kRows
MAX_DIM = 32              # its kDim: the head width, padded
BUCKETS = 129             # w_ts's entries
BUCKET_WIDTH = 0.301      # the log buckets' width, in ln(seconds)
GROUP = 64                # its reduce's kGroup


def ts_bucket(dt: torch.Tensor) -> torch.Tensor:
    """int64 bucket of each time gap (int64 seconds)."""
    x = dt.abs().clamp(min=1).to(torch.float32)
    return torch.floor(torch.log(x) / BUCKET_WIDTH).clamp(
        0, BUCKETS - 1).long()


def relative_bias(w_pos: torch.Tensor, w_ts: torch.Tensor,
                  ts: torch.Tensor, N: int) -> torch.Tensor:
    """rab [L, L] of one sequence with timestamps ``ts`` [L]."""
    L = ts.shape[0]
    pos = torch.arange(L, device=ts.device)
    nxt = ts[torch.clamp(pos + 1, max=L - 1)]
    b = ts_bucket(nxt[:, None] - ts[None, :])
    return w_pos[N - 1 + pos[None, :] - pos[:, None]] + w_ts[b]


def host_to_device(a: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device`` without waiting for the card: through
    pinned memory, whose buffer the caching host allocator keeps until
    the copy has run."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def hstu_attention_ref(q, k, v, w_pos, w_ts, ts, offsets: Sequence[int],
                       N: int) -> torch.Tensor:
    """Plain version: f32 [T, H, D] from q, k, v f32 [T, H, D], one
    sequence (``offsets[s]:offsets[s + 1]``) at a time."""
    out = []
    for a, b in zip(offsets[:-1], offsets[1:]):
        a, b = int(a), int(b)
        L = b - a
        s = torch.einsum("ihd,jhd->hij", _bf16(q[a:b]), _bf16(k[a:b]))
        z = s + relative_bias(w_pos, w_ts, ts[a:b], N)
        causal = torch.ones((L, L), dtype=torch.bool,
                            device=q.device).tril()
        attn = torch.where(causal, F.silu(z) / N, torch.zeros_like(z))
        out.append(torch.einsum("hij,jhd->ihd", _bf16(attn), _bf16(v[a:b])))
    return torch.cat(out) if out else q.new_zeros(q.shape)


class Plan:
    """A batch's launch plan: the sequences' offsets (host), and the
    int32 ``[n, 3]`` tables of (start, L, tile) of every 64-row tile, the
    query order longest work first (tile t sees t + 1 key tiles) and the
    key order likewise (key tile t sees the sequence's tiles from t on),
    on the device."""

    def __init__(self, offsets, device):
        off = np.asarray(offsets, dtype=np.int64).reshape(-1)
        if off.size < 1 or off[0] != 0 or np.any(np.diff(off) < 1):
            raise ValueError("offsets must start at 0 and rise")
        self.offsets = off
        lens = np.diff(off)
        self.max_len = int(lens.max()) if lens.size else 0
        tiles = -(-lens // TILE)
        seq = np.repeat(np.arange(lens.size), tiles)
        t = (np.arange(tiles.sum()) - np.repeat(np.cumsum(tiles) - tiles,
                                                tiles))
        table = np.stack([off[:-1][seq], lens[seq], t], 1).astype(np.int32)
        q_order = np.lexsort((seq, -t))
        k_order = np.lexsort((seq, -(tiles[seq] - t)))
        self.n_tiles = int(table.shape[0])
        self.pairs_useful = int((lens * (lens + 1) // 2).sum())
        self.tile_pairs = int((tiles * (tiles + 1) // 2).sum())
        self.device = torch.device(device)
        self.q_tiles = self.k_tiles = None
        if self.device.type == "cuda":
            self.q_tiles = host_to_device(table[q_order], self.device)
            self.k_tiles = host_to_device(table[k_order], self.device)

    @property
    def num_positions(self) -> int:
        return int(self.offsets[-1])

    def scratch_floats(self, N: int) -> int:
        n = self.n_tiles
        return n * N + n * BUCKETS + 2 * N * (-(-n // GROUP))


def _check(q, k, v, w_pos, w_ts, ts, plan: Plan, N: int) -> None:
    T, H, D = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must match")
    if T != plan.num_positions or ts.shape != (T,):
        raise ValueError(f"{T} positions, timestamps {tuple(ts.shape)}, "
                         f"the plan {plan.num_positions}")
    if w_pos.shape != (2 * N - 1,) or w_ts.shape != (BUCKETS,):
        raise ValueError(f"w_pos {tuple(w_pos.shape)} and w_ts "
                         f"{tuple(w_ts.shape)} for N {N}")
    if plan.max_len > N:
        raise ValueError(f"a sequence of {plan.max_len} positions exceeds "
                         f"N {N}")


def _operand(x: torch.Tensor):
    """(x, its row stride in floats) with rows of H * D contiguous floats
    at a common stride (a column slice of a wider row passes as is)."""
    x = x.to(torch.float32)
    T, H, D = x.shape
    if x.stride(2) != 1 or x.stride(1) != D or x.stride(0) < H * D:
        x = x.contiguous()
    return x, x.stride(0)


def _forward_cuda(q, k, v, w_pos, w_ts, ts, plan: Plan, N: int):
    T, H, D = q.shape
    if D > MAX_DIM:
        raise ValueError(f"head width {D} exceeds {MAX_DIM}")
    (q, ld), (k, ldk), (v, ldv) = _operand(q), _operand(k), _operand(v)
    if not ld == ldk == ldv:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        ld = q.stride(0)
    out = torch.empty((T, H, D), dtype=torch.float32, device=q.device)
    with _kernels.on_device(q.device):
        _kernels.launch(
            *C_FWD, plan.q_tiles.data_ptr(), plan.n_tiles, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), ld, ts.data_ptr(),
            w_pos.contiguous().data_ptr(), w_ts.contiguous().data_ptr(),
            H, D, N, out.data_ptr(), _kernels.stream_of(q))
    hstu_attention.fwd_launches.add()
    return out, (q, k, v, ld)


def _backward_cuda(ops, dout, w_pos, w_ts, ts, plan: Plan, N: int):
    q, k, v, ld = ops
    T, H, D = q.shape
    dout = dout.to(torch.float32).contiguous()
    dq = torch.empty((T, H, D), dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(dq), torch.empty_like(dq)
    need = plan.scratch_floats(N)
    scratch = torch.empty(need, dtype=torch.float32, device=q.device)
    dw_pos = torch.zeros_like(w_pos, dtype=torch.float32)
    dw_ts = torch.empty_like(w_ts, dtype=torch.float32)
    with _kernels.on_device(q.device):
        _kernels.launch(
            *C_BWD, plan.q_tiles.data_ptr(), plan.k_tiles.data_ptr(),
            plan.n_tiles, q.data_ptr(), k.data_ptr(), v.data_ptr(), ld,
            dout.data_ptr(), ts.data_ptr(), w_pos.contiguous().data_ptr(),
            w_ts.contiguous().data_ptr(), H, D, N, dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(), need,
            dw_pos.data_ptr(), dw_ts.data_ptr(), _kernels.stream_of(q))
    hstu_attention.bwd_launches.add()
    return dq, dk, dv, dw_pos, dw_ts


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, w_pos, w_ts, ts, plan, N):
        out, ops = _forward_cuda(q, k, v, w_pos, w_ts, ts, plan, N)
        ctx.save_for_backward(*ops[:3], w_pos, w_ts, ts)
        ctx.ld, ctx.plan, ctx.N = ops[3], plan, N
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, w_pos, w_ts, ts = ctx.saved_tensors
        dq, dk, dv, dw_pos, dw_ts = _backward_cuda(
            (q, k, v, ctx.ld), g, w_pos, w_ts, ts, ctx.plan, ctx.N)
        return dq, dk, dv, dw_pos, dw_ts, None, None, None


def hstu_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w_pos: torch.Tensor, w_ts: torch.Tensor,
                   ts: torch.Tensor, plan: Plan, N: int) -> torch.Tensor:
    """f32 [T, H, D] attention outputs of q, k, v f32 [T, H, D] (views of
    one wider row pass without a copy), the bias tables w_pos f32
    [2N - 1] and w_ts f32 [129], and timestamps int64 [T] (seconds, not
    decreasing within a sequence), over the sequences of ``plan``.
    Each launch adds one to ``hstu_attention.fwd_launches`` or, for a
    backward, ``.bwd_launches``."""
    _check(q, k, v, w_pos, w_ts, ts, plan, N)
    if recording():
        H = q.shape[1]
        hstu_attention.pairs_useful.add(plan.pairs_useful * H)
        hstu_attention.pairs_computed.add(plan.tile_pairs * TILE * TILE * H)
    if q.device.type == "cpu":
        return hstu_attention_ref(q, k, v, w_pos, w_ts, ts, plan.offsets, N)
    if q.device.type != "cuda":
        raise RuntimeError(f"no HSTU attention kernel for {q.device}")
    return _Attention.apply(q, k, v, w_pos, w_ts, ts.contiguous(), plan, N)


hstu_attention.fwd_launches = _kernels.LaunchCounter()
hstu_attention.bwd_launches = _kernels.LaunchCounter()
hstu_attention.pairs_useful = RecordedCount()
hstu_attention.pairs_computed = RecordedCount()
# (library, C function, argument codes of ``_kernels.bind``)
C_FWD = ("hstu_attention", "ncf_hstu_attn_fwd", "pippplpppiiipp")
C_BWD = ("hstu_attention", "ncf_hstu_attn_bwd", "ppippplppppiiipppplppp")
