"""Fused MLP tower: kernels B4f (forward) and B4b (backward).

Port of ``ncf_tpu/ops/pallas_tower.py::fused_tower``: the whole
[Linear -> ReLU -> LayerNorm -> Dropout] stack of ``models/layers.py::
mlp_tower`` in one kernel per direction.  Per layer, on rows of ``x``
flattened to ``[n, D0]``:

    z = relu(bf16(h) @ bf16(W) + b)          (f32 products and sums)
    y = (z - mean) * rsqrt(var + 1e-5) * g + be
    y = keep ? y * (1 / keep_rate) : 0

with ``h = bf16(y)`` between layers and the last ``y`` returned in f32.
The backward recomputes the forward and runs in f32 with the f32 weights;
``dx`` comes back in bf16 and is then cast to ``x``'s dtype, as the
reference's custom VJP gives it.

Dropout masks come from Philox4x32-10 (``philox4x32``) with key
``(seed, layer)`` and counter ``(row, col // 4, 0, 0)``; element
``(row, col)`` takes word ``col % 4`` and is kept iff it is below
``min(int(keep * 2**32), 2**32 - 1)``.  The seed is one int32 drawn from
the caller's ``torch.Generator`` (the reference draws it from its key), so
the kernel and ``fused_tower_ref`` agree mask for mask; neither agrees
with the TPU's own generator.

``fused_tower`` launches ``csrc/fused_tower.cu`` for CUDA tensors (or
raises) and runs the plain version for CPU tensors; ``fused_tower_ref``
always runs the plain version, on any device.  The kernels run their
products on the tensor cores: the forward's bf16 products exactly, the
backward's f32 products as split TF32 (within a few 2^-22 of each
product), so they agree with the plain version up to the order and
rounding of f32 sums.  They read the parameters where they lie (f32,
contiguous: no packed copy) and sum the weight gradients in a fixed
order.  ``tower_fits`` is a copy
of the reference's routing rule, kept so that both packages route the
same shapes; the kernels themselves take any depth up to 16 and widths up
to 512.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

from ncf_tpu_torch.ops import _kernels

_ROW_TILE = 1024
_LANE = 128
_EPS = 1e-5
MAX_LAYERS = 16
MAX_WIDTH = 512

# (library, C function, argument codes of ``_kernels.bind``)
C_FWD = ("fused_tower", "ncf_tower_fwd", "pppiipilfpp")
C_BWD = ("fused_tower", "ncf_tower_bwd", "ppppiipilfipppp")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def tower_fits(layers: List[dict], in_dim: int) -> bool:
    """The reference's routing guard: every width lane-padded <= 512 and
    its TPU working set under 12 MB (copied with its TPU constants)."""
    real = [in_dim] + [int(l["dense"]["w"].shape[1]) for l in layers]
    pad = [_round_up(d, _LANE) for d in real]
    if any(p > 512 for p in pad):
        return False
    weight_bytes = sum(pad[i] * pad[i + 1] * 4 for i in range(len(layers)))
    act_bytes = _ROW_TILE * max(pad) * 4 * (len(layers) + 2)
    return weight_bytes + 2 * act_bytes < 12 * 1024 * 1024


# ------------------------------------------------------------- Philox

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit halves of ``a * b`` for a 32-bit constant ``a`` and
    int64 ``b`` holding 32-bit values, without leaving int64: ``a`` is
    split into 16-bit halves so every partial product stays below 2**49."""
    x = b * (a >> 16)
    y = b * (a & 0xFFFF)
    s = x + (y >> 16)
    return s >> 16, ((s & 0xFFFF) << 16) | (y & 0xFFFF)


def philox4x32(counter: Sequence[torch.Tensor], key: Sequence[torch.Tensor],
               rounds: int = 10):
    """Philox4x32-``rounds`` (Salmon et al., SC'11) on int64 tensors holding
    unsigned 32-bit values: four counter words and two key words, which
    broadcast together.  Returns the four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(rounds):
        if r:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def dropout_bits(seed: torch.Tensor, layer: int, rows: int,
                 cols: int) -> torch.Tensor:
    """The kernel's random words for a ``[rows, cols]`` activation of
    ``layer``: int64 ``[rows, cols]`` in ``[0, 2**32)``."""
    dev = seed.device
    r = torch.arange(rows, dtype=torch.int64, device=dev)[:, None]
    q = torch.arange(-(-cols // 4), dtype=torch.int64, device=dev)[None, :]
    r, q = torch.broadcast_tensors(r, q)
    zero = torch.zeros_like(r)
    k0 = seed.reshape(()).to(torch.int64) & _MASK32
    k1 = torch.full((), layer, dtype=torch.int64, device=dev)
    words = philox4x32((r, q, zero, zero), (k0, k1))
    return torch.stack(words, dim=-1).reshape(rows, -1)[:, :cols]


def keep_threshold(rate: float) -> int:
    """A word below this keeps its element (``pallas_tower.py:86``)."""
    return min(int((1.0 - rate) * 2.0 ** 32), 2 ** 32 - 1)


# ------------------------------------------------------- plain version

def _layers(flat):
    return [tuple(p.to(torch.float32) for p in flat[i:i + 4])
            for i in range(0, len(flat), 4)]


def _layer_fwd(h, w, b, g, be, layer, seed, rate):
    """One layer on f32 ``h`` holding bf16 values: (y, z, mean, rstd,
    keep mask or None)."""
    z = torch.relu(torch.matmul(h, w.to(torch.bfloat16).to(torch.float32))
                   + b)
    n = z.shape[1]
    mean = z.sum(dim=1, keepdim=True) / n
    xm = z - mean
    var = (xm * xm).sum(dim=1, keepdim=True) / n
    rstd = torch.rsqrt(var + _EPS)
    y = xm * rstd * g + be
    mask = None
    if rate > 0.0:
        mask = dropout_bits(seed, layer, z.shape[0], n) < keep_threshold(rate)
        y = torch.where(mask, y * (1.0 / (1.0 - rate)), torch.zeros_like(y))
    return y, z, mean, rstd, mask


def _fwd_ref(x2, seed, flat, rate):
    h = x2.to(torch.bfloat16).to(torch.float32)
    layers = _layers(flat)
    for i, (w, b, g, be) in enumerate(layers):
        y, *_ = _layer_fwd(h, w, b, g, be, i, seed, rate)
        h = y if i + 1 == len(layers) else y.to(torch.bfloat16).to(
            torch.float32)
    return h


def _bwd_ref(x2, dy, seed, flat, rate):
    h = x2.to(torch.bfloat16).to(torch.float32)
    layers = _layers(flat)
    h_ins, res = [], []
    for i, (w, b, g, be) in enumerate(layers):
        h_ins.append(h)
        y, z, mean, rstd, mask = _layer_fwd(h, w, b, g, be, i, seed, rate)
        res.append((z, mean, rstd, mask))
        h = y.to(torch.bfloat16).to(torch.float32)
    dh = dy.to(torch.float32)
    grads = [None] * len(flat)
    for i in range(len(layers) - 1, -1, -1):
        w, _, g, _ = layers[i]
        z, mean, rstd, mask = res[i]
        if mask is not None:
            dh = torch.where(mask, dh * (1.0 / (1.0 - rate)),
                             torch.zeros_like(dh))
        n = z.shape[1]
        xhat = (z - mean) * rstd
        dxhat = dh * g
        m1 = dxhat.sum(dim=1, keepdim=True) / n
        m2 = (dxhat * xhat).sum(dim=1, keepdim=True) / n
        dz = rstd * (dxhat - m1 - xhat * m2)
        dz = torch.where(z > 0.0, dz, torch.zeros_like(dz))
        grads[4 * i:4 * i + 4] = [h_ins[i].T @ dz, dz.sum(0),
                                  (dh * xhat).sum(0), dh.sum(0)]
        dh = dz @ w.T
    return dh.to(torch.bfloat16), grads


# -------------------------------------------------------------- kernels

def _dims(x2, flat) -> List[int]:
    return [int(x2.shape[1])] + [int(w.shape[1]) for w in flat[0::4]]


def _check_cuda(x2, flat, dims):
    if x2.dtype != torch.bfloat16:
        raise TypeError(f"the tower kernels take bf16 rows, got {x2.dtype}")
    if any(p.device != x2.device for p in flat):
        raise ValueError("the tower's params and x must share one device")
    if not 1 <= len(flat) // 4 <= MAX_LAYERS or len(flat) % 4:
        raise ValueError(f"the tower kernels take 1 to {MAX_LAYERS} layers")
    if any(not 1 <= d <= MAX_WIDTH for d in dims):
        raise ValueError(f"the tower kernels take widths 1..{MAX_WIDTH}, "
                         f"got {dims}")
    if x2.shape[0] < 1:
        raise ValueError("the tower kernels take at least one row")


def _leaves(flat):
    """The leaves as f32 contiguous tensors (the model's already are, so
    nothing is copied) and a host array of their device addresses in
    packing order (W, b, g, be per layer), which the kernels read."""
    leaves = [p if p.dtype == torch.float32 and p.is_contiguous()
              else p.to(torch.float32).contiguous() for p in flat]
    ptrs = (ctypes.c_void_p * len(leaves))(*[p.data_ptr() for p in leaves])
    return leaves, ptrs


def _c_dims(dims):
    return (ctypes.c_int * len(dims))(*dims)


def _keep_args(rate):
    if rate > 0.0:
        return 1, keep_threshold(rate), 1.0 / (1.0 - rate)
    return 0, 0, 1.0


def _fwd_cuda(x2, seed, flat, rate):
    dims = _dims(x2, flat)
    _check_cuda(x2, flat, dims)
    x2 = x2.contiguous()
    leaves, ptrs = _leaves(flat)
    out = torch.empty((x2.shape[0], dims[-1]), dtype=torch.float32,
                      device=x2.device)
    use, thr, inv = _keep_args(rate)
    cdims = _c_dims(dims)
    with torch.cuda.device(x2.device):
        _kernels.launch(*C_FWD, x2.data_ptr(), ctypes.addressof(ptrs),
                        ctypes.addressof(cdims), len(dims) - 1, x2.shape[0],
                        seed.data_ptr(), use, thr, inv, out.data_ptr(),
                        _kernels.stream_of(x2))
    fused_tower.fwd_launches.add()
    return out


def _bwd_cuda(x2, dy, seed, flat, rate):
    dims = _dims(x2, flat)
    _check_cuda(x2, flat, dims)
    x2 = x2.contiguous()
    dy = dy.to(torch.float32).contiguous()
    leaves, ptrs = _leaves(flat)
    rows = x2.shape[0]
    n_params = sum(p.numel() for p in leaves)
    # one f32 slice of the parameter gradients per resident block: the
    # kernel keeps at most one block a multiprocessor, tiles of >= 16 rows
    sms = torch.cuda.get_device_properties(x2.device).multi_processor_count
    max_blocks = max(1, min(-(-rows // 16), sms))
    scratch = torch.empty(max_blocks * n_params, dtype=torch.float32,
                          device=x2.device)
    grads = torch.empty(n_params, dtype=torch.float32, device=x2.device)
    dx = torch.empty((rows, dims[0]), dtype=torch.bfloat16, device=x2.device)
    use, thr, inv = _keep_args(rate)
    cdims = _c_dims(dims)
    with torch.cuda.device(x2.device):
        _kernels.launch(*C_BWD, x2.data_ptr(), dy.data_ptr(),
                        ctypes.addressof(ptrs), ctypes.addressof(cdims),
                        len(dims) - 1, rows, seed.data_ptr(), use, thr, inv,
                        max_blocks, scratch.data_ptr(), grads.data_ptr(),
                        dx.data_ptr(), _kernels.stream_of(x2))
    fused_tower.bwd_launches.add()
    out, off = [], 0
    for p in flat:
        out.append(grads[off:off + p.numel()].view(p.shape))
        off += p.numel()
    return dx, out


# -------------------------------------------------------------- autograd

class _Tower(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, seed, kernel, rate, *flat):
        ctx.kernel, ctx.rate = kernel, rate
        ctx.save_for_backward(x2, seed, *flat)
        return (_fwd_cuda if kernel else _fwd_ref)(x2, seed, flat, rate)

    @staticmethod
    def backward(ctx, dy):
        x2, seed, *flat = ctx.saved_tensors
        fn = _bwd_cuda if ctx.kernel else _bwd_ref
        dx, grads = fn(x2, dy, seed, flat, ctx.rate)
        return (dx.to(x2.dtype), None, None, None,
                *(g.to(p.dtype) for g, p in zip(grads, flat)))


def _run(layers, x, dropout_rate, rng, deterministic, kernel):
    use_dropout = (not deterministic) and dropout_rate > 0.0 and rng is not None
    if use_dropout:
        if not isinstance(rng, torch.Generator):
            raise TypeError(f"dropout needs a torch.Generator, got {type(rng)}")
        seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=rng,
                             device=rng.device, dtype=torch.int32).to(x.device)
    else:
        seed = torch.zeros((1,), dtype=torch.int32, device=x.device)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).to(torch.bfloat16)
    flat = [t for l in layers for t in (l["dense"]["w"], l["dense"]["b"],
                                        l["norm"]["scale"], l["norm"]["bias"])]
    out = _Tower.apply(x2, seed, kernel, dropout_rate if use_dropout else 0.0,
                       *flat)
    return out.reshape(*lead, out.shape[-1])


def fused_tower(layers: List[dict], x: torch.Tensor, dropout_rate: float = 0.0,
                rng: Optional[torch.Generator] = None,
                deterministic: bool = True) -> torch.Tensor:
    """Drop-in fused replacement for ``mlp_tower``: ``x [..., D0]`` ->
    f32 ``[..., D_L]``, differentiable.  CUDA tensors launch B4f (and B4b
    in the backward) or raise; CPU tensors run the plain version.  Each
    launch adds one to ``fused_tower.fwd_launches`` or ``.bwd_launches``."""
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no tower kernel for {x.device}")
    return _run(layers, x, dropout_rate, rng, deterministic,
                x.device.type == "cuda")


fused_tower.fwd_launches = _kernels.LaunchCounter()
fused_tower.bwd_launches = _kernels.LaunchCounter()


def fused_tower_ref(layers: List[dict], x: torch.Tensor,
                    dropout_rate: float = 0.0,
                    rng: Optional[torch.Generator] = None,
                    deterministic: bool = True) -> torch.Tensor:
    """The plain version of ``fused_tower`` (same arguments, same masks
    for the same generator state), on any device."""
    return _run(layers, x, dropout_rate, rng, deterministic, False)
