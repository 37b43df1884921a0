"""The arithmetic of B4b's tensor-core products, emulated on the CPU.

``csrc/fused_tower.cu`` keeps the backward's products f32-faithful on
TF32 tensor cores (``mma.sync.m16n8k8``):

- dW = h^T dz: h is bf16, exact in TF32; dz = hi + lo with hi =
  tf32_rna(dz) and lo = tf32_rna(dz - hi), and the kernel issues h.lo,
  then h.hi.  |dz - hi - lo| <= 2^-22 |dz|, so each product is within
  2^-22 of its value.
- dh = dz W^T with the f32 weight: both sides split, lo.hi + hi.lo +
  hi.hi; the dropped lo.lo and the two splits leave at most 3 * 2^-22 of
  |dz w| a product.

Each instruction adds its exact 8-deep sum to the f32 accumulator.  dW
sums a tile of 64 rows, then adds the tile into its block's f32 slice;
the slices are added in block order.  The emulation below repeats that
(rounding to nearest with ties away at 10 mantissa bits, as
``cvt.rna.tf32.f32``).

Held here, at the tower's shapes cut to a few hundred rows (seeded numpy
inputs): each product within its stated error of an f64 reference (with
exact sums, so only the products' error shows); the backward with these
products within the card tests' gradient tolerance of ``_bwd_ref`` (each
leaf within 1e-4 of its largest magnitude, plus 1e-6; dx within one bf16
ulp plus 1e-4 of its largest magnitude); and one TF32 or one bf16 product
outside that tolerance, which is why the kernel pays for the splits.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

from ncf_tpu_torch.ops import tower  # noqa: E402

F32, F64 = np.float32, np.float64
TILE = 64          # rows a tile of B4b, one dW update each
BLOCKS = 132       # resident blocks (one a multiprocessor of an H100)
KSTEP = 8          # depth of one m16n8k8 instruction
DW_ERR = 2.0 ** -22
DH_ERR = 3 * 2.0 ** -22


def _tf32(x):
    """f32 -> TF32 (10 mantissa bits), round to nearest, ties away from
    zero (``cvt.rna.tf32.f32``), kept as f32."""
    b = np.ascontiguousarray(x, dtype=F32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(F32)


def _bf16(x):
    """f32 -> bf16 (round to nearest even), kept as f32."""
    return torch.from_numpy(np.ascontiguousarray(x, F32)).to(
        torch.bfloat16).float().numpy()


def _split(x):
    hi = _tf32(x)
    return hi, _tf32((x.astype(F32) - hi).astype(F32))


def _operands(route, a, b):
    """Pairs (left [M, K], right [K, N]) of a product a @ b in the order
    the kernel issues them.  route: "split" (the kernel's: for dW, a is
    bf16 h^T and only b = dz splits; for dh both split), "tf32" or "bf16"
    (one product of rounded operands: what the kernel does NOT do)."""
    if route == "tf32":
        return [(_tf32(a), _tf32(b))]
    if route == "bf16":
        return [(_bf16(a), _bf16(b))]
    bh, bl = _split(b)
    if np.array_equal(_bf16(a), a):          # h: exact in TF32
        return [(a, bl), (a, bh)]
    ah, al = _split(a)
    return [(al, bh), (ah, bl), (ah, bh)]


def _mma(pairs, exact=False):
    """sum over K of left @ right, KSTEP deep at a time, each instruction's
    exact sum added to the f32 accumulator (or, with ``exact``, to an f64
    one: only the products' error remains)."""
    m, k = pairs[0][0].shape
    acc = np.zeros((m, pairs[0][1].shape[1]), F64)
    for k0 in range(0, k, KSTEP):
        sl = slice(k0, k0 + KSTEP)
        for a, b in pairs:
            acc = acc + a[:, sl].astype(F64) @ b[sl].astype(F64)
            if not exact:
                acc = acc.astype(F32).astype(F64)
    return acc


def _dw(h, dz, route):
    """dW = h^T dz as B4b forms it: per 64-row tile, added into the
    block's slice (tile t on block t % BLOCKS), the slices added in block
    order."""
    tiles = -(-h.shape[0] // TILE)
    slices = {}
    for t in range(tiles):
        rows = slice(t * TILE, (t + 1) * TILE)
        part = _mma(_operands(route, h[rows].T.copy(), dz[rows])).astype(F32)
        b = t % BLOCKS
        slices[b] = part if b not in slices else (slices[b] + part).astype(F32)
    out = np.zeros_like(slices[0])
    for b in sorted(slices):
        out = (out + slices[b]).astype(F32)
    return out


def _dh(dz, w, route):
    """dh = dz @ W^T with the f32 weight, as B4b forms it."""
    return _mma(_operands(route, dz, w.T.copy())).astype(F32)


def _bwd_emulated(x2, dy, seed, flat, rate, route):
    """``tower._bwd_ref`` with its two products formed as B4b forms them
    (the LayerNorm, ReLU and dropout backward are the plain version's)."""
    h = x2.to(torch.bfloat16).to(torch.float32)
    layers = tower._layers(flat)
    h_ins, res = [], []
    for i, (w, b, g, be) in enumerate(layers):
        h_ins.append(h)
        y, z, mean, rstd, mask = tower._layer_fwd(h, w, b, g, be, i, seed,
                                                  rate)
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
        dw = _dw(h_ins[i].numpy(), dz.numpy(), route)
        grads[4 * i:4 * i + 4] = [torch.from_numpy(dw), dz.sum(0),
                                  (dh * xhat).sum(0), dh.sum(0)]
        dh = torch.from_numpy(_dh(dz.numpy(), w.numpy(), route))
    return dh.to(torch.bfloat16), grads


def _tower(rows, d0, hidden, seed):
    """Seeded numpy inputs at the tower's widths: params as
    ``mlp_tower_init`` draws them (LayerNorm moved off (1, 0)), bf16 x,
    f32 dy."""
    rng = np.random.default_rng(seed)
    flat, cur = [], d0
    for h in hidden:
        bound = cur ** -0.5
        flat += [rng.uniform(-bound, bound, (cur, h)),
                 rng.uniform(-bound, bound, h),
                 1 + 0.1 * rng.standard_normal(h),
                 0.1 * rng.standard_normal(h)]
        cur = h
    flat = [torch.from_numpy(np.asarray(p, F32)) for p in flat]
    x2 = torch.from_numpy(rng.standard_normal((rows, d0)).astype(F32)).to(
        torch.bfloat16)
    dy = torch.from_numpy(rng.standard_normal((rows, hidden[-1])).astype(F32))
    return x2, dy, flat


SHAPES = [(320, 96, [256, 128, 64]), (320, 160, [256, 128, 64]),
          (200, 37, [45, 3])]
SEED = torch.tensor([20240601], dtype=torch.int32)


def _layer_operands(rows, d0, hidden, rate):
    """(h, dz, W) of every layer of a plain backward at these shapes."""
    x2, dy, flat = _tower(rows, d0, hidden, 3)
    h = x2.float()
    out = []
    for i, (w, b, g, be) in enumerate(tower._layers(flat)):
        y, z, mean, rstd, mask = tower._layer_fwd(h, w, b, g, be, i, SEED,
                                                  rate)
        rng = np.random.default_rng(i)
        dz = torch.from_numpy(rng.standard_normal(z.shape).astype(F32))
        dz = torch.where(z > 0.0, dz * 0.05, torch.zeros_like(dz))
        out.append((h.numpy(), dz.numpy(), w.numpy()))
        h = y.to(torch.bfloat16).float()
    return out


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("rate", (0.0, 0.2))
def test_each_product_is_within_its_stated_error(shape, rate):
    """With exact sums, dW and dh differ from f64 by at most the stated
    error of each product times the sum of the products' magnitudes."""
    for h, dz, w in _layer_operands(*shape, rate):
        for a, b, err in ((h.T.copy(), dz, DW_ERR), (dz, w.T.copy(), DH_ERR)):
            got = _mma(_operands("split", a, b), exact=True)
            want = a.astype(F64) @ b.astype(F64)
            mag = np.abs(a.astype(F64)) @ np.abs(b.astype(F64))
            assert np.all(np.abs(got - want) <= err * mag)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("rate", (0.0, 0.2))
def test_split_backward_is_within_the_card_tolerance(shape, rate):
    x2, dy, flat = _tower(*shape, 5)
    rdx, rg = tower._bwd_ref(x2, dy, SEED, flat, rate)
    kdx, kg = _bwd_emulated(x2, dy, SEED, flat, rate, "split")
    got, want = kdx.float(), rdx.float()
    assert bool((got - want).abs().le(2.0 ** -7 * want.abs() + 1e-4
                                      * float(want.abs().max())).all())
    for k, r in zip(kg, rg):
        assert float((k - r).abs().max()) <= \
            1e-4 * float(r.abs().max()) + 1e-6


@pytest.mark.parametrize("route", ("tf32", "bf16"))
@pytest.mark.parametrize("shape", SHAPES[:2])
def test_one_rounded_product_falls_outside_the_tolerance(route, shape):
    x2, dy, flat = _tower(*shape, 5)
    _, rg = tower._bwd_ref(x2, dy, SEED, flat, 0.2)
    _, kg = _bwd_emulated(x2, dy, SEED, flat, 0.2, route)
    worst = max(float((k - r).abs().max()) / (float(r.abs().max()) + 1e-30)
                for k, r in zip(kg, rg))
    assert worst > 1e-4
