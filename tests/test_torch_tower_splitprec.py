"""The arithmetic of B4b's tensor-core products, emulated on the CPU.

``csrc/fused_tower.cu`` keeps the backward's products f32-faithful on
the tensor cores (``mma.sync``):

- dW = h^T dz, bf16 ``m16n8k16``: h is bf16, exact; dz = p1 + p2 + p3,
  three bf16 pieces, each rounding to nearest (ties to even) what the
  pieces before it left, and the kernel issues h.p3, h.p2, then h.p1.
  |dz - p1 - p2 - p3| <= 2^-24 |dz|, so each product is within 2^-24 of
  its value.
- dh = dz W^T with the f32 weight, TF32 ``m16n8k8``: both sides split
  (hi = tf32_rna(x), lo = tf32_rna(x - hi)), lo.hi + hi.lo + hi.hi; the
  dropped lo.lo and the two splits leave at most 3 * 2^-22 of |dz w| a
  product.  Each 16 columns of the depth feed two instructions: the
  first takes columns 4 q and 4 q + 1 of q = 0..3, the second 4 q + 2
  and 4 q + 3.

Each instruction adds its exact sum (16 deep for dW, 8 for dh) to the
f32 accumulator.  dW sums a tile of 64 rows, then adds the tile into its
block's f32 slice (one block a multiprocessor); the slices are added in
block order.  The emulation below repeats that (TF32: rounding to
nearest with ties away at 10 mantissa bits, as ``cvt.rna.tf32.f32``).

Held here, at the tower's shapes cut to a few hundred rows (seeded numpy
inputs): the three bf16 pieces within 2^-24 of each value; each product
within its stated error of an f64 reference (with exact sums, so only
the products' error shows); the backward with these
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
DW_STEP = 16       # depth of one bf16 m16n8k16 instruction (dW)
DH_STEP = 8        # depth of one TF32 m16n8k8 instruction (dh)
DW_ERR = 2.0 ** -24
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


def _pieces(x):
    """x as three bf16 pieces p1 + p2 + p3, each rounding (to nearest
    even) what the pieces before it left; the remainders are exact in
    f32."""
    x = np.asarray(x, F32)
    p1 = _bf16(x)
    r = (x - p1).astype(F32)
    p2 = _bf16(r)
    return p1, p2, _bf16((r - p2).astype(F32))


def _operands(route, a, b, kind):
    """Pairs (left [M, K], right [K, N]) of a product a @ b in the order
    the kernel issues them.  route: "split" (the kernel's: for dW, a is
    bf16 h^T and b = dz splits in three bf16 pieces; for dh both sides
    split in TF32), "tf32" or "bf16" (one product of rounded operands:
    what the kernel does NOT do)."""
    if route == "tf32":
        return [(_tf32(a), _tf32(b))]
    if route == "bf16":
        return [(_bf16(a), _bf16(b))]
    if kind == "dw":
        p1, p2, p3 = _pieces(b)
        return [(a, p3), (a, p2), (a, p1)]
    bh, bl = _split(b)
    ah, al = _split(a)
    return [(al, bh), (ah, bl), (ah, bh)]


def _dh_depth_order(n):
    """B4b's dh instructions in order over a depth of n columns (padded
    with zeros to a multiple of 16): per 16 columns, the first takes 4 q
    and 4 q + 1 of q = 0..3, the second 4 q + 2 and 4 q + 3."""
    out = []
    for b in range(0, -(-n // 16) * 16, 16):
        out += [b + 4 * q + e for q in range(4) for e in (0, 1)]
        out += [b + 4 * q + 2 + e for q in range(4) for e in (0, 1)]
    return np.asarray(out)


def _mma(pairs, exact=False, kind="dw"):
    """sum over K of left @ right, an instruction at a time (16 deep for
    dW; for dh 8 deep in ``_dh_depth_order``), each instruction's exact
    sum added to the f32 accumulator (or, with ``exact``, to an f64 one:
    only the products' error remains)."""
    m, k = pairs[0][0].shape
    step = DW_STEP if kind == "dw" else DH_STEP
    kp = -(-k // 16) * 16
    order = np.arange(kp) if kind == "dw" else _dh_depth_order(k)
    acc = np.zeros((m, pairs[0][1].shape[1]), F64)
    for k0 in range(0, kp, step):
        sl = order[k0:k0 + step]
        sl = sl[sl < k]
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
        part = _mma(_operands(route, h[rows].T.copy(), dz[rows], "dw"),
                    kind="dw").astype(F32)
        b = t % BLOCKS
        slices[b] = part if b not in slices else (slices[b] + part).astype(F32)
    out = np.zeros_like(slices[0])
    for b in sorted(slices):
        out = (out + slices[b]).astype(F32)
    return out


def _dh(dz, w, route):
    """dh = dz @ W^T with the f32 weight, as B4b forms it."""
    return _mma(_operands(route, dz, w.T.copy(), "dh"),
                kind="dh").astype(F32)


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
        for a, b, err, kind in ((h.T.copy(), dz, DW_ERR, "dw"),
                                (dz, w.T.copy(), DH_ERR, "dh")):
            got = _mma(_operands("split", a, b, kind), exact=True, kind=kind)
            want = a.astype(F64) @ b.astype(F64)
            mag = np.abs(a.astype(F64)) @ np.abs(b.astype(F64))
            assert np.all(np.abs(got - want) <= err * mag)


def test_three_bf16_pieces_are_within_2_to_the_minus_24():
    """dW's split of dz: p1 + p2 + p3 within 2^-24 of each value (over
    sixty binades, with zeros and signs), where two pieces leave more
    than the old TF32 pair's 2^-22."""
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(200_000) * 2.0 ** rng.integers(
        -30, 30, 200_000)).astype(F32)
    x[:100] = 0.0
    p1, p2, p3 = _pieces(x)
    err = np.abs(x.astype(F64) - p1 - p2.astype(F64) - p3)
    assert np.all(err <= 2.0 ** -24 * np.abs(x.astype(F64)))
    two = np.abs(x.astype(F64) - p1 - p2.astype(F64))
    assert np.max(two / np.maximum(np.abs(x.astype(F64)), 1e-300)) > 2.0 ** -22


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("rate", (0.0, 0.2))
def test_dw_route_is_within_its_stated_error_with_f32_sums(shape, rate):
    """dW as the kernel forms it (64-row tiles, 16-deep instructions, the
    slices in block order) is within its stated 2^-24 a product plus the
    f32 sums' rounding of the f64 product: the f32 rounding of each
    instruction's add, 2^-24 of the running magnitude, counted over the
    adds of the tile, of the slice and of the slices' sum."""
    for h, dz, _ in _layer_operands(*shape, rate):
        got = _dw(h, dz, "split").astype(F64)
        want = h.T.astype(F64) @ dz.astype(F64)
        mag = np.abs(h.T.astype(F64)) @ np.abs(dz.astype(F64))
        adds = 3 * -(-TILE // DW_STEP) + 2 * -(-h.shape[0] // TILE)
        assert np.all(np.abs(got - want) <= (DW_ERR + adds * 2.0 ** -24)
                      * mag + 1e-30)


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
