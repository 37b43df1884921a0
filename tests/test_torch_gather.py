"""The row gather B7 (``ops/gather.py``, ``csrc/gather.cu``) without JAX.

On the CPU:
- ``launch_plan`` for every row size from 4 to 2,048 bytes and table and
  output addresses at 4-, 8- and 16-byte alignment: the word divides the
  row and both addresses and is the widest that does, the group times
  the word times its iterations covers the row, and the grid's passes
  cover any ``n`` without more blocks than the card holds resident;
- a NumPy model of the kernel's mapping of threads to ids and bytes
  (the chunk a warp takes in each grid-stride pass, the coalesced id
  load and its shuffle, the items ``q = m * T + j`` ``IN_FLIGHT`` at a
  time, the kernel's ``kInFlight``) writes each output byte exactly once, from ``table[ids]``, over
  ``n`` in {1, 31, 33, 1,000, 237,184}, negative ids, int32 and int64
  ids, at the card's grid and at a grid of a few blocks (many passes);
- the wrapper hands the C entry point the plan, launches nothing for no
  ids, and ``_kernels.launch`` binds a C function once and raises on a
  nonzero return.
On the card (``cuda`` marker; skipped here): the kernel bit for bit
equal to ``gather_rows_ref`` at row sizes of 4 to 2,048 bytes, a table
view at a 4-byte offset, ``n`` of 0, 1 and one that is not a multiple of
a block's rows, negative and non-contiguous ids, each launch counted.
(Parity with the JAX package's Pallas gather: ``tests/test_torch_ncf.py``.)
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

from ncf_tpu_torch.ops import _kernels, gather  # noqa: E402

H100_SMS = 132
IN_FLIGHT = 4                     # csrc/gather.cu's kInFlight


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# ------------------------------------------------------------ the plan

@pytest.mark.parametrize("table_align", (4, 8, 16))
@pytest.mark.parametrize("out_align", (4, 8, 16))
def test_launch_plan_covers_every_row_size(table_align, out_align):
    # an address with exactly this alignment
    tp, op = 4096 + table_align, 8192 + out_align
    for row_bytes in range(4, 2049, 4):
        p = gather.launch_plan(row_bytes, tp, op, 1000, H100_SMS)
        w = p.width
        assert w in (4, 8, 16)
        assert row_bytes % w == 0 and tp % w == 0 and op % w == 0
        if w < 16:                      # the widest word that does
            assert row_bytes % (2 * w) or tp % (2 * w) or op % (2 * w)
        words = row_bytes // w
        assert 1 <= p.group <= 32 and p.group == 1 << p.tlog
        iters = -(-words // p.group)                # words a thread a row
        assert p.group * iters >= words             # the row is covered
        assert p.group * (iters - 1) < words        # no idle iteration
        if words <= 32:
            assert iters == 1 and p.group < 2 * words
        else:
            assert p.group == 32


@pytest.mark.parametrize("sms", (1, 4, H100_SMS))
def test_launch_plan_grid_covers_any_n(sms):
    warps_per_block = gather.THREADS // 32
    for n in (1, 31, 32, 33, 255, 256, 257, 1000, 237_184, 10**7,
              12_000_000 * 3):
        p = gather.launch_plan(256, 0, 0, n, sms)
        assert 1 <= p.grid <= sms * gather.BLOCKS_PER_SM
        chunks = -(-n // 32)
        passes = -(-chunks // (p.grid * warps_per_block))
        assert p.grid * gather.ROWS_PER_BLOCK * passes >= n
        # no block without a chunk in its first pass
        assert (p.grid - 1) * warps_per_block < chunks


# ------------------------------------------------- the kernel's mapping

def _model(table_bytes, ids, row_bytes, plan):
    """The bytes ``csrc/gather.cu`` writes, replayed in NumPy: returns
    (out bytes [n, row_bytes], how often each byte was written)."""
    n = ids.size
    W, tlog = plan.width, plan.tlog
    T, G = 1 << tlog, 32 >> tlog
    row_words = row_bytes // W
    iters = (row_words + T - 1) >> tlog          # as the kernel derives it
    items = T * iters
    num_rows = table_bytes.shape[0]
    warps = gather.THREADS // 32
    stride = plan.grid * warps
    # every (block, warp) and pass: the chunk it takes
    first = np.arange(plan.grid * warps)         # blockIdx * warps + warp
    passes = -(-n // (32 * stride))
    chunk = (first[None, :] + stride * np.arange(passes)[:, None]).ravel()
    chunk = chunk[chunk * 32 < n]
    # the coalesced id load: lane i of the chunk's warp holds id i
    idx = chunk[:, None] * 32 + np.arange(32)[None, :]
    my = np.where(idx < n, ids.reshape(-1)[np.minimum(idx, n - 1)], 0)
    my = np.where(my < 0, my + num_rows, my).astype(np.int64)
    lane = np.arange(32)
    g, t = lane >> tlog, lane & (T - 1)
    out = np.zeros(n * row_bytes, np.uint8)
    count = np.zeros(n * row_bytes, np.int64)
    here = n - chunk * 32                          # rows of each chunk
    for q0 in range(0, items, IN_FLIGHT):
        for u in range(IN_FLIGHT):
            q = q0 + u
            r = g + G * (q & (T - 1))              # [32], < 32
            k = t + T * (q >> tlog)
            ok = ((q < items) & (r[None, :] < here[:, None])
                  & (k < row_words)[None, :])
            c_i, l_i = np.nonzero(ok)
            src_id = my[c_i, r[l_i]]               # the shuffle
            dst_row = chunk[c_i] * 32 + r[l_i]
            col = (k[l_i] * W)[:, None] + np.arange(W)[None, :]
            dst = (dst_row[:, None] * row_bytes + col).ravel()
            src = (src_id[:, None] * row_bytes + col).ravel()
            out[dst] = table_bytes.reshape(-1)[src]
            count += np.bincount(dst, minlength=count.size)
    return out.reshape(n, row_bytes), count.reshape(n, row_bytes)


@pytest.mark.parametrize("id_dtype", (np.int32, np.int64))
@pytest.mark.parametrize("n", (1, 31, 33, 1000, 237_184))
def test_kernel_mapping_writes_each_byte_once(n, id_dtype):
    rng = np.random.default_rng(n)
    sizes = ((4, 16), (68, 4), (256, 16)) if n > 1000 else (
        (4, 16), (12, 4), (64, 8), (68, 4), (256, 16), (516, 4),
        (2048, 16))
    for row_bytes, table_align in sizes:
        rows = 97
        table = rng.integers(0, 256, (rows, row_bytes), dtype=np.uint8)
        ids = rng.integers(-rows, rows, n).astype(id_dtype)
        for sms in (H100_SMS, 1):
            plan = gather.launch_plan(row_bytes, 4096 + table_align, 256, n,
                                      sms)
            assert row_bytes % plan.width == 0
            out, count = _model(table, ids, row_bytes, plan)
            assert (count == 1).all(), (row_bytes, sms)
            np.testing.assert_array_equal(out, table[ids.astype(np.int64)])


# ------------------------------------------ the wrapper and the binding

def _recorded(monkeypatch):
    calls = []
    monkeypatch.setattr(_kernels, "launch",
                        lambda *a: calls.append(a))
    monkeypatch.setattr(_kernels, "stream_of", lambda t: 0)
    monkeypatch.setattr(gather, "_sms", {-1: H100_SMS})
    return calls


def test_wrapper_passes_the_plan(monkeypatch):
    calls = _recorded(monkeypatch)
    n0 = gather.gather_rows.launches.value
    big = torch.zeros(51, 17)                 # rows of 68 bytes
    table = big[1:]                           # a view 68 bytes in
    ids = torch.arange(-50, 50, dtype=torch.int32).reshape(4, 25)
    out = gather._gather_cuda(table, ids.t())            # not contiguous
    assert out.shape == (25, 4, 17)
    (args,) = calls
    lib, fn, codes, *vals = args
    assert (lib, fn, codes) == gather.C_ENTRY and len(vals) == len(codes)
    (tp, ip, ids64, n, row_bytes, rows, width, tlog, grid, op,
     stream) = vals
    assert (tp, ids64, n, row_bytes, rows) == (table.data_ptr(), 0, 100,
                                               68, 50)
    p = gather.launch_plan(68, tp, op, 100, H100_SMS)
    assert tp % 16 == 4                              # the narrow word
    assert (width, tlog, grid) == (p.width, p.tlog, p.grid) == (4, 5, 1)
    assert op == out.data_ptr()
    assert gather.gather_rows.launches.value == n0 + 1
    # no ids: nothing launched, nothing counted
    empty = gather._gather_cuda(table, torch.zeros((0, 3), dtype=torch.long))
    assert empty.shape == (0, 3, 17) and len(calls) == 1
    assert gather.gather_rows.launches.value == n0 + 1


def test_launch_binds_once_and_raises_on_an_error(monkeypatch):
    class Fn:
        argtypes = restype = None

        def __init__(self, ret):
            self.ret, self.calls = ret, 0

        def __call__(self, *args):
            self.calls += 1
            return self.ret

    class Lib:
        def __init__(self):
            self.ok, self.bad = Fn(0), Fn(1)
            self.ncf_cuda_error_string = lambda code: b"an error"

    lib, loads = Lib(), []
    monkeypatch.setattr(_kernels, "library",
                        lambda name: loads.append(name) or lib)
    monkeypatch.setattr(_kernels, "_bound", {})
    for _ in range(3):
        _kernels.launch("fake", "ok", "pi", 1, 2)
    assert lib.ok.calls == 3 and loads == ["fake"]
    assert lib.ok.restype is not None and len(lib.ok.argtypes) == 2
    with pytest.raises(RuntimeError, match="bad launch failed: an error"):
        _kernels.launch("fake", "bad", "p", 1)
    with pytest.raises(TypeError, match="takes 2 arguments"):
        _kernels.launch("fake", "ok", "pi", 1)


def test_on_device_leaves_cpu_tensors_alone(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_device",
                        lambda: pytest.fail("touched CUDA"))
    assert isinstance(_kernels.on_device(torch.zeros(2).device),
                      contextlib.nullcontext)


# ------------------------------------------------------------- the card

@pytest.mark.cuda
@pytest.mark.parametrize("row_bytes", (4, 12, 64, 68, 128, 256, 512, 516,
                                       2048))
def test_gather_kernel_row_sizes(cuda, row_bytes):
    gen = torch.Generator(device=cuda).manual_seed(row_bytes)
    for dtype in (torch.float32, torch.bfloat16):
        d = row_bytes // (4 if dtype == torch.float32 else 2)
        table = torch.randn((3000, d), generator=gen, device=cuda).to(dtype)
        for n in (1, 255, 257, 237_184 // 8 + 3):
            ids = torch.randint(-3000, 3000, (n,), generator=gen,
                                device=cuda)
            for i in (ids, ids.to(torch.int32)):
                n0 = gather.gather_rows.launches.value
                got = gather.gather_rows(table, i)
                torch.cuda.synchronize()
                assert gather.gather_rows.launches.value == n0 + 1
                assert torch.equal(got, gather.gather_rows_ref(table, i)), (
                    row_bytes, dtype, n, i.dtype)


@pytest.mark.cuda
def test_gather_kernel_edges(cuda):
    gen = torch.Generator(device=cuda).manual_seed(9)
    big = torch.randn((4001, 33), generator=gen, device=cuda)
    table = big[1:]                               # 132 bytes in: 4-aligned
    assert table.data_ptr() % 8 == 4
    ids = torch.randint(-4000, 4000, (64, 3706), generator=gen, device=cuda)
    for i in (ids, ids.t(), ids[:, ::3], ids.to(torch.int32).t()):
        assert not i.is_contiguous() or i is ids
        got = gather.gather_rows(table, i)
        assert torch.equal(got, gather.gather_rows_ref(table, i))
    n0 = gather.gather_rows.launches.value
    none = gather.gather_rows(table, ids[:0])
    assert none.shape == (0, 3706, 33)
    assert gather.gather_rows.launches.value == n0
    # the largest offsets: a row past 2^31 bytes
    wide = torch.zeros((2**31 // 512 + 5, 128), device=cuda)
    wide[-3:] = torch.arange(384.0, device=cuda).view(3, 128)
    i = torch.tensor([-1, -3, 0, -2], device=cuda)
    assert torch.equal(gather.gather_rows(wide, i), wide[i])
    torch.cuda.synchronize()
