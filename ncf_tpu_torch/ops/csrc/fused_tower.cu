// Fused MLP tower, forward (B4f) and backward (B4b), for NVIDIA Hopper
// (sm_90a), with every product on the tensor cores (mma.sync).
//
// Replaces the Pallas TPU kernels of ncf_tpu/ops/pallas_tower.py::fused_tower:
// the forward pallas_call in _pallas_fwd (pallas_tower.py:306, call :309,
// body _make_fwd_kernel :94 via _layer_fwd :59) and the backward one in
// _pallas_bwd (:325, call :344, body _make_bwd_kernel :115).
//
// Function computed, per row, for layers l = 0..L-1 (h_0 = bf16(x)):
//   z = relu(h_l @ bf16(W_l) + b_l)          (products of bf16 values, f32 sum)
//   y = (z - mean(z)) * rsqrt(var(z) + 1e-5) * g_l + be_l   (over the width)
//   y = keep(seed, l, row, col) ? y * inv_keep : 0           (dropout)
//   h_{l+1} = bf16(y); the last layer's y is the f32 output.
// The backward recomputes that forward for a tile of rows, then walks the
// layers in reverse: dropout, LayerNorm and ReLU backward give dz; dW +=
// h_l^T dz, db += sum dz, dg += sum dh * xhat, dbe += sum dh; dh = dz @ W^T
// with the f32 weight (not its bf16 rounding, as the reference).  dx leaves
// in bf16.
//
// Dropout: Philox4x32-10 with key (seed, layer) and counter (row, q, 0, 0)
// gives the words of columns 4q .. 4q+3; element (row, col) is kept iff
// its word is below `threshold` = min(floor(keep * 2^32), 2^32 - 1)
// (ops/tower.py::philox4x32 computes the same bits).  One thread handles
// the four columns of a quad, so each quad's words are drawn once.  The
// seed is read from device memory.  The backward draws in its recompute
// only and keeps the masks as bits in shared memory, which the dropout
// backward and the rebuilding of each layer's input read.
//
// What bounds it on this card, at [81920, 160 -> 256 -> 128 -> 64]:
//   forward: 13.4 GFLOP of bf16 products (13.6 us at 989 TFLOP/s) against
//     47.5 MB of x, y and parameters (14.2 us at 3.35 TB/s), so bytes; and
//     the masks: 9.2M Philox draws (one per four of 36.7M activations, ~100
//     integer instructions each), which take longer than either once the
//     products are on the tensor cores;
//   backward: the recomputed forward (one bf16 product), dW and dh kept
//     f32-faithful; the cheapest such route (dW = h^T dz with dz in three
//     bf16 pieces, dh in three TF32 products) is bound by operations at
//     0.136 ms.
//
// B4f's design.  A block of 8 warps takes tiles of T = 64 rows (32 or 16
// where shared memory is short) and stays resident, walking tiles
// blockIdx.x, blockIdx.x + gridDim.x, ...; a tile's activations never leave
// shared memory.  The weights stream through a cp.async ring (2 to 8
// stages, as deep as the shared memory left by the tile allows), in f32 as
// the caller holds them (16-byte copies where rows and pointer allow), in
// chunks of 16 rows x at most 256 columns of W_l, each read once per tile
// by the whole block, the next chunks in flight while one is in use.
//   z = h bf16(W): m16n8k16 bf16.  h by ldmatrix; W rounded to bf16 pairs
//     as its fragments are read.  Every warp takes all rows of the tile
//     and the 8-column slices w, w + 8, ... of the output, so each weight
//     fragment serves four row slabs.  Each 16-deep product starts from a
//     zero accumulator and is added to the row's sum in f32 (the tensor
//     core's own running sum rounds less exactly).
// LayerNorm statistics take four lanes a row (32 partial sums); LayerNorm,
// dropout and the bf16 rounding of the next input take a thread per four
// columns.
//
// B4b's design.  Where the time went in the design before this one (one
// 8-warp block an SM on 64-row tiles, as B4f; clock64 stamps between its
// barriers at [524288, 96 -> 256 -> 128 -> 64], dropout 0.2): the products
// 72% (dh 30%, dW 25%, the recomputed forward 17%), each at 4-14% of its
// tensor-core rate between scalar loads, splits made anew for every
// fragment and ~80 barriers a tile; LayerNorm, dropout and Philox 25%; the
// weight ring's waits 6%.  So:
//   - 16 warps an SM on a tile of 64 rows (one block), 16 barriers a tile;
//     where that does not fit shared memory, 8 warps on 32 or 16 rows
//     (choose_bwd_layout).  Two blocks an SM on 32-row tiles (two tiles in
//     flight) measured a fifth slower at the shape above: the weights are
//     read, and the gradient slices added, once a tile, so twice as often,
//     and 264 slices (70 MB) no longer stay in L2.
//   - No weight ring: tower_bwd_kernel_wprep makes, once a launch, W_l's
//     bf16 pairs in the forward's fragment order (z) and its TF32 hi and lo
//     (dh); the warps read them from L2 a few steps ahead of their use.
//   - z: as B4f forms it (the same fragments and f32 sums), so z, and the
//     statistics taken in B4f's order, equal B4f's bit for bit.
//   - dW = h^T dz: m16n8k16 bf16, h^T by ldmatrix.trans (h is bf16, exact),
//     dz in three bf16 pieces: |dz - p1 - p2 - p3| <= 2^-24 |dz|, so each
//     product is within 2^-24 of its value.
//   - dh = dz W^T: m16n8k8 TF32, both sides split, lo.hi + hi.lo + hi.hi;
//     the dropped lo.lo and the two splits leave <= 3 * 2^-22 of |dz w| a
//     product (one TF32 product would leave up to 2^-10).
//   - dh's and dW's units share one phase, dealt to the warps so that their
//     work evens out; the masks are drawn beside the forward product.
//   - The row passes take a warp a row (statistics, LayerNorm) or a lane a
//     row (dropout backward, dz, the vector gradients), 16-byte accesses.
// A tile: x; per layer the product and masks, then the statistics and
// LayerNorm into the next layer's bf16 input; per layer in reverse, pass 1
// (row sums of the dropout and LayerNorm backward, with the rebuilding of
// the layer's bf16 input), pass 2 (dz in place of z, the vector
// gradients), then dh and dW.  All sums are f32.  Weight gradients: each
// block adds its tiles into its own f32 slice of a scratch buffer (stored
// on its first tile, then added by reductions that wait for nothing; one
// thread owns each address, so the adds run in tile order), and
// reduce_partials adds the slices in block order, so the result does not
// depend on scheduling.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLayers = 16;
constexpr int kMaxWidth = 512;
constexpr int kChunkRows = 16;    // W rows in a ring stage
constexpr int kChunkCols = 256;   // W columns in a ring stage, at most
constexpr int kMaxStages = 8;     // ring depth where shared memory allows
constexpr int kDhCols = 16;       // W columns in a dh chunk (its rows: a pass)
constexpr int kDhLd = 20;         // floats per W row in a dh chunk
static_assert(kChunkCols == kThreads, "a thread a column of a chunk");
constexpr float kEps = 1e-5f;

struct Tower {
  int n_layers;
  int dims[kMaxLayers + 1];
  const float* w[kMaxLayers];     // W_l [dims[l], dims[l+1]], row-major
  const float* b[kMaxLayers];
  const float* g[kMaxLayers];
  const float* be[kMaxLayers];
  int vec[kMaxLayers];            // W_l takes 16-byte copies
  long long w_off[kMaxLayers];    // the leaves' offsets in the packed grads
  long long b_off[kMaxLayers];
  long long g_off[kMaxLayers];
  long long be_off[kMaxLayers];
  long long total;                // floats in the packed grads
  int use_dropout;
  uint32_t threshold;
  float inv_keep;
};

// Shared memory of a tile of T rows.  Padded strides keep the fragment
// loads free of bank conflicts (f32 rows == 4 mod 32 words, bf16 rows ==
// 8 mod 64 halves); compact ones only round to the instruction shape.
struct Layout {
  int ldz[kMaxLayers];   // floats per row of layer l's z (dz in the bwd)
  int lda[kMaxLayers];   // halves per row of layer l's bf16 input
  int ldh;               // floats per row of dh (backward)
  int ldw;               // floats per row of a forward chunk
  int sf;                // floats per ring stage
  int stages;            // ring depth, 2 .. kMaxStages
  int wpr;               // mask words per row, all layers
  int woff[kMaxLayers];  // layer l's first mask word
  int chunks;            // ring chunks per tile
  size_t z[kMaxLayers], hd, ring, mean, rstd, m1, m2, bits, bytes;
};

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}
__host__ __device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~(size_t)15;
}
__host__ __device__ __forceinline__ int fstride(int n, int padded) {
  return padded ? ((n + 31) & ~31) + 4 : (n + 7) & ~7;
}
__host__ __device__ __forceinline__ int hstride(int k, int padded) {
  return padded ? ((k + 63) & ~63) + 8 : (k + 15) & ~15;
}

// ------------------------------------------------------------- PTX

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// x rounded to TF32, to nearest with ties away from zero, as cvt.rna.tf32
// rounds it: half an ulp of TF32 added to the magnitude, the low 13 bits
// cleared (two integer instructions; this card runs cvt.rna.tf32 as five).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a b, the accumulator starting from zero
__device__ __forceinline__ void mma_bf16_zero(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// four 8x8 matrices of 16-bit pairs: lane l gives the address of row l % 8
// of matrix l / 8 and receives word l % 4 of row l / 4 of each matrix
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n of this thread's newest copy groups are pending
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
  }
}

// Philox4x32-10 (Salmon et al., SC'11), counter (row, quad, 0, 0), key
// (seed, layer): the words of columns 4 quad .. 4 quad + 3.
__device__ __forceinline__ uint4 philox4(uint32_t seed, uint32_t layer,
                                         uint32_t row, uint32_t quad) {
  uint32_t c0 = row, c1 = quad, c2 = 0u, c3 = 0u;
  uint32_t k0 = seed, k1 = layer;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return make_uint4(c0, c1, c2, c3);
}

// ---------------------------------------------------------- weight ring

struct Chunk {
  int layer, row0, col0, ncols, dh;
};

struct Ring {
  float* base;   // `stages` stages of sf floats
  int ldw;
  int sf;
  int stages;
  int bwd;       // a tile's stream holds the dh product's chunks too
  int total;     // chunks the block consumes
  int issued;    // chunks issued so far
  int wstage;    // the stage the next issued chunk goes to
  int rstage;    // the stage of the next chunk to consume
  int ph, l, a, b;   // the next chunk to issue: phase (0 forward, 1 dh),
                     // layer, outer and inner step
};

// The chunk at the cursor, and the cursor one chunk on.  A tile's stream:
// first the forward's chunks (layers 0..L-1; per layer 256-column passes
// of W, each in steps of 16 rows), then for the backward the dh product's
// (layers L-1..0; per layer passes over 256 rows of W, each in steps of
// 16 columns); after its last chunk, the next tile's first.
__device__ Chunk ring_cursor_next(const Tower& t, Ring& r) {
  const int K = t.dims[r.l], N = t.dims[r.l + 1];
  Chunk c;
  if (r.ph == 0) {
    const int kc = cdiv(K, kChunkRows), np = cdiv(N, kChunkCols);
    c = {r.l, r.b * kChunkRows, r.a * kChunkCols,
         min(kChunkCols, N - r.a * kChunkCols), 0};
    if (++r.b == kc) {
      r.b = 0;
      if (++r.a == np) {
        r.a = 0;
        if (++r.l == t.n_layers) {
          r.ph = r.bwd;
          r.l = r.bwd ? t.n_layers - 1 : 0;
        }
      }
    }
  } else {
    const int nq = cdiv(K, kChunkCols), nc = cdiv(N, kDhCols);
    c = {r.l, r.a * kChunkCols, r.b * kDhCols,
         min(kDhCols, N - r.b * kDhCols), 1};
    if (++r.b == nc) {
      r.b = 0;
      if (++r.a == nq) {
        r.a = 0;
        if (--r.l < 0) {
          r.ph = 0;
          r.l = 0;
        }
      }
    }
  }
  return c;
}

// Start the copy of the block's next chunk into its stage as one copy
// group (an empty one past the block's last chunk, so that every call
// commits one).  A forward chunk: 16 rows of W (zeros past W's end) x
// ncols columns, ldw floats a row; a thread takes one 16-byte column of
// every fourth row, or one column of every row.  A dh chunk: up to 256
// rows of W x ncols <= 16 columns, kDhLd floats a row; a thread takes one
// 16-byte column of every 64th row, or one column of every 16th.  Both
// zero their columns up to the next multiple of 8.
__device__ void ring_issue(const Tower& t, Ring& ring) {
  if (ring.issued >= ring.total) {
    cp_async_commit();
    return;
  }
  const Chunk c = ring_cursor_next(t, ring);
  float* dst = ring.base + ring.wstage * ring.sf;
  ring.issued++;
  ring.wstage = ring.wstage + 1 == ring.stages ? 0 : ring.wstage + 1;
  const int K = t.dims[c.layer], N = t.dims[c.layer + 1];
  const float* src = t.w[c.layer] + (long long)c.row0 * N + c.col0;
  const int n8 = (c.ncols + 7) & ~7;
  if (c.dh) {
    const int rows = min(kChunkCols, K - c.row0);
    if (t.vec[c.layer]) {
      const int v = threadIdx.x & 3;
      if (4 * v < c.ncols)
        for (int r = threadIdx.x >> 2; r < rows; r += kThreads / 4)
          cp_async16(smem_addr(dst + r * kDhLd + 4 * v),
                     src + (long long)r * N + 4 * v);
    } else {
      const int v = threadIdx.x & 15;
      if (v < c.ncols)
        for (int r = threadIdx.x >> 4; r < rows; r += kThreads / 16)
          cp_async4(smem_addr(dst + r * kDhLd + v), src + (long long)r * N + v);
    }
    if (n8 != c.ncols)
      for (int r = threadIdx.x; r < rows; r += kThreads)
        for (int v = c.ncols; v < n8; ++v) dst[r * kDhLd + v] = 0.f;
    cp_async_commit();
    return;
  }
  const int rows = min(kChunkRows, K - c.row0);
  if (t.vec[c.layer]) {
    const int v = threadIdx.x & 63;
    if (4 * v < c.ncols)
      for (int r = threadIdx.x >> 6; r < rows; r += kThreads / 64)
        cp_async16(smem_addr(dst + r * ring.ldw + 4 * v),
                   src + (long long)r * N + 4 * v);
  } else {
    const int v = threadIdx.x;
    if (v < c.ncols)
      for (int r = 0; r < rows; ++r)
        cp_async4(smem_addr(dst + r * ring.ldw + v), src + (long long)r * N + v);
  }
  if (rows < kChunkRows || n8 != c.ncols) {
    const int v = threadIdx.x;
    if (v < n8)
      for (int r = 0; r < kChunkRows; ++r)
        if (r >= rows || v >= c.ncols) dst[r * ring.ldw + v] = 0.f;
  }
  cp_async_commit();
}

// A ring over `stages` stages of sf floats at `base` for `tiles` tiles,
// its first stages - 1 chunks in flight.
__device__ Ring ring_start(const Tower& t, float* base, int ldw, int sf,
                           int stages, int bwd, int chunks_per_tile,
                           int tiles) {
  Ring ring{base, ldw, sf, stages, bwd, chunks_per_tile * tiles, 0, 0, 0,
            0, 0, 0, 0};
  for (int i = 0; i + 1 < stages; ++i) ring_issue(t, ring);
  return ring;
}

// The stage of the next chunk, once it has landed (stages - 2 newer
// groups may still be pending), after starting the copy of the chunk
// stages - 1 further on into the stage the previous chunk used (free:
// every thread has passed the barrier, so every warp is done with it).
// Called by all threads of the block.
__device__ __forceinline__ const float* ring_acquire(const Tower& t,
                                                     Ring& ring) {
  cp_async_wait(ring.stages - 2);
  __syncthreads();
  const float* stage = ring.base + ring.rstage * ring.sf;
  ring.rstage = ring.rstage + 1 == ring.stages ? 0 : ring.rstage + 1;
  ring_issue(t, ring);
  return stage;
}

// ------------------------------------------------------------- products

// Z[r][c] = relu(sum_k H[r][k] bf16(W[k][c]) + b[c]) for the T = 16 MT
// rows of the tile and the real columns of layer l; H bf16 [T][lda] with
// zeros from K to the next multiple of 16.  Each 16-deep product runs
// into a zero accumulator and is added to the sum in f32 (the tensor
// core's own accumulation rounds less exactly).
template <int MT>
__device__ void gemm_fwd(const Tower& t, int l, Ring& ring,
                         const __nv_bfloat16* H, int lda, float* Z, int ldz) {
  const int K = t.dims[l], N = t.dims[l + 1];
  const int kc = cdiv(K, kChunkRows), np = cdiv(N, kChunkCols);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const float* __restrict__ bias = t.b[l];
  const uint32_t a_base = smem_addr(H + (lane & 15) * lda + (lane >> 4) * 8);
  for (int p = 0; p < np; ++p) {
    const int col0 = p * kChunkCols;
    const int ntn = cdiv(min(kChunkCols, N - col0), 8);
    float acc[MT][4][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.f;
    for (int k = 0; k < kc; ++k) {
      const float* S = ring_acquire(t, ring);
      uint32_t a[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
        ldsm_x4(a_base + (uint32_t)((m * 16 * lda + k * 16) * 2), a[m]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nt = warp + kWarps * j;
        if (nt < ntn) {
          const float* s = S + 2 * tq * ring.ldw + nt * 8 + gq;
          const uint32_t b0 = pack_bf16(s[0], s[ring.ldw]);
          const uint32_t b1 = pack_bf16(s[8 * ring.ldw], s[9 * ring.ldw]);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            float d[4];
            mma_bf16_zero(d, a[m], b0, b1);
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[m][j][i] += d[i];
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nt = warp + kWarps * j;
      if (nt >= ntn) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = col0 + nt * 8 + 2 * tq + (i & 1);
        if (c >= N) continue;
        const float bc = __ldg(bias + c);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int r = m * 16 + gq + (i >> 1) * 8;
          Z[r * ldz + c] = fmaxf(acc[m][j][i] + bc, 0.f);
        }
      }
    }
  }
}

// v into the block's own slice: stored on the block's first tile, added
// after (a reduction that waits for nothing).  One thread owns each
// address of a slice, and a thread's adds to one address take effect in
// program order, so the sum runs in tile order.
__device__ __forceinline__ void add_to_slice(float* p, float v, bool first) {
  if (first)
    *p = v;
  else
    atomicAdd(p, v);
}

// The same for four floats at a 16-byte aligned p (one vector reduction).
__device__ __forceinline__ void add4_to_slice(float* p, float4 v, bool first) {
  if (first)
    *reinterpret_cast<float4*>(p) = v;
  else
    atomicAdd(reinterpret_cast<float4*>(p), v);
}

// ------------------------------------------------------ row-wise passes

// x rows [row0, row0 + T) into H (bf16 [T][lda]); rows past the end and
// columns d0 .. round16(d0) are zero.  vec: d0 % 8 == 0 and x 16-byte
// aligned.
__device__ void load_x(const __nv_bfloat16* __restrict__ x, int rows, int d0,
                       long long row0, int T, __nv_bfloat16* H, int lda,
                       bool vec) {
  const int kp = (d0 + 15) & ~15;
  if (vec) {
    const int per = kp / 8;
    for (int e = threadIdx.x; e < T * per; e += kThreads) {
      const int r = e / per, v = e - r * per;
      const long long g = row0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (g < rows && 8 * v < d0)
        val = *reinterpret_cast<const uint4*>(x + g * d0 + 8 * v);
      *reinterpret_cast<uint4*>(H + r * lda + 8 * v) = val;
    }
  } else {
    for (int e = threadIdx.x; e < T * kp; e += kThreads) {
      const int r = e / kp, c = e - r * kp;
      const long long g = row0 + r;
      H[r * lda + c] =
          (g < rows && c < d0) ? x[g * d0 + c] : __float2bfloat16_rn(0.f);
    }
  }
}

// The sum of v over the four lanes of a row (lanes 4i .. 4i + 3).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// sum of the n values zr[j], zr[j + 4], ... (j < 4) of one lane of a row,
// in eight partial sums (so a row's four lanes keep 32, columns c = 32 i +
// u over u) added as a tree; with `mean`, of the squared deviations
__device__ __forceinline__ float lane_sum(const float* zr, int j, int n,
                                         bool dev, float mean) {
  float p[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int c0 = j; c0 < n; c0 += 32) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int c = c0 + 4 * u;
      if (c < n) {
        const float v = dev ? zr[c] - mean : zr[c];
        p[u] = dev ? fmaf(v, v, p[u]) : p[u] + v;
      }
    }
  }
  return ((p[0] + p[1]) + (p[2] + p[3])) + ((p[4] + p[5]) + (p[6] + p[7]));
}

// Mean and rstd of each of the T rows of Z (n real columns): four lanes a
// row, eight rows a warp at once.
__device__ void row_stats(const float* Z, int ldz, int n, int T, float* MEAN,
                          float* RSTD) {
  const int lane = threadIdx.x & 31, j = lane & 3;
  for (int r0 = (threadIdx.x >> 5) * 8; r0 < T; r0 += kWarps * 8) {
    const int r = r0 + (lane >> 2);
    const float* zr = Z + r * ldz;
    const float mean = quad_sum(lane_sum(zr, j, n, false, 0.f)) / (float)n;
    const float rstd =
        rsqrtf(quad_sum(lane_sum(zr, j, n, true, mean)) / (float)n + kEps);
    if (j == 0) {
      MEAN[r] = mean;
      RSTD[r] = rstd;
    }
  }
}

enum { kToH = 0, kToOut = 1, kBitsOnly = 2 };

// y = (z - mean) * rstd * g + be (each operation rounded, no contraction,
// as the plain version), then dropout, for the T rows of layer l's Z.  A
// thread takes the four columns of one quad (its g and be loaded once) in
// every (256 / nq)-th row, nq the quads of a row rounded up to a power of
// two >= 8.  kToH: bf16(y) into H (zeros from N to the next multiple of
// 16); kToOut: f32 y into out (rows below `rows`); kBitsOnly: nothing but
// the masks.  The keep bits come from bits_in, or from one Philox draw a
// quad, then stored into bits_out if given (the 8 quads of a 32-column
// word are OR-ed across their lanes).
template <int kMode>
__device__ void ln_apply(const Tower& t, int l, uint32_t seed, long long row0,
                         int rows, int T, const float* Z, int ldz,
                         const float* MEAN, const float* RSTD,
                         __nv_bfloat16* H, int lda, float* __restrict__ out,
                         const uint32_t* bits_in, uint32_t* bits_out, int wpr,
                         int woff) {
  const int N = t.dims[l + 1];
  int lg = 3;
  while ((4 << lg) < N) ++lg;
  const int q = threadIdx.x & ((1 << lg) - 1), c = 4 * q;
  const bool live = c < N;
  const bool pad = kMode == kToH && !live && c < ((N + 15) & ~15);
  float g[4], be[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    g[j] = c + j < N ? __ldg(t.g[l] + c + j) : 0.f;
    be[j] = c + j < N ? __ldg(t.be[l] + c + j) : 0.f;
  }
  const bool out_vec = (N & 3) == 0 && ((uintptr_t)out & 15) == 0;
#pragma unroll 2
  for (int r = threadIdx.x >> lg; r < T; r += kThreads >> lg) {
    uint32_t keep = 0u;
    if (live) {
      const float mean = MEAN[r], rstd = RSTD[r];
      const float4 z4 = *reinterpret_cast<const float4*>(Z + r * ldz + c);
      const float z[4] = {z4.x, z4.y, z4.z, z4.w};
      keep = 0xFu;
      if (t.use_dropout) {
        if (bits_in != nullptr) {
          keep = (bits_in[r * wpr + woff + (q >> 3)] >> ((q & 7) * 4)) & 0xFu;
        } else {
          const uint4 w = philox4(seed, (uint32_t)l, (uint32_t)(row0 + r),
                                  (uint32_t)q);
          const uint32_t th = t.threshold;
          keep = (uint32_t)(w.x < th) | (uint32_t)(w.y < th) << 1 |
                 (uint32_t)(w.z < th) << 2 | (uint32_t)(w.w < th) << 3;
        }
      }
      float y[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        y[j] = 0.f;
        if (c + j >= N) {
          keep &= ~(1u << j);
          continue;
        }
        float v = __fadd_rn(
            __fmul_rn(__fmul_rn(__fsub_rn(z[j], mean), rstd), g[j]), be[j]);
        if (t.use_dropout) v = (keep >> j) & 1u ? __fmul_rn(v, t.inv_keep) : 0.f;
        y[j] = v;
      }
      if (kMode == kToH) {
        uint2 v;
        v.x = pack_bf16(y[0], y[1]);
        v.y = pack_bf16(y[2], y[3]);
        *reinterpret_cast<uint2*>(H + r * lda + c) = v;
      } else if (kMode == kToOut) {
        const long long gr = row0 + r;
        if (gr < rows) {
          float* o = out + gr * N + c;
          if (out_vec) {
            *reinterpret_cast<float4*>(o) = make_float4(y[0], y[1], y[2], y[3]);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (c + j < N) o[j] = y[j];
          }
        }
      }
    } else if (pad) {
      *reinterpret_cast<uint2*>(H + r * lda + c) = make_uint2(0u, 0u);
    }
    if (bits_out != nullptr) {
      uint32_t word = keep << ((q & 7) * 4);
      word |= __shfl_xor_sync(0xffffffffu, word, 1);
      word |= __shfl_xor_sync(0xffffffffu, word, 2);
      word |= __shfl_xor_sync(0xffffffffu, word, 4);
      if ((q & 7) == 0 && live) bits_out[r * wpr + woff + (q >> 3)] = word;
    }
  }
}

// ------------------------------------------------------------- kernels

template <int MT>
__global__ void __launch_bounds__(kThreads, 1)
tower_fwd_kernel(const __nv_bfloat16* __restrict__ x,
                 const __grid_constant__ Tower t,
                 const __grid_constant__ Layout s, int rows, int n_tiles,
                 const int* __restrict__ seed_p, float* __restrict__ out) {
  constexpr int T = 16 * MT;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* H = reinterpret_cast<__nv_bfloat16*>(smem + s.hd);
  float* Z = reinterpret_cast<float*>(smem + s.z[0]);
  float* MEAN = reinterpret_cast<float*>(smem + s.mean);
  float* RSTD = reinterpret_cast<float*>(smem + s.rstd);
  const int L = t.n_layers;
  const uint32_t seed = t.use_dropout ? (uint32_t)__ldg(seed_p) : 0u;
  const bool xvec = (t.dims[0] & 7) == 0 && ((uintptr_t)x & 15) == 0;
  const int my_tiles = cdiv(n_tiles - (int)blockIdx.x, (int)gridDim.x);
  Ring ring = ring_start(t, reinterpret_cast<float*>(smem + s.ring), s.ldw,
                         s.sf, s.stages, 0, s.chunks, my_tiles);

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = (long long)tile * T;
    load_x(x, rows, t.dims[0], row0, T, H, s.lda[0], xvec);
    for (int l = 0; l < L; ++l) {
      const int N = t.dims[l + 1];
      gemm_fwd<MT>(t, l, ring, H, s.lda[l], Z, s.ldz[l]);
      __syncthreads();
      row_stats(Z, s.ldz[l], N, T, MEAN, RSTD);
      __syncthreads();
      if (l + 1 < L)
        ln_apply<kToH>(t, l, seed, row0, rows, T, Z, s.ldz[l], MEAN, RSTD, H,
                       s.lda[l + 1], nullptr, nullptr, nullptr, 0, 0);
      else
        ln_apply<kToOut>(t, l, seed, row0, rows, T, Z, s.ldz[l], MEAN, RSTD,
                         nullptr, 0, out, nullptr, nullptr, 0, 0);
      __syncthreads();
    }
  }
}

// ------------------------------------------------------------------ B4b
// The backward's own helpers; B4f's above are left as they are.

// d += a b (bf16 m16n8k16, f32 accumulator)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ldsm_x4 with each 8x8 matrix transposed: lane l receives elements
// (2 (l % 4), l / 4) and (2 (l % 4) + 1, l / 4) of each matrix
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr) : "memory");
}

// (x0, x1) as three bf16 pairs, p1 + p2 + p3: each piece rounds to nearest
// what the pieces before it left (a remainder exact in f32), so
// |x - p1 - p2 - p3| <= 2^-24 |x|.  x0 in the low halves.
__device__ __forceinline__ void split_bf16x3(float x0, float x1, uint32_t& p1,
                                             uint32_t& p2, uint32_t& p3) {
  p1 = pack_bf16(x0, x1);
  x0 -= __uint_as_float(p1 << 16);
  x1 -= __uint_as_float(p1 & 0xFFFF0000u);
  p2 = pack_bf16(x0, x1);
  x0 -= __uint_as_float(p2 << 16);
  x1 -= __uint_as_float(p2 & 0xFFFF0000u);
  p3 = pack_bf16(x0, x1);
}

// B4b's warps a block: 16 for tiles of 64 rows, 8 for 32 or 16
__host__ __device__ constexpr int bwd_warps(int mt) { return mt == 4 ? 16 : 8; }

constexpr int kZAhead = 2;    // k steps of weight fragments in flight (z)
constexpr int kDhAhead = 2;   // depth steps of weights in flight (dh)

// Z = relu(H bf16(W) + b) for the T = 16 MT rows of the tile, formed as
// B4f's gemm_fwd forms it (the same fragments; each 16-deep product from a
// zero accumulator, added in k order in f32), so z equals B4f's bit for
// bit.  The weight fragments come from global memory (L2), made once a
// launch by tower_bwd_kernel_wprep, kZAhead k steps ahead of the products
// that use them; warp w takes the 8-column tiles w, w + NW, ... (NJ of
// them) of each pass over 8 NW NJ columns, NJ as small as covers N in one
// pass where it can.
template <int MT, int NJ>
__device__ void bwd_gemm_z(const Tower& t, int l, const uint2* __restrict__ zf,
                           const __nv_bfloat16* H, int lda, float* Z,
                           int ldz) {
  constexpr int NW = bwd_warps(MT);
  const int K = t.dims[l], N = t.dims[l + 1];
  const int kc = cdiv(K, 16), ntn = cdiv(N, 8);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const uint32_t a_base = smem_addr(H + (lane & 15) * lda + (lane >> 4) * 8);
  // fragment (n-tile nt, k step k) of this lane, zeros past W's columns
  auto frag = [&](int nt, int k) {
    return nt < ntn && k < kc ? __ldg(zf + ((long long)nt * kc + k) * 32 + lane)
                              : make_uint2(0u, 0u);
  };
  for (int nt0 = warp; nt0 < ntn; nt0 += NJ * NW) {
    float acc[MT][NJ][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.f;
    // the fragments of k steps k .. k + kZAhead - 1 in flight
    uint2 w[kZAhead][NJ];
#pragma unroll
    for (int p = 0; p < kZAhead; ++p)
#pragma unroll
      for (int j = 0; j < NJ; ++j) w[p][j] = frag(nt0 + NW * j, p);
    for (int k0 = 0; k0 < kc; k0 += kZAhead) {
#pragma unroll
      for (int p = 0; p < kZAhead; ++p) {
        const int k = k0 + p;
        if (k >= kc) break;
        uint32_t a[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
          ldsm_x4(a_base + (uint32_t)((m * 16 * lda + k * 16) * 2), a[m]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            float d[4];
            mma_bf16_zero(d, a[m], w[p][j].x, w[p][j].y);
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[m][j][i] += d[i];
          }
          w[p][j] = frag(nt0 + NW * j, k + kZAhead);
        }
      }
    }
    const float* __restrict__ bias = t.b[l];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int nt = nt0 + NW * j;
      if (nt >= ntn) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = nt * 8 + 2 * tq + (i & 1);
        if (c >= N) continue;
        const float bc = __ldg(bias + c);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int r = m * 16 + gq + (i >> 1) * 8;
          Z[r * ldz + c] = fmaxf(acc[m][j][i] + bc, 0.f);
        }
      }
    }
  }
}

// B4f's lane_sum tree across lanes: lane m = j + 4 u holds the partial of
// columns m, m + 32, ...; the three steps add them as lane_sum adds p[u],
// so quad_sum then gives row_stats' sum bit for bit.
__device__ __forceinline__ float row_tree(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// Layer l's dropout masks for the tile: one Philox draw a quad of a row,
// the keep bits of 8 quads OR-ed across their lanes into a word of BITS.
// The draws need no data, so they run beside layer l's product.
template <int MT>
__device__ void bwd_draw_bits(const Tower& t, int l, uint32_t seed,
                              long long row0, uint32_t* BITS, int wpr,
                              int woff) {
  constexpr int T = 16 * MT, NT = 32 * bwd_warps(MT);
  const int N = t.dims[l + 1], nq = cdiv(N, 4), nq8 = (nq + 7) & ~7;
  // a warp's lanes take consecutive quads of one row, 8 to a word
  for (int e = threadIdx.x; e < T * nq8; e += NT) {
    const int r = e / nq8, q = e - r * nq8;
    uint32_t keep = 0u;
    if (q < nq) {
      const uint4 w = philox4(seed, (uint32_t)l, (uint32_t)(row0 + r),
                              (uint32_t)q);
      const uint32_t th = t.threshold;
      keep = (uint32_t)(w.x < th) | (uint32_t)(w.y < th) << 1 |
             (uint32_t)(w.z < th) << 2 | (uint32_t)(w.w < th) << 3;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * q + j >= N) keep &= ~(1u << j);
    }
    uint32_t word = keep << ((q & 7) * 4);
    word |= __shfl_xor_sync(0xffffffffu, word, 1);
    word |= __shfl_xor_sync(0xffffffffu, word, 2);
    word |= __shfl_xor_sync(0xffffffffu, word, 4);
    if ((q & 7) == 0 && q < nq) BITS[r * wpr + woff + (q >> 3)] = word;
  }
}

// Layer l's row statistics and LayerNorm for the tile's T rows, warp w
// taking rows w, w + NW, ...: first each row's mean and rstd, equal to
// row_stats' (lane m sums columns m, m + 32, ... as lane_sum's partials,
// row_tree adds them in its order); then each lane takes quads lane, lane
// + 32, ... of every one of its rows (g and be loaded once): y as ln_apply
// forms it, the masks from BITS, into H as bf16 with zeros up to the next
// multiple of 16 (H null: the last layer, statistics only).
template <int MT>
__device__ void bwd_row_forward(const Tower& t, int l, const float* Z,
                                int ldz, float* MEAN, float* RSTD,
                                __nv_bfloat16* H, int lda,
                                const uint32_t* BITS, int wpr, int woff) {
  constexpr int NW = bwd_warps(MT), RW = 16 * MT / NW;   // rows a warp
  const int N = t.dims[l + 1], nq16 = ((N + 15) & ~15) / 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the warp's rows side by side, so that their chains overlap
  float mean[RW], rstd[RW], p[RW];
  const float* zr = Z + warp * ldz;
#pragma unroll
  for (int i = 0; i < RW; ++i) p[i] = 0.f;
  for (int c = lane; c < N; c += 32)
#pragma unroll
    for (int i = 0; i < RW; ++i) p[i] += zr[i * NW * ldz + c];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    mean[i] = quad_sum(row_tree(p[i])) / (float)N;
    p[i] = 0.f;
  }
  for (int c = lane; c < N; c += 32)
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const float v = zr[i * NW * ldz + c] - mean[i];
      p[i] = fmaf(v, v, p[i]);
    }
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    rstd[i] = rsqrtf(quad_sum(row_tree(p[i])) / (float)N + kEps);
    if (lane == 0) {
      MEAN[warp + NW * i] = mean[i];
      RSTD[warp + NW * i] = rstd[i];
    }
  }
  if (H == nullptr) return;
  for (int q0 = 0; q0 < nq16; q0 += 32) {
    const int q = q0 + lane, c = 4 * q;
    float g[4], be[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      g[j] = c + j < N ? __ldg(t.g[l] + c + j) : 0.f;
      be[j] = c + j < N ? __ldg(t.be[l] + c + j) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int r = warp + NW * i;
      if (q >= nq16) continue;
      const uint32_t keep =
          BITS != nullptr && c < N
              ? BITS[r * wpr + woff + (q >> 3)] >> ((q & 7) * 4) : 0xFu;
      float y[4] = {0.f, 0.f, 0.f, 0.f};
      if (c < N) {
        const float4 z4 = *reinterpret_cast<const float4*>(Z + r * ldz + c);
        const float z[4] = {z4.x, z4.y, z4.z, z4.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (c + j >= N) continue;
          float v = __fadd_rn(
              __fmul_rn(__fmul_rn(__fsub_rn(z[j], mean[i]), rstd[i]), g[j]),
              be[j]);
          if (BITS != nullptr)
            v = (keep >> j) & 1u ? __fmul_rn(v, t.inv_keep) : 0.f;
          y[j] = v;
        }
      }
      *reinterpret_cast<uint2*>(H + r * lda + c) =
          make_uint2(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]));
    }
  }
}

// Passes 1 and 2 map a lane to a row and a warp to a set of 4-column
// quads (warp w takes quads w, w + NW, ...): at T = 32 lane r takes row r;
// at T = 16 the half-warps take alternate quads of rows 0-15; at T = 64
// lane r takes rows r and r + 32.
template <int MT>
struct PassMap {
  static constexpr int T = 16 * MT, NW = bwd_warps(MT);
  static constexpr int RL = T < 32 ? T : 32;   // rows across a warp's lanes
  static constexpr int CG = 32 / RL;           // quads a warp takes at once
  static constexpr int RP = T / RL;            // rows a lane
};

// Pass 1 of layer l's backward: the dropout backward, and each row's
// partial sums of dxhat and dxhat * xhat over the warp's columns into
// PART[warp][row].
template <int MT>
__device__ void bwd_row_sums(const Tower& t, int l, const float* Z, int ldz,
                             const float* D, int ldh, const float* MEAN,
                             const float* RSTD, const uint32_t* BITS, int wpr,
                             int woff, float* PART) {
  using P = PassMap<MT>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = lane & (P::RL - 1), cg = lane / P::RL;
  const int N = t.dims[l + 1], nq = cdiv(N, 4);
  const float* __restrict__ g = t.g[l];
  float s1[P::RP], s2[P::RP];
#pragma unroll
  for (int i = 0; i < P::RP; ++i) s1[i] = s2[i] = 0.f;
  for (int q = warp * P::CG + cg; q < nq; q += P::NW * P::CG) {
    float gc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) gc[j] = 4 * q + j < N ? __ldg(g + 4 * q + j) : 0.f;
#pragma unroll
    for (int i = 0; i < P::RP; ++i) {
      const int r = r0 + 32 * i;
      const float mean = MEAN[r], rstd = RSTD[r];
      const float4 d4 = *reinterpret_cast<const float4*>(D + r * ldh + 4 * q);
      const float4 z4 = *reinterpret_cast<const float4*>(Z + r * ldz + 4 * q);
      const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
      const float zv[4] = {z4.x, z4.y, z4.z, z4.w};
      const uint32_t keep =
          BITS != nullptr ? BITS[r * wpr + woff + (q >> 3)] >> ((q & 7) * 4)
                          : 0xFu;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (4 * q + j >= N) continue;
        float d = dv[j];
        if (BITS != nullptr) d = (keep >> j) & 1u ? d * t.inv_keep : 0.f;
        const float xh = (zv[j] - mean) * rstd;
        const float dxh = d * gc[j];
        s1[i] += dxh;
        s2[i] = fmaf(dxh, xh, s2[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < P::RP; ++i) {
    if (P::CG == 2) {
      s1[i] += __shfl_xor_sync(0xffffffffu, s1[i], 16);
      s2[i] += __shfl_xor_sync(0xffffffffu, s2[i], 16);
    }
    if (cg == 0) {
      PART[(warp * P::T + r0 + 32 * i) * 2] = s1[i];
      PART[(warp * P::T + r0 + 32 * i) * 2 + 1] = s2[i];
    }
  }
}

// One level of pass 2's column sums over RL lanes: the lanes H RL / 16
// apart trade halves of their first 2 H sums; each keeps the half its bit
// selects.
template <int H, int RL>
__device__ __forceinline__ void halve(float (&v)[16], int lane) {
  const bool up = lane & (H * RL / 16);
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const float send = up ? v[k] : v[k + H];
    v[k] = (up ? v[k + H] : v[k]) +
           __shfl_xor_sync(0xffffffffu, send, H * RL / 16);
  }
}

// Pass 2, mapped as pass 1: the row means from PART (warps in order), dz
// in place of z (zeros up to the next multiple of 16 columns), and the
// vector gradients: each quad's column sums of dz, d * xhat and d over the
// tile's rows (a lane's rows first), halved across the lanes level by
// level, then the lane that holds sum k < 12 adds it into the block's
// slice (db, dg, dbe of column 4 q + k % 4; one owner an address).
template <int MT>
__device__ void bwd_dz(const Tower& t, int l, float* Z, int ldz,
                       const float* D, int ldh, const float* MEAN,
                       const float* RSTD, const uint32_t* BITS, int wpr,
                       int woff, const float* PART, float* my, bool first) {
  using P = PassMap<MT>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = lane & (P::RL - 1), cg = lane / P::RL;
  const int N = t.dims[l + 1], nq16 = ((N + 15) & ~15) / 4;
  float m1[P::RP], m2[P::RP];
#pragma unroll
  for (int i = 0; i < P::RP; ++i) {
    const int r = r0 + 32 * i;
    m1[i] = m2[i] = 0.f;
#pragma unroll
    for (int w = 0; w < P::NW; ++w) {
      m1[i] += PART[(w * P::T + r) * 2];
      m2[i] += PART[(w * P::T + r) * 2 + 1];
    }
    m1[i] /= (float)N;
    m2[i] /= (float)N;
  }
  const float* __restrict__ g = t.g[l];
  for (int q0 = warp * P::CG; q0 < nq16; q0 += P::NW * P::CG) {
    const int q = q0 + cg;
    const bool live = q < nq16 && 4 * q < N;
    float v[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) v[k] = 0.f;
    float gc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      gc[j] = live && 4 * q + j < N ? __ldg(g + 4 * q + j) : 0.f;
#pragma unroll
    for (int i = 0; i < P::RP; ++i) {
      const int r = r0 + 32 * i;
      float dz[4] = {0.f, 0.f, 0.f, 0.f};
      if (live) {
        const float mean = MEAN[r], rstd = RSTD[r];
        const float4 d4 =
            *reinterpret_cast<const float4*>(D + r * ldh + 4 * q);
        const float4 z4 =
            *reinterpret_cast<const float4*>(Z + r * ldz + 4 * q);
        const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
        const float zv[4] = {z4.x, z4.y, z4.z, z4.w};
        const uint32_t keep =
            BITS != nullptr ? BITS[r * wpr + woff + (q >> 3)] >> ((q & 7) * 4)
                            : 0xFu;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (4 * q + j >= N) continue;
          float d = dv[j];
          if (BITS != nullptr) d = (keep >> j) & 1u ? d * t.inv_keep : 0.f;
          const float xh = (zv[j] - mean) * rstd;
          const float e = rstd * (d * gc[j] - m1[i] - xh * m2[i]);
          dz[j] = zv[j] > 0.f ? e : 0.f;
          v[j] += dz[j];
          v[4 + j] += d * xh;
          v[8 + j] += d;
        }
      }
      if (q < nq16)
        *reinterpret_cast<float4*>(Z + r * ldz + 4 * q) =
            make_float4(dz[0], dz[1], dz[2], dz[3]);
    }
    // the sums over the rows: at each level a lane keeps half of its
    // values and takes its partner's sums of that half (partners 16, 8,
    // 4, 2 lanes apart, then 1; at T = 16: 8, 4, 2, 1), so lane r ends
    // with sum number r / (RL / 16) (16 of them, 12 used), in a fixed order
    halve<8, P::RL>(v, lane);
    halve<4, P::RL>(v, lane);
    halve<2, P::RL>(v, lane);
    halve<1, P::RL>(v, lane);
    if (P::RL == 32) v[0] += __shfl_xor_sync(0xffffffffu, v[0], 1);
    const int k = P::RL == 32 ? r0 >> 1 : r0;
    if (live && k < 12 && (P::RL == 16 || (r0 & 1) == 0) &&
        4 * q + (k & 3) < N)
      add_to_slice(my + (k < 4 ? t.b_off[l] : k < 8 ? t.g_off[l] : t.be_off[l])
                       + 4 * q + (k & 3), v[0], first);
  }
}

// dh of the layer below (f32 W) for the tile's rows and the k_in columns
// k0 .. k0 + 8 kDhTiles - 1, into D, or (dx given) into dx in bf16.  m16n8k8
// TF32 with both sides split (lo.hi + hi.lo + hi.hi, <= 3 * 2^-22 of |dz w|
// a product); W's split comes made (tower_bwd_kernel_wprep, in df), dz's
// is made here.  Each 16-column depth step loads a float4 of dz (rows gq,
// gq + 8 of each slab) and the hi and lo of each W row k (columns 16 s + 4
// tq .. + 3, read kDhAhead steps ahead) and feeds two instructions: the
// depth slots tq, tq + 4 of the first hold columns 4 tq, 4 tq + 1, of the
// second 4 tq + 2, 4 tq + 3 (a permutation of the sum's terms, the same on
// both sides).
constexpr int kDhTiles = 2;   // 8-column tiles of k_in a dh unit

template <int MT>
__device__ void bwd_dh_unit(const Tower& t, int l, const uint4* __restrict__ df,
                            int k0, const float* Z, int ldz, float* D,
                            int ldh, __nv_bfloat16* __restrict__ dx,
                            long long row0, int rows) {
  const int K = t.dims[l], N = t.dims[l + 1];
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int kt = cdiv(K, 8), ns = cdiv(N, 16);
  float acc[MT][kDhTiles][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < kDhTiles; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.f;
  // the TF32 hi and lo of W for step s of k_in tile j (zeros past W)
  auto load_w = [&](int s, uint4 (&w)[kDhTiles][2]) {
#pragma unroll
    for (int j = 0; j < kDhTiles; ++j) {
      const int k8 = k0 / 8 + j;
      if (k8 < kt && s < ns) {
        const uint4* p = df + (((long long)k8 * ns + s) * 32 + lane) * 2;
        w[j][0] = __ldg(p);
        w[j][1] = __ldg(p + 1);
      } else {
        w[j][0] = w[j][1] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };
  uint4 wr[kDhAhead][kDhTiles][2];  // steps s .. s + kDhAhead - 1 in flight
#pragma unroll
  for (int p = 0; p < kDhAhead; ++p) load_w(p, wr[p]);
  for (int s0 = 0; s0 < ns; s0 += kDhAhead)
#pragma unroll
  for (int p = 0; p < kDhAhead; ++p) {
    const int s = s0 + p;
    if (s >= ns) break;
    uint4 (&w)[kDhTiles][2] = wr[p];
    float4 za[MT], zb[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float* zp = Z + (m * 16 + gq) * ldz + 16 * s + 4 * tq;
      za[m] = *reinterpret_cast<const float4*>(zp);
      zb[m] = *reinterpret_cast<const float4*>(zp + 8 * ldz);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        split_tf32(h ? za[m].z : za[m].x, ah[m][0], al[m][0]);
        split_tf32(h ? zb[m].z : zb[m].x, ah[m][1], al[m][1]);
        split_tf32(h ? za[m].w : za[m].y, ah[m][2], al[m][2]);
        split_tf32(h ? zb[m].w : zb[m].y, ah[m][3], al[m][3]);
      }
#pragma unroll
      for (int j = 0; j < kDhTiles; ++j) {
        const uint32_t bh0 = h ? w[j][0].z : w[j][0].x;
        const uint32_t bh1 = h ? w[j][0].w : w[j][0].y;
        const uint32_t bl0 = h ? w[j][1].z : w[j][1].x;
        const uint32_t bl1 = h ? w[j][1].w : w[j][1].y;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma_tf32(acc[m][j], al[m], bh0, bh1);
          mma_tf32(acc[m][j], ah[m], bl0, bl1);
          mma_tf32(acc[m][j], ah[m], bh0, bh1);
        }
      }
    }
    load_w(s + kDhAhead, w);
  }
#pragma unroll
  for (int j = 0; j < kDhTiles; ++j) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = m * 16 + gq + (i >> 1) * 8;
        const int k = k0 + 8 * j + 2 * tq + (i & 1);
        if (k >= K) continue;
        if (dx == nullptr) {
          D[r * ldh + k] = acc[m][j][i];
        } else {
          const long long gr = row0 + r;
          if (gr < rows) dx[gr * K + k] = __float2bfloat16_rn(acc[m][j][i]);
        }
      }
  }
}

// dW[k][n] (+)= sum_r H[r][k] dZ[r][n] over the tile's rows for the k_in
// rows kin0 .. kin0 + 63 and the columns n0 .. n0 + 15, into the block's
// slice.  m16n8k16 bf16: h^T by ldmatrix.trans from H (h is bf16, exact);
// dz in three bf16 pieces (split_bf16x3, <= 2^-24 |dz|), so each product
// is within 2^-24 of h dz; the pieces' products are issued smallest first.
// Four columns a lane where rows are a multiple of 4 floats and the slice
// 16-byte aligned.
template <int MT>
__device__ void bwd_dw_unit(const Tower& t, int l, int kin0, int n0,
                            const __nv_bfloat16* H, int lda, const float* Z,
                            int ldz, float* __restrict__ dW, bool first) {
  const int K = t.dims[l], N = t.dims[l + 1];
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  float acc[4][2][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.f;
  // lane l addresses row l % 8 (+ 8 for matrices 2, 3) at k_in + 8 for
  // matrices 1, 3: matrix 0 is a0 (k_in 0-7, rows 0-7), 1 a1, 2 a2, 3 a3
  const int mat = lane >> 3;
  const __nv_bfloat16* ha =
      H + ((lane & 7) + (mat & 2) * 4) * lda + kin0 + (mat & 1) * 8;
#pragma unroll
  for (int ks = 0; ks < MT; ++ks) {
    uint32_t a[4][4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
      ldsm_x4_t(smem_addr(ha + ks * 16 * lda + m * 16), a[m]);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float* zc = Z + (ks * 16 + 2 * tq) * ldz + n0 + 8 * j + gq;
      uint32_t p1a, p2a, p3a, p1b, p2b, p3b;
      split_bf16x3(zc[0], zc[ldz], p1a, p2a, p3a);
      split_bf16x3(zc[8 * ldz], zc[9 * ldz], p1b, p2b, p3b);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        mma_bf16(acc[m][j], a[m], p3a, p3b);
        mma_bf16(acc[m][j], a[m], p2a, p2b);
        mma_bf16(acc[m][j], a[m], p1a, p1b);
      }
    }
  }
  const bool vec = (N & 3) == 0 && ((uintptr_t)dW & 15) == 0;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int m0 = kin0 + 16 * m;
    if (m0 >= K) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int nn = n0 + 8 * j;
      if (nn >= N) continue;
      const float(&c)[4] = acc[m][j];
      if (vec) {
        // lanes tq and tq ^ 1 trade halves: the even one takes four
        // columns of row gq, the odd one four of row gq + 8
        const bool odd = tq & 1;
        const float o0 = __shfl_xor_sync(0xffffffffu, odd ? c[0] : c[2], 1);
        const float o1 = __shfl_xor_sync(0xffffffffu, odd ? c[1] : c[3], 1);
        const int k = m0 + gq + (odd ? 8 : 0);
        const int n = nn + 2 * (tq & 2);
        const float4 v = odd ? make_float4(o0, o1, c[2], c[3])
                             : make_float4(c[0], c[1], o0, o1);
        if (k < K && n < N) add4_to_slice(dW + (long long)k * N + n, v, first);
        continue;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = m0 + gq + (i >> 1) * 8;
        const int n = nn + 2 * tq + (i & 1);
        if (k < K && n < N)
          add_to_slice(dW + (long long)k * N + n, c[i], first);
      }
    }
  }
}

// load_x for a block of NT threads.
template <int NT>
__device__ void bwd_load_x(const __nv_bfloat16* __restrict__ x, int rows,
                           int d0, long long row0, int T, __nv_bfloat16* H,
                           int lda, bool vec) {
  const int kp = (d0 + 15) & ~15;
  if (vec) {
    const int per = kp / 8;
    for (int e = threadIdx.x; e < T * per; e += NT) {
      const int r = e / per, v = e - r * per;
      const long long g = row0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (g < rows && 8 * v < d0)
        val = *reinterpret_cast<const uint4*>(x + g * d0 + 8 * v);
      *reinterpret_cast<uint4*>(H + r * lda + 8 * v) = val;
    }
  } else {
    for (int e = threadIdx.x; e < T * kp; e += NT) {
      const int r = e / kp, c = e - r * kp;
      const long long g = row0 + r;
      H[r * lda + c] =
          (g < rows && c < d0) ? x[g * d0 + c] : __float2bfloat16_rn(0.f);
    }
  }
}

// Layer l's bf16 output again, as bwd_row_forward wrote it into H (the
// same y, the masks from BITS), with zeros up to the next multiple of 16
// columns: a thread a quad of a row, g and be loaded once, NT threads.
template <int NT>
__device__ void bwd_rebuild(const Tower& t, int l, int T, const float* Z,
                            int ldz, const float* MEAN, const float* RSTD,
                            __nv_bfloat16* H, int lda, const uint32_t* BITS,
                            int wpr, int woff) {
  const int N = t.dims[l + 1], nq16 = ((N + 15) & ~15) / 4;
  int lg = 0;
  while ((1 << lg) < nq16) ++lg;
  const int q = threadIdx.x & ((1 << lg) - 1), c = 4 * q;
  if (q >= nq16) return;
  float g[4], be[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    g[j] = c + j < N ? __ldg(t.g[l] + c + j) : 0.f;
    be[j] = c + j < N ? __ldg(t.be[l] + c + j) : 0.f;
  }
  for (int r = threadIdx.x >> lg; r < T; r += NT >> lg) {
    float y[4] = {0.f, 0.f, 0.f, 0.f};
    if (c < N) {
      const float mean = MEAN[r], rstd = RSTD[r];
      const float4 z4 = *reinterpret_cast<const float4*>(Z + r * ldz + c);
      const float z[4] = {z4.x, z4.y, z4.z, z4.w};
      const uint32_t keep =
          BITS != nullptr ? BITS[r * wpr + woff + (q >> 3)] >> ((q & 7) * 4)
                          : 0xFu;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (c + j >= N) continue;
        float v = __fadd_rn(
            __fmul_rn(__fmul_rn(__fsub_rn(z[j], mean), rstd), g[j]), be[j]);
        if (BITS != nullptr)
          v = (keep >> j) & 1u ? __fmul_rn(v, t.inv_keep) : 0.f;
        y[j] = v;
      }
    }
    *reinterpret_cast<uint2*>(H + r * lda + c) =
        make_uint2(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]));
  }
}

// The backward's shared memory for a tile of T rows: f32 z (dz once
// walked) of every layer, the bf16 input of the layer at hand, the f32 dh
// coming down, and the rows' statistics, PART and masks.
struct BwdLayout {
  int ldz[kMaxLayers];   // floats per row of layer l's z
  int lda;               // halves per row of H
  int ldh;               // floats per row of D
  int wpr;               // mask words per row, all layers
  int woff[kMaxLayers];  // layer l's first mask word
  size_t z[kMaxLayers], h, d, mean, rstd, part, bits, bytes;
  // words into the weight fragments (tower_bwd_kernel_wprep) of layer l:
  // z's bf16 pairs, dh's TF32 hi and lo; their total
  long long zf[kMaxLayers], df[kMaxLayers], wwords;
};

// B4b's weight fragments, made once a launch (the weights do not change
// within it) into wf: for z, W_l rounded to bf16 as gemm_fwd rounds it, in
// its fragment order, [8-column tile][k step][lane] (b0, b1); for dh, W_l
// split in TF32 hi and lo (split_tf32), [8-row tile of k_in][16-column
// step][lane] (the hi of columns 16 s + 4 tq .. + 3, then their lo).
// Zeros past W.
__global__ void __launch_bounds__(kThreads)
tower_bwd_kernel_wprep(const __grid_constant__ Tower t,
                       const __grid_constant__ BwdLayout s,
                       uint32_t* __restrict__ wf) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long i0 = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (int l = 0; l < t.n_layers; ++l) {
    const int K = t.dims[l], N = t.dims[l + 1];
    const int kc = cdiv(K, 16), ntn = cdiv(N, 8);
    const int kt = cdiv(K, 8), ns = cdiv(N, 16);
    const float* __restrict__ W = t.w[l];
    auto at = [&](int r, int c) {
      return r < K && c < N ? __ldg(W + (long long)r * N + c) : 0.f;
    };
    uint2* zf = reinterpret_cast<uint2*>(wf + s.zf[l]);
    for (long long i = i0; i < (long long)ntn * kc * 32; i += stride) {
      const int lane = (int)(i & 31), k = (int)((i >> 5) % kc);
      const int nt = (int)((i >> 5) / kc);
      const int n = nt * 8 + (lane >> 2), r = 16 * k + 2 * (lane & 3);
      zf[i] = make_uint2(pack_bf16(at(r, n), at(r + 1, n)),
                         pack_bf16(at(r + 8, n), at(r + 9, n)));
    }
    uint4* df = reinterpret_cast<uint4*>(wf + s.df[l]);
    for (long long i = i0; i < (long long)kt * ns * 32; i += stride) {
      const int lane = (int)(i & 31), st = (int)((i >> 5) % ns);
      const int k = (int)((i >> 5) / ns) * 8 + (lane >> 2);
      const int n = 16 * st + 4 * (lane & 3);
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(at(k, n + e), hi[e], lo[e]);
      df[2 * i] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      df[2 * i + 1] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  }
}

template <int MT>
__global__ void __launch_bounds__(32 * bwd_warps(MT), 1)
tower_bwd_kernel(const __nv_bfloat16* __restrict__ x,
                 const float* __restrict__ dy,
                 const __grid_constant__ Tower t,
                 const __grid_constant__ BwdLayout s, int rows, int n_tiles,
                 const int* __restrict__ seed_p,
                 const uint32_t* __restrict__ wf,
                 __nv_bfloat16* __restrict__ dx, float* __restrict__ part) {
  constexpr int T = 16 * MT, NW = bwd_warps(MT), NT = 32 * NW;
  constexpr int MU = MT < 2 ? MT : 2;   // a dh unit's row slabs
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* H = reinterpret_cast<__nv_bfloat16*>(smem + s.h);
  float* D = reinterpret_cast<float*>(smem + s.d);
  float* MEAN = reinterpret_cast<float*>(smem + s.mean);
  float* RSTD = reinterpret_cast<float*>(smem + s.rstd);
  float* PART = reinterpret_cast<float*>(smem + s.part);
  uint32_t* BITS =
      t.use_dropout ? reinterpret_cast<uint32_t*>(smem + s.bits) : nullptr;
  const int L = t.n_layers;
  const int warp = threadIdx.x >> 5;
  const uint32_t seed = t.use_dropout ? (uint32_t)__ldg(seed_p) : 0u;
  const bool xvec = (t.dims[0] & 7) == 0 && ((uintptr_t)x & 15) == 0;
  const int nout = t.dims[L];
  const bool dyvec = (nout & 3) == 0 && ((uintptr_t)dy & 15) == 0;
  float* my = part + (long long)blockIdx.x * t.total;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const bool first = tile == (int)blockIdx.x;
    const long long row0 = (long long)tile * T;

    // ---- recompute the forward, keeping z, the row statistics, the masks
    bwd_load_x<NT>(x, rows, t.dims[0], row0, T, H, s.lda, xvec);
    __syncthreads();
    for (int l = 0; l < L; ++l) {
      float* Z = reinterpret_cast<float*>(smem + s.z[l]);
      const uint2* zf = reinterpret_cast<const uint2*>(wf + s.zf[l]);
      const int ntn = cdiv(t.dims[l + 1], 8);
      if (ntn <= NW)
        bwd_gemm_z<MT, 1>(t, l, zf, H, s.lda, Z, s.ldz[l]);
      else if (ntn <= 2 * NW)
        bwd_gemm_z<MT, 2>(t, l, zf, H, s.lda, Z, s.ldz[l]);
      else
        bwd_gemm_z<MT, 4>(t, l, zf, H, s.lda, Z, s.ldz[l]);
      if (BITS != nullptr)
        bwd_draw_bits<MT>(t, l, seed, row0, BITS, s.wpr, s.woff[l]);
      __syncthreads();
      bwd_row_forward<MT>(t, l, Z, s.ldz[l], MEAN + l * T, RSTD + l * T,
                          l + 1 < L ? H : nullptr, s.lda, BITS, s.wpr,
                          s.woff[l]);
      if (l + 1 == L) {
        // dy of the tile into D; rows past the end are zero
        if (dyvec) {
          const int per = nout >> 2;
          for (int e = threadIdx.x; e < T * per; e += NT) {
            const int r = e / per, v = e - r * per;
            const long long gr = row0 + r;
            const float4 d = gr < rows
                ? *reinterpret_cast<const float4*>(dy + gr * nout + 4 * v)
                : make_float4(0.f, 0.f, 0.f, 0.f);
            *reinterpret_cast<float4*>(D + r * s.ldh + 4 * v) = d;
          }
        } else {
          for (int e = threadIdx.x; e < T * nout; e += NT) {
            const int r = e / nout, c = e - r * nout;
            const long long gr = row0 + r;
            D[r * s.ldh + c] = gr < rows ? dy[gr * nout + c] : 0.f;
          }
        }
      }
      __syncthreads();
    }

    // ---- the layers in reverse
    for (int l = L - 1; l >= 0; --l) {
      const int K = t.dims[l], N = t.dims[l + 1], ldz = s.ldz[l];
      float* Z = reinterpret_cast<float*>(smem + s.z[l]);
      bwd_row_sums<MT>(t, l, Z, ldz, D, s.ldh, MEAN + l * T, RSTD + l * T,
                       BITS, s.wpr, s.woff[l], PART);
      // this layer's bf16 input (the last layer's is still in H): the
      // layer below's output again, or x
      if (l + 1 < L) {
        if (l > 0)
          bwd_rebuild<NT>(t, l - 1, T,
                          reinterpret_cast<const float*>(smem + s.z[l - 1]),
                          s.ldz[l - 1], MEAN + (l - 1) * T, RSTD + (l - 1) * T,
                          H, s.lda, BITS, s.wpr, s.woff[l - 1]);
        else
          bwd_load_x<NT>(x, rows, K, row0, T, H, s.lda, xvec);
      }
      __syncthreads();
      bwd_dz<MT>(t, l, Z, ldz, D, s.ldh, MEAN + l * T, RSTD + l * T, BITS,
                 s.wpr, s.woff[l], PART, my, first);
      __syncthreads();

      // dh of the layer below (or dx) and dW, in one phase: units of dh
      // (16 MU rows, 16 k_in columns) dealt to the warps in turn, then of
      // dW (64 k_in rows, 16 columns): first `extra` to each warp that took
      // one dh unit fewer (about a dh unit's work, counted in dW k steps),
      // the rest in turn.  The same warp takes a unit in every tile, so one
      // thread owns each address of the slice.
      const int kh = cdiv(K, 8 * kDhTiles), nb = cdiv(N, 16);
      const int uh = kh * (MT / MU), uw = cdiv(K, 64) * nb;
      for (int u = warp; u < uh; u += NW) {
        const int r = 16 * MU * (u / kh);
        bwd_dh_unit<MU>(t, l, reinterpret_cast<const uint4*>(wf + s.df[l]),
                        8 * kDhTiles * (u % kh), Z + r * ldz, ldz,
                        D + r * s.ldh, s.ldh, l == 0 ? dx : nullptr, row0 + r,
                        rows);
      }
      const int more = uh % NW, fewer = more ? NW - more : 0;
      const int extra =
          fewer ? min(2 * cdiv(N, 16) / (MT + 2), uw / fewer) : 0;
      const int head = extra * fewer;
      float* dW = my + t.w_off[l];
      if (warp >= more)
        for (int v = warp - more; v < head; v += fewer)
          bwd_dw_unit<MT>(t, l, 64 * (v / nb), 16 * (v % nb), H, s.lda, Z,
                          ldz, dW, first);
      for (int v = head + warp; v < uw; v += NW)
        bwd_dw_unit<MT>(t, l, 64 * (v / nb), 16 * (v % nb), H, s.lda, Z, ldz,
                        dW, first);
      __syncthreads();
    }
  }
}

// Sum of the blocks' slices in block order: out[p] = sum_b part[b][p].
__global__ void __launch_bounds__(kThreads)
reduce_partials(const float* __restrict__ part, int nblk, long long n,
                float* __restrict__ out) {
  for (long long p = (long long)blockIdx.x * kThreads + threadIdx.x; p < n;
       p += (long long)gridDim.x * kThreads) {
    float s = 0.f;
    for (int b = 0; b < nblk; ++b) s += part[(long long)b * n + p];
    out[p] = s;
  }
}

// ---------------------------------------------------------------- host

int make_tower(const float* const* params, const int* dims, int n_layers,
               int use_dropout, long long threshold, float inv_keep,
               Tower* t) {
  if (params == nullptr || dims == nullptr || n_layers < 1 ||
      n_layers > kMaxLayers)
    return 1;
  if (threshold < 0 || threshold > 0xFFFFFFFFll) return 1;
  t->n_layers = n_layers;
  for (int i = 0; i <= n_layers; ++i) {
    if (dims[i] < 1 || dims[i] > kMaxWidth) return 1;
    t->dims[i] = dims[i];
  }
  long long off = 0;
  for (int l = 0; l < n_layers; ++l) {
    const long long din = dims[l], dout = dims[l + 1];
    for (int j = 0; j < 4; ++j)
      if (params[4 * l + j] == nullptr) return 1;
    t->w[l] = params[4 * l];
    t->b[l] = params[4 * l + 1];
    t->g[l] = params[4 * l + 2];
    t->be[l] = params[4 * l + 3];
    t->vec[l] = dout % 4 == 0 && ((uintptr_t)t->w[l] & 15) == 0;
    t->w_off[l] = off;
    off += din * dout;
    t->b_off[l] = off;
    off += dout;
    t->g_off[l] = off;
    off += dout;
    t->be_off[l] = off;
    off += dout;
  }
  t->total = off;
  t->use_dropout = use_dropout ? 1 : 0;
  t->threshold = (uint32_t)threshold;
  t->inv_keep = inv_keep;
  return 0;
}

// The layout of a tile of T rows with a ring of `stages` stages.
Layout make_layout(const Tower& t, int T, int padded, bool bwd, int stages) {
  Layout s = {};
  s.stages = stages;
  const int L = t.n_layers;
  int out_max = 1, in_max = 1, lda_max = 8, ldz_max = 8;
  for (int l = 0; l < L; ++l) {
    const int K = t.dims[l], N = t.dims[l + 1];
    s.ldz[l] = fstride(N, padded);
    s.lda[l] = hstride(K, padded);
    s.woff[l] = s.wpr;
    s.wpr += cdiv(N, 32);
    s.chunks += cdiv(K, kChunkRows) * cdiv(N, kChunkCols);
    if (bwd) s.chunks += cdiv(K, kChunkCols) * cdiv(N, kDhCols);
    in_max = K > in_max ? K : in_max;
    out_max = N > out_max ? N : out_max;
    lda_max = s.lda[l] > lda_max ? s.lda[l] : lda_max;
    ldz_max = s.ldz[l] > ldz_max ? s.ldz[l] : ldz_max;
  }
  s.ldh = fstride(out_max, padded);
  s.ldw = fstride(out_max < kChunkCols ? out_max : kChunkCols, padded);
  s.sf = kChunkRows * s.ldw;
  const int dh_rows = ((in_max < kChunkCols ? in_max : kChunkCols) + 7) & ~7;
  if (bwd && dh_rows * kDhLd > s.sf) s.sf = dh_rows * kDhLd;
  size_t off = 0;
  if (bwd) {
    for (int l = 0; l < L; ++l) {
      s.z[l] = off;
      off += align16((size_t)T * s.ldz[l] * 4);
    }
  } else {
    for (int l = 0; l < L; ++l) s.z[l] = 0;
    off = align16((size_t)T * ldz_max * 4);
  }
  s.hd = off;
  size_t hd = (size_t)T * lda_max * 2;
  if (bwd && (size_t)T * s.ldh * 4 > hd) hd = (size_t)T * s.ldh * 4;
  off += align16(hd);
  s.ring = off;
  off += align16((size_t)stages * s.sf * 4);
  const int nstat = bwd ? L : 1;
  s.mean = off;
  off += align16((size_t)nstat * T * 4);
  s.rstd = off;
  off += align16((size_t)nstat * T * 4);
  s.m1 = off;
  s.m2 = off;
  s.bits = off;
  if (bwd) {
    off += align16((size_t)T * 4);
    s.m2 = off;
    off += align16((size_t)T * 4);
    s.bits = off;
    if (t.use_dropout) off += align16((size_t)T * s.wpr * 4);
  }
  s.bytes = off;
  return s;
}

// The widest tile whose layout fits in `optin` bytes with a ring of two
// stages: 64 rows, 32, 16 with padded strides, then 16 with compact ones;
// its ring then as deep as the rest of `optin` allows (at most
// kMaxStages).  Returns m-tiles (T / 16), or 0 when none fits.
int choose_layout(const Tower& t, bool bwd, int optin, Layout* s) {
  const int mts[4] = {4, 2, 1, 1}, pads[4] = {1, 1, 1, 0};
  for (int i = 0; i < 4; ++i) {
    *s = make_layout(t, 16 * mts[i], pads[i], bwd, 2);
    if (s->bytes > (size_t)optin) continue;
    const size_t stage = (size_t)s->sf * 4;
    int stages = 2 + (int)(((size_t)optin - s->bytes) / stage);
    if (stages > kMaxStages) stages = kMaxStages;
    *s = make_layout(t, 16 * mts[i], pads[i], bwd, stages);
    return mts[i];
  }
  return 0;
}

cudaError_t device_limits(int* sms, int* optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return err;
}

// Let `kernel` take `bytes` of shared memory; *occ: its blocks per SM.
template <typename K>
cudaError_t prepare(K kernel, size_t bytes, int* occ) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, kernel, kThreads,
                                                        bytes);
  if (err == cudaSuccess && *occ < 1) err = cudaErrorInvalidConfiguration;
  return err;
}

template <int MT>
cudaError_t run_fwd(const Tower& t, const Layout& s, int sms,
                    const __nv_bfloat16* x, int rows, const int* seed,
                    float* out, cudaStream_t stream) {
  int occ = 0;
  cudaError_t err = prepare(tower_fwd_kernel<MT>, s.bytes, &occ);
  if (err != cudaSuccess) return err;
  const int tiles = cdiv(rows, 16 * MT);
  const int grid = tiles < sms * occ ? tiles : sms * occ;
  tower_fwd_kernel<MT><<<grid, kThreads, s.bytes, stream>>>(
      x, t, s, rows, tiles, seed, out);
  return cudaGetLastError();
}

int bwd_fstride(int n, int padded) {
  return padded ? ((n + 31) & ~31) + 4 : (n + 15) & ~15;
}

// halves a row of H: whole 64-column blocks (dW reads four 16-column
// tiles a unit), padded as hstride pads
int bwd_hstride(int k, int padded) {
  return ((k + 63) & ~63) + (padded ? 8 : 0);
}

// The backward's layout of a tile of T rows.  Padded strides keep pass 1
// and 2 (a lane a row, 16-byte loads), the row pass and the ldmatrix
// loads free of bank conflicts (f32 rows == 4 mod 32 words, bf16 rows ==
// 8 mod 64 halves); compact ones round to 16 columns.
BwdLayout make_bwd_layout(const Tower& t, int T, int padded) {
  BwdLayout s = {};
  const int L = t.n_layers;
  int in_max = 1, out_max = 1;
  size_t off = 0;
  for (int l = 0; l < L; ++l) {
    const int K = t.dims[l], N = t.dims[l + 1];
    s.ldz[l] = bwd_fstride(N, padded);
    s.z[l] = off;
    off += align16((size_t)T * s.ldz[l] * 4);
    s.woff[l] = s.wpr;
    s.wpr += cdiv(N, 32);
    in_max = K > in_max ? K : in_max;
    out_max = N > out_max ? N : out_max;
  }
  s.lda = bwd_hstride(in_max, padded);
  s.ldh = bwd_fstride(out_max, padded);
  s.h = off;
  off += align16((size_t)T * s.lda * 2);
  s.d = off;
  off += align16((size_t)T * s.ldh * 4);
  s.mean = off;
  off += align16((size_t)L * T * 4);
  s.rstd = off;
  off += align16((size_t)L * T * 4);
  s.part = off;
  off += align16((size_t)bwd_warps(T / 16) * T * 2 * 4);
  s.bits = off;
  if (t.use_dropout) off += align16((size_t)T * s.wpr * 4);
  s.bytes = off;
  long long w = 0;
  for (int l = 0; l < L; ++l) {
    const int K = t.dims[l], N = t.dims[l + 1];
    s.zf[l] = w;
    w += 64LL * cdiv(N, 8) * cdiv(K, 16);
    s.df[l] = w;
    w += 256LL * cdiv(K, 8) * cdiv(N, 16);
  }
  s.wwords = w;
  return s;
}

// The backward's tile: the widest whose layout fits in `optin` bytes, 64
// rows (16 warps), 32 or 16 with padded strides (8 warps), then 16 with
// compact ones.  Returns m-tiles (T / 16), or 0 when none fits.
int choose_bwd_layout(const Tower& t, int optin, BwdLayout* s) {
  const int mts[4] = {4, 2, 1, 1}, pads[4] = {1, 1, 1, 0};
  for (int i = 0; i < 4; ++i) {
    *s = make_bwd_layout(t, 16 * mts[i], pads[i]);
    if (s->bytes <= (size_t)optin) return mts[i];
  }
  return 0;
}

template <int MT>
cudaError_t run_bwd(const Tower& t, const BwdLayout& s, int sms,
                    int max_blocks, const __nv_bfloat16* x, const float* dy,
                    int rows, const int* seed, const uint32_t* wf,
                    float* part, __nv_bfloat16* dx, int* nblk, int* occ_out,
                    cudaStream_t stream, bool launch) {
  constexpr int NT = 32 * bwd_warps(MT);
  auto kernel = tower_bwd_kernel<MT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s.bytes);
  int occ = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, NT,
                                                        s.bytes);
  if (err == cudaSuccess && occ < 1) err = cudaErrorInvalidConfiguration;
  if (err != cudaSuccess) return err;
  const int tiles = cdiv(rows, 16 * MT);
  int n = sms * occ;
  if (n > tiles) n = tiles;
  if (n > max_blocks) n = max_blocks;
  *nblk = n;
  *occ_out = occ;
  if (!launch) return cudaSuccess;
  kernel<<<n, NT, s.bytes, stream>>>(x, dy, t, s, rows, tiles, seed, wf,
                                     dx, part);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: bf16 [rows, dims[0]]; params: a host array of 4 * n_layers device
// pointers, per layer W [dims[l], dims[l+1]], b, g, be [dims[l+1]], all
// f32 and contiguous; dims: host int [n_layers + 1], each in [1, 512],
// n_layers <= 16; seed: device int32 (read only when use_dropout); out: f32
// [rows, dims[n_layers]].  Returns a cudaError_t (0 on success).
int ncf_tower_fwd(const void* x, const float* const* params, const int* dims,
                  int n_layers, int rows, const int* seed, int use_dropout,
                  long long threshold, float inv_keep, float* out,
                  void* stream) {
  Tower t;
  if (rows < 1 || make_tower(params, dims, n_layers, use_dropout, threshold,
                             inv_keep, &t) != 0)
    return (int)cudaErrorInvalidValue;
  if (use_dropout && seed == nullptr) return (int)cudaErrorInvalidValue;
  int sms = 0, optin = 0;
  cudaError_t err = device_limits(&sms, &optin);
  if (err != cudaSuccess) return (int)err;
  Layout s;
  const int mt = choose_layout(t, false, optin, &s);
  const __nv_bfloat16* xb = (const __nv_bfloat16*)x;
  cudaStream_t st = (cudaStream_t)stream;
  switch (mt) {
    case 4: return (int)run_fwd<4>(t, s, sms, xb, rows, seed, out, st);
    case 2: return (int)run_fwd<2>(t, s, sms, xb, rows, seed, out, st);
    case 1: return (int)run_fwd<1>(t, s, sms, xb, rows, seed, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// B4b's schedule for this tower and these rows: out[0] the tile's rows,
// out[1] its blocks an SM, out[2] the blocks (gradient slices) a launch
// takes, out[3] the scratch floats ncf_tower_bwd needs for them.
// params and dims as for ncf_tower_fwd.  Returns a cudaError_t.
int ncf_tower_bwd_plan(const float* const* params, const int* dims,
                       int n_layers, int rows, int use_dropout,
                       long long* out) {
  Tower t;
  if (rows < 1 || out == nullptr ||
      make_tower(params, dims, n_layers, use_dropout, 0, 1.f, &t) != 0)
    return (int)cudaErrorInvalidValue;
  int sms = 0, optin = 0;
  cudaError_t err = device_limits(&sms, &optin);
  if (err != cudaSuccess) return (int)err;
  BwdLayout s;
  const int mt = choose_bwd_layout(t, optin, &s);
  int nblk = 0, occ = 0;
  const int most = 4 * sms;
  if (mt == 4)
    err = run_bwd<4>(t, s, sms, most, nullptr, nullptr, rows, nullptr,
                     nullptr, nullptr, nullptr, &nblk, &occ, nullptr, false);
  else if (mt == 2)
    err = run_bwd<2>(t, s, sms, most, nullptr, nullptr, rows, nullptr,
                     nullptr, nullptr, nullptr, &nblk, &occ, nullptr, false);
  else if (mt == 1)
    err = run_bwd<1>(t, s, sms, most, nullptr, nullptr, rows, nullptr,
                     nullptr, nullptr, nullptr, &nblk, &occ, nullptr, false);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  out[0] = 16 * mt;
  out[1] = occ;
  out[2] = nblk;
  out[3] = s.wwords + (long long)nblk * t.total;
  return 0;
}

// x: bf16 [rows, dims[0]]; dy: f32 [rows, dims[n_layers]]; params, dims as
// for ncf_tower_fwd; scratch: scratch_floats f32, at least the weight
// fragments' words (per layer 64 ceil(N/8) ceil(K/16) + 256 ceil(K/8)
// ceil(N/16), K x N the layer's W) and max_blocks slices of P floats, P
// the count of all parameters; grads: f32 [P], per layer W, b, g, be packed
// in that order; dx: bf16 [rows, dims[0]].  ncf_tower_bwd_plan gives the
// blocks it takes and the scratch it needs.
int ncf_tower_bwd(const void* x, const float* dy, const float* const* params,
                  const int* dims, int n_layers, int rows, const int* seed,
                  int use_dropout, long long threshold, float inv_keep,
                  int max_blocks, float* scratch, long long scratch_floats,
                  float* grads, void* dx, void* stream) {
  Tower t;
  if (rows < 1 || max_blocks < 1 ||
      make_tower(params, dims, n_layers, use_dropout, threshold, inv_keep,
                 &t) != 0)
    return (int)cudaErrorInvalidValue;
  if (use_dropout && seed == nullptr) return (int)cudaErrorInvalidValue;
  int sms = 0, optin = 0;
  cudaError_t err = device_limits(&sms, &optin);
  if (err != cudaSuccess) return (int)err;
  BwdLayout s;
  const int mt = choose_bwd_layout(t, optin, &s);
  if (mt == 0 || s.wwords + (long long)max_blocks * t.total > scratch_floats)
    return (int)cudaErrorInvalidValue;
  const __nv_bfloat16* xb = (const __nv_bfloat16*)x;
  __nv_bfloat16* dxb = (__nv_bfloat16*)dx;
  cudaStream_t st = (cudaStream_t)stream;
  // the weight fragments first, then one slice of the gradients a block
  uint32_t* wf = reinterpret_cast<uint32_t*>(scratch);
  float* part = scratch + s.wwords;
  const long long pblocks = (s.wwords / 4 + kThreads - 1) / kThreads;
  tower_bwd_kernel_wprep<<<(int)(pblocks < 1024 ? pblocks : 1024), kThreads,
                           0, st>>>(t, s, wf);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int nblk = 0, occ = 0;
  if (mt == 4)
    err = run_bwd<4>(t, s, sms, max_blocks, xb, dy, rows, seed, wf, part,
                     dxb, &nblk, &occ, st, true);
  else if (mt == 2)
    err = run_bwd<2>(t, s, sms, max_blocks, xb, dy, rows, seed, wf, part,
                     dxb, &nblk, &occ, st, true);
  else
    err = run_bwd<1>(t, s, sms, max_blocks, xb, dy, rows, seed, wf, part,
                     dxb, &nblk, &occ, st, true);
  if (err != cudaSuccess) return (int)err;
  const long long want = (t.total + kThreads - 1) / kThreads;
  const int grid = (int)(want < 1024 ? want : 1024);
  reduce_partials<<<grid, kThreads, 0, st>>>(part, nblk, t.total, grads);
  return (int)cudaGetLastError();
}

const char* ncf_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
