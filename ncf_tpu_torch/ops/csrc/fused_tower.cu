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
// Design.  A block of 8 warps takes tiles of T = 64 rows (32 or 16 where
// shared memory is short) and stays resident, walking tiles blockIdx.x,
// blockIdx.x + gridDim.x, ...; a tile's activations never leave shared
// memory.  The weights stream through a cp.async ring (2 to 8 stages, as
// deep as the shared memory left by the tile allows), in f32 as the caller
// holds them (16-byte copies where rows and pointer allow): for z, chunks
// of 16 rows x at most 256 columns of W_l; for dh, up to 256 rows x 16
// columns.  Each chunk is read once per tile by the whole block, and the
// next chunks (of the same product, the next layer or the next tile) are
// in flight while one is in use.  Products, by mma.sync:
//   z = h bf16(W): m16n8k16 bf16.  h by ldmatrix; W rounded to bf16 pairs
//     as its fragments are read.  Every warp takes all rows of the tile
//     and the 8-column slices w, w + 8, ... of the output, so each weight
//     fragment serves four row slabs.  Each 16-deep product starts from a
//     zero accumulator and is added to the row's sum in f32 (the tensor
//     core's own running sum rounds less exactly).
//   dW = h^T dz: m16n8k8 tf32.  h (bf16) is exact in TF32; dz = hi + lo
//     with hi = tf32_rna(dz), lo = tf32_rna(dz - hi), and h.lo + h.hi; the
//     split leaves |dz - hi - lo| <= 2^-22 |dz|, so each product is within
//     2^-22 of its value (two TF32 products: dz stays f32 in shared
//     memory, where dh reads it too).  A warp takes two row slabs of W and
//     four 8-column slices.
//   dh = dz W^T: m16n8k8 tf32 with both sides split, lo.hi + hi.lo +
//     hi.hi; the dropped lo.lo and the two splits leave <= 3 * 2^-22 of
//     |dz w| a product.  One TF32 product would leave up to 2^-10.  A warp
//     takes every row slab and four 8-column slices of a 256-column pass.
// All sums are f32.  LayerNorm statistics take four lanes a row (32
// partial sums); LayerNorm, dropout and the bf16 rounding of the next
// input take a thread per four columns.  Weight gradients: each block adds
// its tiles into its own f32 slice of a scratch buffer (stored on its
// first tile, then added by reductions that wait for nothing: 16 bytes a
// lane for dW where rows allow, a thread a column for db, dg, dbe; one
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

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
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

// dW[k][n] (+)= sum_r H[r][k] dZ[r][n] over the T rows of the tile, into
// the block's slice; four columns a lane where rows are a multiple of 4
// floats and the slice 16-byte aligned.
template <int MT>
__device__ void gemm_dw(const Tower& t, int l, const __nv_bfloat16* H, int lda,
                        const float* Z, int ldz, float* __restrict__ dW,
                        bool first) {
  const int K = t.dims[l], N = t.dims[l + 1];
  const int mtk = cdiv(K, 16), ntn = cdiv(N, 8), ngr = cdiv(ntn, 4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const bool vec = (N & 3) == 0 && ((uintptr_t)dW & 15) == 0;
  for (int grp = warp; grp < cdiv(mtk, 2) * ngr; grp += kWarps) {
    const int mp = (grp / ngr) * 32, nt0 = (grp % ngr) * 4;
    const int nm = mp + 16 < K ? 2 : 1;   // row slabs of W in the group
    float acc2[2][4][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc2[h][j][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 2 * MT; ++ks) {
      const int r = ks * 8 + tq;
      uint32_t a[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const __nv_bfloat16* h0 = H + r * lda + mp + 16 * h + gq;
        const __nv_bfloat16* h1 = h0 + 4 * lda;
        a[h][0] = __float_as_uint(__bfloat162float(h0[0]));
        a[h][1] = __float_as_uint(__bfloat162float(h0[8]));
        a[h][2] = __float_as_uint(__bfloat162float(h1[0]));
        a[h][3] = __float_as_uint(__bfloat162float(h1[8]));
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (nt0 + j < ntn) {
          const float* z = Z + r * ldz + (nt0 + j) * 8 + gq;
          uint32_t hi0, lo0, hi1, lo1;
          split_tf32(z[0], hi0, lo0);
          split_tf32(z[4 * ldz], hi1, lo1);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (h < nm) {
              mma_tf32(acc2[h][j], a[h], lo0, lo1);
              mma_tf32(acc2[h][j], a[h], hi0, hi1);
            }
          }
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h >= nm) continue;
      const int m0 = mp + 16 * h;
      const float(&acc)[4][4] = acc2[h];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (vec) {
          // lanes tq and tq ^ 1 trade halves: the even one takes four
          // columns of row gq, the odd one four of row gq + 8
          const bool odd = tq & 1;
          const float o0 =
              __shfl_xor_sync(0xffffffffu, odd ? acc[j][0] : acc[j][2], 1);
          const float o1 =
              __shfl_xor_sync(0xffffffffu, odd ? acc[j][1] : acc[j][3], 1);
          const int k = m0 + gq + (odd ? 8 : 0);
          const int n = (nt0 + j) * 8 + 2 * (tq & 2);
          const float4 v = odd ? make_float4(o0, o1, acc[j][2], acc[j][3])
                               : make_float4(acc[j][0], acc[j][1], o0, o1);
          if (k < K && n < N)
            add4_to_slice(dW + (long long)k * N + n, v, first);
          continue;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = m0 + gq + (i >> 1) * 8;
          const int n = (nt0 + j) * 8 + 2 * tq + (i & 1);
          if (k < K && n < N)
            add_to_slice(dW + (long long)k * N + n, acc[j][i], first);
        }
      }
    }
  }
}

// dh[r][k] = sum_n dZ[r][n] W[k][n] with the f32 weight, into DH, or for
// the first layer into dx (bf16, global): 256 columns k a pass, each pass
// over ring chunks of 16 columns n of those rows of W.  dZ is zero from N
// to the next multiple of 8.  Warp w takes every row slab and the 8-column
// slices w, w + 8, w + 16, w + 24 of the pass, so each split fragment of
// W serves MT row slabs and each of dZ up to four slices.
template <int MT>
__device__ void gemm_dh(const Tower& t, int l, Ring& ring, const float* Z,
                        int ldz, float* DH, int ldh,
                        __nv_bfloat16* __restrict__ dx, long long row0,
                        int rows) {
  constexpr int kNt = kChunkCols / 8 / kWarps;
  const int K = t.dims[l], N = t.dims[l + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int nc = cdiv(N, kDhCols);
  for (int q = 0; q < cdiv(K, kChunkCols); ++q) {
    const int kp0 = q * kChunkCols;
    const int ktn = cdiv(min(kChunkCols, K - kp0), 8);
    float acc[MT][kNt][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < kNt; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.f;
    for (int c = 0; c < nc; ++c) {
      const float* S = ring_acquire(t, ring);
      if (warp >= ktn) continue;
      const int n0 = c * kDhCols;
      const int steps = min(kDhCols / 8, cdiv(N - n0, 8));
      for (int ks = 0; ks < steps; ++ks) {
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float* za = Z + (m * 16 + gq) * ldz + n0 + 8 * ks + tq;
          split_tf32(za[0], ah[m][0], al[m][0]);
          split_tf32(za[8 * ldz], ah[m][1], al[m][1]);
          split_tf32(za[4], ah[m][2], al[m][2]);
          split_tf32(za[8 * ldz + 4], ah[m][3], al[m][3]);
        }
#pragma unroll
        for (int j = 0; j < kNt; ++j) {
          const int nt = warp + kWarps * j;
          if (nt < ktn) {
            const float* wb = S + (nt * 8 + gq) * kDhLd + 8 * ks + tq;
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(wb[0], bh0, bl0);
            split_tf32(wb[4], bh1, bl1);
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              mma_tf32(acc[m][j], al[m], bh0, bh1);
              mma_tf32(acc[m][j], ah[m], bl0, bl1);
              mma_tf32(acc[m][j], ah[m], bh0, bh1);
            }
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
      const int nt = warp + kWarps * j;
      if (nt >= ktn) continue;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = m * 16 + gq + (i >> 1) * 8;
          const int k = kp0 + nt * 8 + 2 * tq + (i & 1);
          if (k >= K) continue;
          if (dx == nullptr) {
            DH[r * ldh + k] = acc[m][j][i];
          } else {
            const long long g = row0 + r;
            if (g < rows) dx[g * K + k] = __float2bfloat16_rn(acc[m][j][i]);
          }
        }
    }
  }
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

template <int MT>
__global__ void __launch_bounds__(kThreads, 1)
tower_bwd_kernel(const __nv_bfloat16* __restrict__ x,
                 const float* __restrict__ dy,
                 const __grid_constant__ Tower t,
                 const __grid_constant__ Layout s, int rows, int n_tiles,
                 const int* __restrict__ seed_p,
                 __nv_bfloat16* __restrict__ dx, float* __restrict__ part) {
  constexpr int T = 16 * MT;
  extern __shared__ __align__(16) unsigned char smem[];
  // H (a layer's bf16 input) and DH (f32 dh) share one region: H is dead
  // from dW's end to the next rebuild, DH from the column pass to dh.
  __nv_bfloat16* H = reinterpret_cast<__nv_bfloat16*>(smem + s.hd);
  float* DH = reinterpret_cast<float*>(smem + s.hd);
  float* MEAN = reinterpret_cast<float*>(smem + s.mean);
  float* RSTD = reinterpret_cast<float*>(smem + s.rstd);
  float* M1 = reinterpret_cast<float*>(smem + s.m1);
  float* M2 = reinterpret_cast<float*>(smem + s.m2);
  uint32_t* BITS =
      t.use_dropout ? reinterpret_cast<uint32_t*>(smem + s.bits) : nullptr;
  const int L = t.n_layers;
  const int ldh = s.ldh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t seed = t.use_dropout ? (uint32_t)__ldg(seed_p) : 0u;
  const bool xvec = (t.dims[0] & 7) == 0 && ((uintptr_t)x & 15) == 0;
  const int nout = t.dims[L];
  const bool dyvec = (nout & 3) == 0 && ((uintptr_t)dy & 15) == 0;
  float* my = part + (long long)blockIdx.x * t.total;
  const int my_tiles = cdiv(n_tiles - (int)blockIdx.x, (int)gridDim.x);
  Ring ring = ring_start(t, reinterpret_cast<float*>(smem + s.ring), s.ldw,
                         s.sf, s.stages, 1, s.chunks, my_tiles);

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const bool first = tile == (int)blockIdx.x;
    const long long row0 = (long long)tile * T;

    // ---- recompute the forward, keeping z, the row statistics, the masks
    load_x(x, rows, t.dims[0], row0, T, H, s.lda[0], xvec);
    for (int l = 0; l < L; ++l) {
      const int N = t.dims[l + 1];
      float* Z = reinterpret_cast<float*>(smem + s.z[l]);
      gemm_fwd<MT>(t, l, ring, H, s.lda[l], Z, s.ldz[l]);
      __syncthreads();
      row_stats(Z, s.ldz[l], N, T, MEAN + l * T, RSTD + l * T);
      __syncthreads();
      if (l + 1 < L)
        ln_apply<kToH>(t, l, seed, row0, rows, T, Z, s.ldz[l], MEAN + l * T,
                       RSTD + l * T, H, s.lda[l + 1], nullptr, nullptr, BITS,
                       s.wpr, s.woff[l]);
      else if (t.use_dropout)
        ln_apply<kBitsOnly>(t, l, seed, row0, rows, T, Z, s.ldz[l],
                            MEAN + l * T, RSTD + l * T, nullptr, 0, nullptr,
                            nullptr, BITS, s.wpr, s.woff[l]);
      __syncthreads();
    }

    // ---- dy of the tile; rows past the end are zero
    if (dyvec) {
      const int per = nout >> 2;
      for (int e = threadIdx.x; e < T * per; e += kThreads) {
        const int r = e / per, v = e - r * per;
        const long long gr = row0 + r;
        const float4 d = gr < rows
            ? *reinterpret_cast<const float4*>(dy + gr * nout + 4 * v)
            : make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(DH + r * ldh + 4 * v) = d;
      }
    } else {
      for (int e = threadIdx.x; e < T * nout; e += kThreads) {
        const int r = e / nout, c = e - r * nout;
        const long long gr = row0 + r;
        DH[r * ldh + c] = gr < rows ? dy[gr * nout + c] : 0.f;
      }
    }
    __syncthreads();

    // ---- the layers in reverse
    for (int l = L - 1; l >= 0; --l) {
      const int K = t.dims[l], N = t.dims[l + 1], ldz = s.ldz[l];
      float* Z = reinterpret_cast<float*>(smem + s.z[l]);
      const float* __restrict__ g = t.g[l];
      const float* mean_l = MEAN + l * T;
      const float* rstd_l = RSTD + l * T;

      // dropout backward in place; the row means of dxhat and dxhat * xhat
      // (four lanes a row, eight rows a warp at once)
      for (int r0 = warp * 8; r0 < T; r0 += kWarps * 8) {
        const int r = r0 + (lane >> 2);
        const float mean = mean_l[r], rstd = rstd_l[r];
        const uint32_t* br =
            BITS != nullptr ? BITS + r * s.wpr + s.woff[l] : nullptr;
        float s1 = 0.f, s2 = 0.f;
        for (int c = lane & 3; c < N; c += 4) {
          float d = DH[r * ldh + c];
          if (br != nullptr) {
            d = (br[c >> 5] >> (c & 31)) & 1u ? d * t.inv_keep : 0.f;
            DH[r * ldh + c] = d;
          }
          const float xh = (Z[r * ldz + c] - mean) * rstd;
          const float dxh = d * __ldg(g + c);
          s1 += dxh;
          s2 = fmaf(dxh, xh, s2);
        }
        s1 = quad_sum(s1);
        s2 = quad_sum(s2);
        if ((lane & 3) == 0) {
          M1[r] = s1 / (float)N;
          M2[r] = s2 / (float)N;
        }
      }
      __syncthreads();

      // dz in place of z (a thread per column, zeros up to the next
      // multiple of 8), and the vector gradients in row order
      for (int c = threadIdx.x; c < ((N + 7) & ~7); c += kThreads) {
        if (c >= N) {
          for (int r = 0; r < T; ++r) Z[r * ldz + c] = 0.f;
          continue;
        }
        const float gc = __ldg(g + c);
        float db = 0.f, dg = 0.f, dbe = 0.f;
        for (int r = 0; r < T; ++r) {
          const float d = DH[r * ldh + c];
          const float z = Z[r * ldz + c];
          const float rstd = rstd_l[r];
          const float xh = (z - mean_l[r]) * rstd;
          dg = fmaf(d, xh, dg);
          dbe += d;
          float dz = rstd * (d * gc - M1[r] - xh * M2[r]);
          dz = z > 0.f ? dz : 0.f;
          Z[r * ldz + c] = dz;
          db += dz;
        }
        add_to_slice(my + t.b_off[l] + c, db, first);
        add_to_slice(my + t.g_off[l] + c, dg, first);
        add_to_slice(my + t.be_off[l] + c, dbe, first);
      }
      __syncthreads();

      // this layer's bf16 input: x, or the layer below's output again
      if (l > 0)
        ln_apply<kToH>(t, l - 1, seed, row0, rows, T,
                       reinterpret_cast<const float*>(smem + s.z[l - 1]),
                       s.ldz[l - 1], MEAN + (l - 1) * T, RSTD + (l - 1) * T,
                       H, s.lda[l], nullptr, BITS, nullptr, s.wpr,
                       s.woff[l - 1]);
      else
        load_x(x, rows, K, row0, T, H, s.lda[0], xvec);
      __syncthreads();

      gemm_dw<MT>(t, l, H, s.lda[l], Z, ldz, my + t.w_off[l], first);
      __syncthreads();

      // dh of the layer below (f32 weights), or dx for the first layer
      gemm_dh<MT>(t, l, ring, Z, ldz, DH, ldh, l == 0 ? dx : nullptr, row0,
                  rows);
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

template <int MT>
cudaError_t run_bwd(const Tower& t, const Layout& s, int sms, int max_blocks,
                    const __nv_bfloat16* x, const float* dy, int rows,
                    const int* seed, float* scratch, __nv_bfloat16* dx,
                    int* nblk, cudaStream_t stream) {
  int occ = 0;
  cudaError_t err = prepare(tower_bwd_kernel<MT>, s.bytes, &occ);
  if (err != cudaSuccess) return err;
  const int tiles = cdiv(rows, 16 * MT);
  int n = sms * occ;
  if (n > tiles) n = tiles;
  if (n > max_blocks) n = max_blocks;
  *nblk = n;
  tower_bwd_kernel<MT><<<n, kThreads, s.bytes, stream>>>(
      x, dy, t, s, rows, tiles, seed, dx, scratch);
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

// x: bf16 [rows, dims[0]]; dy: f32 [rows, dims[n_layers]]; params, dims as
// for ncf_tower_fwd; scratch: f32 [max_blocks, P] where P is the count of
// all parameters; grads: f32 [P], per layer W, b, g, be packed in that
// order; dx: bf16 [rows, dims[0]].
int ncf_tower_bwd(const void* x, const float* dy, const float* const* params,
                  const int* dims, int n_layers, int rows, const int* seed,
                  int use_dropout, long long threshold, float inv_keep,
                  int max_blocks, float* scratch, float* grads, void* dx,
                  void* stream) {
  Tower t;
  if (rows < 1 || max_blocks < 1 ||
      make_tower(params, dims, n_layers, use_dropout, threshold, inv_keep,
                 &t) != 0)
    return (int)cudaErrorInvalidValue;
  if (use_dropout && seed == nullptr) return (int)cudaErrorInvalidValue;
  int sms = 0, optin = 0;
  cudaError_t err = device_limits(&sms, &optin);
  if (err != cudaSuccess) return (int)err;
  Layout s;
  const int mt = choose_layout(t, true, optin, &s);
  const __nv_bfloat16* xb = (const __nv_bfloat16*)x;
  __nv_bfloat16* dxb = (__nv_bfloat16*)dx;
  cudaStream_t st = (cudaStream_t)stream;
  int nblk = 0;
  switch (mt) {
    case 4:
      err = run_bwd<4>(t, s, sms, max_blocks, xb, dy, rows, seed, scratch,
                       dxb, &nblk, st);
      break;
    case 2:
      err = run_bwd<2>(t, s, sms, max_blocks, xb, dy, rows, seed, scratch,
                       dxb, &nblk, st);
      break;
    case 1:
      err = run_bwd<1>(t, s, sms, max_blocks, xb, dy, rows, seed, scratch,
                       dxb, &nblk, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const long long want = (t.total + kThreads - 1) / kThreads;
  const int grid = (int)(want < 1024 ? want : 1024);
  reduce_partials<<<grid, kThreads, 0, st>>>(scratch, nblk, t.total, grads);
  return (int)cudaGetLastError();
}

const char* ncf_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
