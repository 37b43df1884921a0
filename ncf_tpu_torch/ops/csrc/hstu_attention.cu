// HSTU's jagged causal attention (ops/hstu_attention.py): forward and
// backward on bf16 tensor cores (wmma m16n16k16, f32 accumulation).
//
// Sequences of different lengths are packed end to end: token rows
// [start, start + L) of q, k, v (f32, row stride ld_in floats, head h at
// columns h * D) form one sequence.  For each head,
//
//   A[i, j] = SiLU(q_i . k_j + rab[i, j]) / N   for j <= i < L, else 0,
//   rab[i, j] = w_pos[N - 1 + j - i] + w_ts[b(t_{i+1} - t_j)],
//   b(x) = clamp(floor(ln(max(|x|, 1)) / 0.301), 0, 128),  t_L := t_{L-1},
//   out_i = sum_j A[i, j] v_j.
//
// Tiles are 64 queries x 64 keys; no [L, L] matrix reaches memory.  A
// launch walks a table of tiles made on the host (ops/hstu_attention.py:
// (start, L, t) int32 rows, longest work first), so that no block is
// spent on a tile wholly above the diagonal or past a sequence's end.
//
// The head width D (25 in HSTU-large) is not a multiple of the 16-wide k
// step: each operand row is converted to bf16 on its way into shared
// memory and padded with zeros to kDim = 32 columns, so the padding adds
// nothing to a product (and is no useful work in benchmark/'s counts).
// A is rounded to bf16 for its product with v, as the backward's dS and
// dO are for theirs.
//
// Backward, two passes that each recompute the scores:
//   dkdv: a block a (key tile, head), over the query tiles at or below the
//         diagonal: dV += A^T dO, dK += dS^T Q;
//   dq:   a block a query tile, both heads, over its key tiles from the
//         diagonal down: dQ += dS K, and the bias tables' partial sums.
// dS = dA * SiLU'(z) / N with dA = dO V^T.  The bias gradients use no
// atomics: a dq block sums each diagonal i - j of its tile (two per
// thread, a fixed order) and writes every d once to its own row of
// partials; each query row's w_ts buckets fall as j rises (the
// timestamps do not decrease), so a thread a row sums runs of equal
// buckets into its own row of a [64, 129] array.  The reduce kernels then
// add the blocks' partials in table order, in groups of 64 and then the
// groups: the bits do not depend on the run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kRows = 64;            // queries and keys a tile
constexpr int kDim = 32;             // the head width, padded
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kLdh = kDim + 8;       // bf16 operand tiles' row stride
constexpr int kLdp = kRows + 8;      // bf16 score tiles' row stride
constexpr int kLdf = kRows + 4;      // f32 score tiles' row stride
constexpr int kBuckets = 129;
constexpr int kGroup = 64;           // blocks' partials a reduce thread adds

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragAT = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                              wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                              wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

constexpr int kOpBytes = kRows * kLdh * 2;     // a bf16 operand tile
constexpr int kScoreF = kRows * kLdf * 4;      // an f32 score tile
constexpr int kScoreH = kRows * kLdp * 2;      // a bf16 score tile

__device__ __forceinline__ int ts_bucket(long long dt) {
  if (dt < 0) dt = -dt;
  if (dt < 1) dt = 1;
  const float b = floorf(logf((float)dt) / 0.301f);
  return (int)fminf(fmaxf(b, 0.f), (float)(kBuckets - 1));
}

// rows [0, valid) of one head's tile, columns [0, D), into bf16 shared
// memory padded with zeros
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const float* __restrict__ src,
                                          long long ld, int valid, int D) {
  for (int e = threadIdx.x; e < kRows * kDim; e += kThreads) {
    const int r = e >> 5, c = e & 31;
    const float v = (r < valid && c < D) ? __ldg(src + r * ld + c) : 0.f;
    dst[r * kLdh + c] = __float2bfloat16_rn(v);
  }
}

// t_{i+1} (t_L := t_{L-1}) of the query rows i0.., and t_j of the keys
__device__ __forceinline__ void load_times(long long* tq, long long* tk,
                                           const long long* __restrict__ ts,
                                           int start, int L, int i0,
                                           int j0) {
  const int x = threadIdx.x;
  if (x < kRows) {
    const int i = min(i0 + x + 1, L - 1);
    tq[x] = __ldg(ts + start + i);
  } else if (x < 2 * kRows) {
    const int j = min(j0 + x - kRows, L - 1);
    tk[x - kRows] = __ldg(ts + start + j);
  }
}

// S[64, 64] = X Y^T: a warp two 16 x 16 blocks of one 16-row band
__device__ __forceinline__ void scores(float* S, const __nv_bfloat16* X,
                                       const __nv_bfloat16* Y) {
  const int w = threadIdx.x >> 5;
  const int rb = w >> 1;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int cb = (w & 1) * 2 + h;
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < kDim; kk += 16) {
      FragA a;
      FragBT b;
      wmma::load_matrix_sync(a, X + rb * 16 * kLdh + kk, kLdh);
      wmma::load_matrix_sync(b, Y + cb * 16 * kLdh + kk, kLdh);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(S + rb * 16 * kLdf + cb * 16, acc, kLdf,
                            wmma::mem_row_major);
  }
}

// acc (the warp's 16 x 16 block of a [64, 32] result) += P Y
__device__ __forceinline__ void times(FragC& acc, const __nv_bfloat16* P,
                                      const __nv_bfloat16* Y) {
  const int w = threadIdx.x >> 5;
  const int rb = w >> 1, cb = w & 1;
#pragma unroll
  for (int kk = 0; kk < kRows; kk += 16) {
    FragA a;
    FragB b;
    wmma::load_matrix_sync(a, P + rb * 16 * kLdp + kk, kLdp);
    wmma::load_matrix_sync(b, Y + kk * kLdh + cb * 16, kLdh);
    wmma::mma_sync(acc, a, b, acc);
  }
}

// acc += P^T Y
__device__ __forceinline__ void times_t(FragC& acc, const __nv_bfloat16* P,
                                        const __nv_bfloat16* Y) {
  const int w = threadIdx.x >> 5;
  const int rb = w >> 1, cb = w & 1;
#pragma unroll
  for (int kk = 0; kk < kRows; kk += 16) {
    FragAT a;
    FragB b;
    wmma::load_matrix_sync(a, P + kk * kLdp + rb * 16, kLdp);
    wmma::load_matrix_sync(b, Y + kk * kLdh + cb * 16, kLdh);
    wmma::mma_sync(acc, a, b, acc);
  }
}

// the warp's block of a [64, 32] result to rows [0, valid), columns
// [0, D) of dst, staged through the f32 tile F
__device__ __forceinline__ void store_result(float* F, const FragC& acc,
                                             float* __restrict__ dst,
                                             long long ld, int valid,
                                             int D) {
  const int w = threadIdx.x >> 5;
  const int rb = w >> 1, cb = w & 1;
  __syncthreads();
  wmma::store_matrix_sync(F + rb * 16 * kLdf + cb * 16, acc, kLdf,
                          wmma::mem_row_major);
  __syncthreads();
  for (int e = threadIdx.x; e < kRows * kDim; e += kThreads) {
    const int r = e >> 5, c = e & 31;
    if (r < valid && c < D) dst[r * ld + c] = F[r * kLdf + c];
  }
}

struct Args {
  const int* tiles;            // int32 [n, 3]: start, L, tile
  const float* q;
  const float* k;
  const float* v;
  long long ld_in;
  const float* dout;           // [T, H * D]
  const long long* ts;         // int64 [T]
  const float* w_pos;          // [2N - 1]
  const float* w_ts;           // [129]
  int H, D, N;
  float inv_n;
};

// z = score + rab at (r, c) of the tile whose rows start at i0 and
// columns at j0; false where the pair is masked
__device__ __forceinline__ bool biased(const Args& a, const float* wts,
                                       const long long* tq,
                                       const long long* tk, int L, int i0,
                                       int j0, int r, int c, float s,
                                       float& z, int& bucket) {
  const int i = i0 + r, j = j0 + c;
  if (j > i || i >= L) return false;
  bucket = ts_bucket(tq[r] - tk[c]);
  z = s + __ldg(a.w_pos + (a.N - 1 - (i - j))) + wts[bucket];
  return true;
}

__device__ __forceinline__ float sigmoid(float z) {
  return __fdividef(1.f, 1.f + __expf(-z));
}

__global__ void __launch_bounds__(kThreads)
hstu_attn_fwd_kernel(Args a, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = (__nv_bfloat16*)smem;
  __nv_bfloat16* Ks = (__nv_bfloat16*)(smem + kOpBytes);
  __nv_bfloat16* Vs = (__nv_bfloat16*)(smem + 2 * kOpBytes);
  float* Sf = (float*)(smem + 3 * kOpBytes);
  __nv_bfloat16* P = (__nv_bfloat16*)(smem + 3 * kOpBytes + kScoreF);
  long long* tq = (long long*)(smem + 3 * kOpBytes + kScoreF + kScoreH);
  long long* tk = tq + kRows;
  float* wts = (float*)(tk + kRows);

  const int* tl = a.tiles + 3 * blockIdx.x;
  const int start = tl[0], L = tl[1], t = tl[2];
  const int h = blockIdx.y;
  const int i0 = t * kRows;
  const long long hq = (long long)start * a.ld_in + h * a.D;
  load_tile(Qs, a.q + hq + (long long)i0 * a.ld_in, a.ld_in,
            min(kRows, L - i0), a.D);
  for (int x = threadIdx.x; x < kBuckets; x += kThreads)
    wts[x] = __ldg(a.w_ts + x);
  FragC acc;
  wmma::fill_fragment(acc, 0.f);
  for (int jt = 0; jt <= t; ++jt) {
    const int j0 = jt * kRows;
    __syncthreads();
    load_tile(Ks, a.k + hq + (long long)j0 * a.ld_in, a.ld_in,
              min(kRows, L - j0), a.D);
    load_tile(Vs, a.v + hq + (long long)j0 * a.ld_in, a.ld_in,
              min(kRows, L - j0), a.D);
    load_times(tq, tk, a.ts, start, L, i0, j0);
    __syncthreads();
    scores(Sf, Qs, Ks);
    __syncthreads();
    for (int e = threadIdx.x; e < kRows * kRows; e += kThreads) {
      const int r = e >> 6, c = e & 63;
      float z, p = 0.f;
      int b;
      if (biased(a, wts, tq, tk, L, i0, j0, r, c, Sf[r * kLdf + c], z, b))
        p = z * sigmoid(z) * a.inv_n;
      P[r * kLdp + c] = __float2bfloat16_rn(p);
    }
    __syncthreads();
    times(acc, P, Vs);
  }
  const long long ho = (long long)start * a.H * a.D + h * a.D;
  store_result(Sf, acc, out + ho + (long long)i0 * a.H * a.D, a.H * a.D,
               min(kRows, L - i0), a.D);
}

// dS (into Sf, f32, 0 where masked) and the bf16 tiles of A (into P, when
// given) and of dS (into G) from the scores in Sf and dA in dAf
__device__ __forceinline__ void backward_tile(const Args& a, const float* wts,
                                              const long long* tq,
                                              const long long* tk, int L,
                                              int i0, int j0, float* Sf,
                                              const float* dAf,
                                              __nv_bfloat16* P,
                                              __nv_bfloat16* G,
                                              unsigned char* bk) {
  for (int e = threadIdx.x; e < kRows * kRows; e += kThreads) {
    const int r = e >> 6, c = e & 63;
    float z, p = 0.f, ds = 0.f;
    int b = 0;
    if (biased(a, wts, tq, tk, L, i0, j0, r, c, Sf[r * kLdf + c], z, b)) {
      const float sg = sigmoid(z);
      p = z * sg * a.inv_n;
      ds = dAf[r * kLdf + c] * sg * (1.f + z * (1.f - sg)) * a.inv_n;
    }
    if (P != nullptr) P[r * kLdp + c] = __float2bfloat16_rn(p);
    G[r * kLdp + c] = __float2bfloat16_rn(ds);
    Sf[r * kLdf + c] = ds;
    if (bk != nullptr) bk[r * kRows + c] = (unsigned char)b;
  }
}

__global__ void __launch_bounds__(kThreads)
hstu_attn_bwd_dkdv_kernel(Args a, float* __restrict__ dk,
                          float* __restrict__ dv) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Ks = (__nv_bfloat16*)smem;
  __nv_bfloat16* Vs = (__nv_bfloat16*)(smem + kOpBytes);
  __nv_bfloat16* Qs = (__nv_bfloat16*)(smem + 2 * kOpBytes);
  __nv_bfloat16* Os = (__nv_bfloat16*)(smem + 3 * kOpBytes);
  float* Sf = (float*)(smem + 4 * kOpBytes);
  float* dAf = (float*)(smem + 4 * kOpBytes + kScoreF);
  __nv_bfloat16* P = (__nv_bfloat16*)(smem + 4 * kOpBytes + 2 * kScoreF);
  __nv_bfloat16* G = P + kRows * kLdp;
  long long* tq = (long long*)(smem + 4 * kOpBytes + 2 * kScoreF +
                               2 * kScoreH);
  long long* tk = tq + kRows;
  float* wts = (float*)(tk + kRows);

  const int* tl = a.tiles + 3 * blockIdx.x;
  const int start = tl[0], L = tl[1], t = tl[2];
  const int h = blockIdx.y;
  const int j0 = t * kRows;
  const int ldo = a.H * a.D;
  const long long hq = (long long)start * a.ld_in + h * a.D;
  const long long ho = (long long)start * ldo + h * a.D;
  load_tile(Ks, a.k + hq + (long long)j0 * a.ld_in, a.ld_in,
            min(kRows, L - j0), a.D);
  load_tile(Vs, a.v + hq + (long long)j0 * a.ld_in, a.ld_in,
            min(kRows, L - j0), a.D);
  for (int x = threadIdx.x; x < kBuckets; x += kThreads)
    wts[x] = __ldg(a.w_ts + x);
  FragC dK, dV;
  wmma::fill_fragment(dK, 0.f);
  wmma::fill_fragment(dV, 0.f);
  const int nq = (L + kRows - 1) / kRows;
  for (int it = t; it < nq; ++it) {
    const int i0 = it * kRows;
    const int valid = min(kRows, L - i0);
    __syncthreads();
    load_tile(Qs, a.q + hq + (long long)i0 * a.ld_in, a.ld_in, valid, a.D);
    load_tile(Os, a.dout + ho + (long long)i0 * ldo, ldo, valid, a.D);
    load_times(tq, tk, a.ts, start, L, i0, j0);
    __syncthreads();
    scores(Sf, Qs, Ks);
    scores(dAf, Os, Vs);
    __syncthreads();
    backward_tile(a, wts, tq, tk, L, i0, j0, Sf, dAf, P, G, nullptr);
    __syncthreads();
    times_t(dV, P, Os);
    times_t(dK, G, Qs);
  }
  const int valid = min(kRows, L - j0);
  store_result(Sf, dK, dk + ho + (long long)j0 * ldo, ldo, valid, a.D);
  store_result(Sf, dV, dv + ho + (long long)j0 * ldo, ldo, valid, a.D);
}

__global__ void __launch_bounds__(kThreads)
hstu_attn_bwd_dq_kernel(Args a, float* __restrict__ dq,
                        float* __restrict__ part_pos,
                        float* __restrict__ part_ts) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = (__nv_bfloat16*)smem;
  __nv_bfloat16* Os = (__nv_bfloat16*)(smem + kOpBytes);
  __nv_bfloat16* Ks = (__nv_bfloat16*)(smem + 2 * kOpBytes);
  __nv_bfloat16* Vs = (__nv_bfloat16*)(smem + 3 * kOpBytes);
  float* Sf = (float*)(smem + 4 * kOpBytes);
  float* dAf = (float*)(smem + 4 * kOpBytes + kScoreF);
  __nv_bfloat16* G = (__nv_bfloat16*)(smem + 4 * kOpBytes + 2 * kScoreF);
  unsigned char* bk = smem + 4 * kOpBytes + 2 * kScoreF + kScoreH;
  long long* tq = (long long*)(bk + kRows * kRows);
  long long* tk = tq + kRows;
  float* wts = (float*)(tk + kRows);
  float* tsacc = wts + 132;              // [64][129]

  const int* tl = a.tiles + 3 * blockIdx.x;
  const int start = tl[0], L = tl[1], t = tl[2];
  const int i0 = t * kRows;
  const int valid = min(kRows, L - i0);
  const int ldo = a.H * a.D;
  const int x = threadIdx.x;
  for (int e = x; e < kBuckets; e += kThreads) wts[e] = __ldg(a.w_ts + e);
  for (int e = x; e < kRows * kBuckets; e += kThreads) tsacc[e] = 0.f;
  float* my_pos = part_pos + (long long)blockIdx.x * a.N;
  FragC dQ[2];
  wmma::fill_fragment(dQ[0], 0.f);
  wmma::fill_fragment(dQ[1], 0.f);
  float carry = 0.f;                     // diagonal thread m = x < 64
  for (int jt = t; jt >= 0; --jt) {
    const int j0 = jt * kRows;
    const int kd = t - jt;               // i - j = 64 kd + (r - c)
    float c_lo = 0.f, c_hi = 0.f;
    for (int h = 0; h < a.H; ++h) {
      const long long hq = (long long)start * a.ld_in + h * a.D;
      const long long ho = (long long)start * ldo + h * a.D;
      __syncthreads();
      load_tile(Qs, a.q + hq + (long long)i0 * a.ld_in, a.ld_in, valid,
                a.D);
      load_tile(Os, a.dout + ho + (long long)i0 * ldo, ldo, valid, a.D);
      load_tile(Ks, a.k + hq + (long long)j0 * a.ld_in, a.ld_in,
                min(kRows, L - j0), a.D);
      load_tile(Vs, a.v + hq + (long long)j0 * a.ld_in, a.ld_in,
                min(kRows, L - j0), a.D);
      load_times(tq, tk, a.ts, start, L, i0, j0);
      __syncthreads();
      scores(Sf, Qs, Ks);
      scores(dAf, Os, Vs);
      __syncthreads();
      backward_tile(a, wts, tq, tk, L, i0, j0, Sf, dAf, nullptr, G, bk);
      __syncthreads();
      times(dQ[h], G, Ks);
      if (x < kRows) {
        // the diagonals r - c = x (d = 64 kd + x) and x - 64
        for (int r = x; r < kRows; ++r) c_hi += Sf[r * kLdf + r - x];
        for (int r = 0; r < x; ++r) c_lo += Sf[r * kLdf + r + kRows - x];
      } else if (x < 2 * kRows) {
        // row r's runs of equal buckets, in column order
        const int r = x - kRows;
        const int i = i0 + r;
        float* acc = tsacc + r * kBuckets;
        int cur = -1;
        float run = 0.f;
        const int cmax = min(kRows, i - j0 + 1);
        if (i < L) {
          for (int c = 0; c < cmax; ++c) {
            const int b = bk[r * kRows + c];
            if (b != cur) {
              if (cur >= 0) acc[cur] += run;
              cur = b;
              run = 0.f;
            }
            run += Sf[r * kLdf + c];
          }
          if (cur >= 0) acc[cur] += run;
        }
      }
    }
    if (x < kRows) {
      if (kd > 0) {
        const int d = kRows * (kd - 1) + x;
        if (d < a.N) my_pos[d] = carry + c_lo;
      }
      carry = c_hi;
    }
  }
  if (x < kRows) {
    const int d = kRows * t + x;
    if (d < a.N) my_pos[d] = carry;
  }
  __syncthreads();
  if (x < kBuckets) {
    float s = 0.f;
    for (int r = 0; r < kRows; ++r) s += tsacc[r * kBuckets + x];
    part_ts[(long long)blockIdx.x * kBuckets + x] = s;
  }
  for (int h = 0; h < a.H; ++h) {
    const long long ho = (long long)start * ldo + h * a.D;
    store_result(Sf, dQ[h], dq + ho + (long long)i0 * ldo, ldo, valid, a.D);
  }
}

// Stage 1: mid[z][g][col] = the sum over blocks [64 g, 64 g + 64) in
// order of their partials (z 0: w_pos's diagonals, written below
// 64 (t + 1); z 1: w_ts's buckets).  Stage 2: each column's sum over g in
// order, w_pos's diagonal d at N - 1 - d.
template <int kStage>
__global__ void __launch_bounds__(128)
hstu_bias_reduce_kernel(const int* __restrict__ tiles, int n, int N,
                        const float* __restrict__ part_pos,
                        const float* __restrict__ part_ts,
                        float* __restrict__ mid, int groups,
                        float* __restrict__ dw_pos,
                        float* __restrict__ dw_ts) {
  const int z = blockIdx.z;
  const int W = z == 0 ? N : kBuckets;
  const int col = blockIdx.x * 128 + threadIdx.x;
  if (col >= W) return;
  float* m = mid + (long long)z * groups * N;
  if (kStage == 1) {
    const int g = blockIdx.y;
    const float* part = z == 0 ? part_pos : part_ts;
    float s = 0.f;
    for (int c = g * kGroup; c < min(n, (g + 1) * kGroup); ++c) {
      if (z == 0 && col >= kRows * (tiles[3 * c + 2] + 1)) continue;
      s += part[(long long)c * W + col];
    }
    m[(long long)g * N + col] = s;
  } else {
    float s = 0.f;
    for (int g = 0; g < groups; ++g) s += m[(long long)g * N + col];
    if (z == 0)
      dw_pos[N - 1 - col] = s;
    else
      dw_ts[col] = s;
  }
}

constexpr int kFwdSmem = 3 * kOpBytes + kScoreF + kScoreH + 2 * kRows * 8 +
                         132 * 4;
constexpr int kDkdvSmem = 4 * kOpBytes + 2 * kScoreF + 2 * kScoreH +
                          2 * kRows * 8 + 132 * 4;
constexpr int kDqSmem = 4 * kOpBytes + 2 * kScoreF + kScoreH +
                        kRows * kRows + 2 * kRows * 8 + 132 * 4 +
                        kRows * kBuckets * 4;

cudaError_t allow_smem(const void* fn, int bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// floats of scratch the backward needs for n query tiles: the blocks'
// partials of w_pos and w_ts, and the reduce's group sums
long long scratch_floats_for(int n, int N) {
  const long long groups = (n + kGroup - 1) / kGroup;
  return (long long)n * N + (long long)n * kBuckets + 2 * groups * N;
}

bool check(int n, int H, int D, int N) {
  return n >= 0 && H >= 1 && D >= 1 && D <= kDim && N >= 1;
}

}  // namespace

extern "C" {

// The forward: tiles int32 [n, 3] (start, L, tile) of the query tiles;
// q, k, v f32 with row stride ld_in floats, head h at column h * D;
// ts int64 [T]; w_pos f32 [2N - 1]; w_ts f32 [129]; out f32 [T, H * D].
// Returns a cudaError_t (0 on success).
int ncf_hstu_attn_fwd(const int* tiles, int n, const float* q,
                      const float* k, const float* v, long long ld_in,
                      const long long* ts, const float* w_pos,
                      const float* w_ts, int H, int D, int N, float* out,
                      void* stream) {
  if (!check(n, H, D, N)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  static const cudaError_t attr =
      allow_smem((const void*)hstu_attn_fwd_kernel, kFwdSmem);
  if (attr != cudaSuccess) return (int)attr;
  Args a = {tiles, q, k, v, ld_in, nullptr, ts, w_pos, w_ts, H, D, N,
            1.f / (float)N};
  hstu_attn_fwd_kernel<<<dim3(n, H), kThreads, kFwdSmem,
                         (cudaStream_t)stream>>>(a, out);
  return (int)cudaGetLastError();
}

// The backward: q_tiles (the forward's table) and k_tiles int32 [n, 3];
// dout f32 [T, H * D]; dq, dk, dv f32 [T, H * D]; scratch f32 of
// n N + 129 n + 2 N ceil(n / 64) floats; dw_pos f32 [2N - 1] (its entries
// N..2N-2 are left as they are: no pair reaches them), dw_ts f32 [129].
int ncf_hstu_attn_bwd(const int* q_tiles, const int* k_tiles, int n,
                      const float* q, const float* k, const float* v,
                      long long ld_in, const float* dout,
                      const long long* ts, const float* w_pos,
                      const float* w_ts, int H, int D, int N, float* dq,
                      float* dk, float* dv, float* scratch,
                      long long scratch_floats, float* dw_pos, float* dw_ts,
                      void* stream) {
  if (!check(n, H, D, N)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  if (scratch_floats < scratch_floats_for(n, N))
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr1 =
      allow_smem((const void*)hstu_attn_bwd_dkdv_kernel, kDkdvSmem);
  static const cudaError_t attr2 =
      allow_smem((const void*)hstu_attn_bwd_dq_kernel, kDqSmem);
  if (attr1 != cudaSuccess) return (int)attr1;
  if (attr2 != cudaSuccess) return (int)attr2;
  cudaStream_t s = (cudaStream_t)stream;
  Args a = {nullptr, q, k, v, ld_in, dout, ts, w_pos, w_ts, H, D, N,
            1.f / (float)N};
  a.tiles = k_tiles;
  hstu_attn_bwd_dkdv_kernel<<<dim3(n, H), kThreads, kDkdvSmem, s>>>(a, dk,
                                                                     dv);
  a.tiles = q_tiles;
  float* part_pos = scratch;
  float* part_ts = part_pos + (long long)n * N;
  float* mid = part_ts + (long long)n * kBuckets;
  hstu_attn_bwd_dq_kernel<<<n, kThreads, kDqSmem, s>>>(a, dq, part_pos,
                                                       part_ts);
  const int groups = (n + kGroup - 1) / kGroup;
  const dim3 g1((N + 127) / 128, groups, 2), g2((N + 127) / 128, 1, 2);
  hstu_bias_reduce_kernel<1><<<g1, 128, 0, s>>>(
      q_tiles, n, N, part_pos, part_ts, mid, groups, dw_pos, dw_ts);
  hstu_bias_reduce_kernel<2><<<g2, 128, 0, s>>>(
      q_tiles, n, N, part_pos, part_ts, mid, groups, dw_pos, dw_ts);
  return (int)cudaGetLastError();
}

const char* ncf_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
