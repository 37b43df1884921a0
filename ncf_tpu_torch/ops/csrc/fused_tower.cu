// Fused MLP tower, forward (B4f) and backward (B4b), for NVIDIA Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels of ncf_tpu/ops/pallas_tower.py::fused_tower:
// the forward pallas_call in _pallas_fwd (pallas_tower.py:306, body
// _make_fwd_kernel :94 via _layer_fwd :59) and the backward one in
// _pallas_bwd (:325, body _make_bwd_kernel :115).
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
// Dropout: Philox4x32-10 with key (seed, layer) and counter (row, col / 4,
// 0, 0); element (row, col) takes word col % 4 and is kept iff it is below
// `threshold` = min(floor(keep * 2^32), 2^32 - 1).  The seed is read from
// device memory (no host synchronisation); the backward regenerates the
// same masks, so none is stored.  ops/tower.py::philox4x32 computes the
// same bits with tensor arithmetic.
//
// What bounds it on this card: the forward's bf16 products take 2.15 GFLOP
// at [16384, 96 -> 256 -> 128 -> 64] (2.2 us at 989 TFLOP/s) against 7.3 MB
// of x and y (2.2 us at 3.35 TB/s); the backward's f32 products (twice the
// forward's work) take 64 us at 67 TFLOP/s, so the backward is bound by
// operations as long as it keeps the reference's f32 products.
//
// Design (right and simple first): one block of 8 warps per tile of
// T = 32 rows (16 where shared memory is short).  The tile's activations
// never leave shared memory; weights stream from global memory, where the
// whole tower (0.33 MB in f32 at an input of 160) stays in L1/L2.  The
// products are plain f32 FMAs over bf16 values widened to f32: every
// bf16 x bf16 product is exact in f32, so this is the tensor cores'
// function up to the order of the sums.  Each warp owns T/8 rows and
// computes 4 columns per lane, 128 columns at a time; LayerNorm statistics
// take a warp per row.  The backward runs one persistent block per slot the
// card holds; each block adds its tiles' weight gradients into its own f32
// slice of a scratch buffer, and a second pass adds the slices in a fixed
// order, so the result does not depend on scheduling.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLayers = 16;
constexpr int kMaxWidth = 512;
constexpr int kMaxSmem = 232448;  // 227 KB, the most a block may take
constexpr float kEps = 1e-5f;

struct Tower {
  int n_layers;
  int dims[kMaxLayers + 1];
  long long w_off[kMaxLayers];    // packed params: W, b, g, be per layer
  long long b_off[kMaxLayers];
  long long g_off[kMaxLayers];
  long long be_off[kMaxLayers];
  long long wt_off[kMaxLayers];   // packed transposed weights W^T [out, in]
  long long total;                // floats in the packed params
  int in_max;                     // max of dims[0 .. L-1]
  int hid_max;                    // max of dims[1 .. L-1] (1 when L == 1)
  int out_max;                    // max of dims[1 .. L]
  int all_max;                    // max of dims[0 .. L]
  int use_dropout;
  uint32_t threshold;
  float inv_keep;
};

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }
__host__ __device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Philox4x32-10 (Salmon et al., SC'11), counter (row, col / 4, 0, 0), key
// (seed, layer); the word col % 4 of the result.
__device__ __forceinline__ uint32_t philox_bits(uint32_t seed, uint32_t layer,
                                                uint32_t row, uint32_t col) {
  uint32_t c0 = row, c1 = col >> 2, c2 = 0u, c3 = 0u;
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
  const uint32_t w = col & 3u;
  return w == 0 ? c0 : w == 1 ? c1 : w == 2 ? c2 : c3;
}

// LayerNorm output of one element, then dropout; the multiplies and adds
// are rounded one by one (no contraction), as the plain version does them.
__device__ __forceinline__ float ln_dropout(const Tower& t, uint32_t seed,
                                            int layer, long long row, int col,
                                            float z, float mean, float rstd,
                                            float g, float be) {
  float y = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(z, mean), rstd), g), be);
  if (t.use_dropout) {
    const uint32_t bits =
        philox_bits(seed, (uint32_t)layer, (uint32_t)row, (uint32_t)col);
    y = bits < t.threshold ? __fmul_rn(y, t.inv_keep) : 0.f;
  }
  return y;
}

// Mean and rstd of one row of n values (the calling warp, all lanes).
__device__ __forceinline__ void row_stats(const float* z, int n, float& mean,
                                          float& rstd) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int c = lane; c < n; c += 32) s += z[c];
  mean = warp_sum(s) / (float)n;
  float v = 0.f;
  for (int c = lane; c < n; c += 32) {
    const float d = z[c] - mean;
    v = fmaf(d, d, v);
  }
  rstd = rsqrtf(warp_sum(v) / (float)n + kEps);
}

// x rows [row0, row0 + T) into hT ([D0][T] bf16, transposed); rows past
// the end are zero.
template <int T>
__device__ void load_x(const __nv_bfloat16* __restrict__ x, int rows, int d0,
                       long long row0, __nv_bfloat16* hT) {
  for (int idx = threadIdx.x; idx < T * d0; idx += kThreads) {
    const int r = idx / d0, c = idx - r * d0;
    const long long g = row0 + r;
    hT[c * T + r] = g < rows ? x[g * d0 + c] : __float2bfloat16_rn(0.f);
  }
}

// Z[r][c] = relu(sum_k A[k][r] * bf16(W[k][c]) + b[c]) for the warp's rows,
// A bf16 transposed ([K][T]), W f32 [K][N] in global memory.
template <int RPW>
__device__ void gemm_fwd(const __nv_bfloat16* A, int K,
                         const float* __restrict__ W,
                         const float* __restrict__ b, int N, float* Z,
                         int ldz) {
  constexpr int T = RPW * kWarps;
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * RPW;
  for (int cc = 0; cc < N; cc += 128) {
    float acc[RPW][4];
    int col[4];
    bool ok[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      col[j] = cc + lane + 32 * j;
      ok[j] = col[j] < N;
#pragma unroll
      for (int i = 0; i < RPW; ++i) acc[i][j] = 0.f;
    }
    // four steps of k in flight: the loads of W are the latency to hide
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float a[RPW];
#pragma unroll
      for (int i = 0; i < RPW; ++i) a[i] = __bfloat162float(A[k * T + r0 + i]);
      const float* wrow = W + (long long)k * N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float w = ok[j] ? bf16r(__ldg(wrow + col[j])) : 0.f;
#pragma unroll
        for (int i = 0; i < RPW; ++i) acc[i][j] = fmaf(a[i], w, acc[i][j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!ok[j]) continue;
      const float bias = __ldg(b + col[j]);
#pragma unroll
      for (int i = 0; i < RPW; ++i)
        Z[(r0 + i) * ldz + col[j]] = fmaxf(acc[i][j] + bias, 0.f);
    }
  }
}

// C[r][d] = sum_c Z[r][c] * Wt[c][d] for the warp's rows: Z f32 [T][ldz]
// in shared memory, Wt f32 [N][K] in global memory.  Writes C into
// shared memory (dh, [T][ldc]) or, for the first layer, dx (bf16, global).
template <int RPW>
__device__ void gemm_bwd_dh(const float* Z, int ldz, int N,
                            const float* __restrict__ Wt, int K, float* C,
                            int ldc, __nv_bfloat16* __restrict__ dx,
                            long long row0, int rows) {
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * RPW;
  for (int dd = 0; dd < K; dd += 128) {
    float acc[RPW][4];
    int col[4];
    bool ok[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      col[j] = dd + lane + 32 * j;
      ok[j] = col[j] < K;
#pragma unroll
      for (int i = 0; i < RPW; ++i) acc[i][j] = 0.f;
    }
#pragma unroll 4
    for (int c = 0; c < N; ++c) {
      float a[RPW];
#pragma unroll
      for (int i = 0; i < RPW; ++i) a[i] = Z[(r0 + i) * ldz + c];
      const float* wrow = Wt + (long long)c * K;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float w = ok[j] ? __ldg(wrow + col[j]) : 0.f;
#pragma unroll
        for (int i = 0; i < RPW; ++i) acc[i][j] = fmaf(a[i], w, acc[i][j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!ok[j]) continue;
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        if (dx == nullptr) {
          C[(r0 + i) * ldc + col[j]] = acc[i][j];
        } else {
          const long long g = row0 + r0 + i;
          if (g < rows) dx[g * K + col[j]] = __float2bfloat16_rn(acc[i][j]);
        }
      }
    }
  }
}

// ------------------------------------------------------------- forward

template <int RPW>
__global__ void __launch_bounds__(kThreads)
tower_fwd_kernel(const __nv_bfloat16* __restrict__ x,
                 const float* __restrict__ P, const __grid_constant__ Tower t,
                 int rows, const int* __restrict__ seed_p,
                 float* __restrict__ out) {
  constexpr int T = RPW * kWarps;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* hT = reinterpret_cast<__nv_bfloat16*>(smem);
  float* Z = reinterpret_cast<float*>(
      smem + align16((size_t)t.in_max * T * sizeof(__nv_bfloat16)));
  const int ldz = round4(t.out_max);
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * RPW;
  const long long row0 = (long long)blockIdx.x * T;
  const uint32_t seed = t.use_dropout ? (uint32_t)__ldg(seed_p) : 0u;

  load_x<T>(x, rows, t.dims[0], row0, hT);
  __syncthreads();
  for (int l = 0; l < t.n_layers; ++l) {
    const int K = t.dims[l], N = t.dims[l + 1];
    gemm_fwd<RPW>(hT, K, P + t.w_off[l], P + t.b_off[l], N, Z, ldz);
    __syncthreads();
    const float* g = P + t.g_off[l];
    const float* be = P + t.be_off[l];
    const bool last = l + 1 == t.n_layers;
    for (int i = 0; i < RPW; ++i) {
      const int r = r0 + i;
      const long long grow = row0 + r;
      const float* zr = Z + r * ldz;
      float mean, rstd;
      row_stats(zr, N, mean, rstd);
      for (int c = lane; c < N; c += 32) {
        const float y = ln_dropout(t, seed, l, grow, c, zr[c], mean, rstd,
                                   __ldg(g + c), __ldg(be + c));
        if (last) {
          if (grow < rows) out[grow * N + c] = y;
        } else {
          hT[c * T + r] = __float2bfloat16_rn(y);
        }
      }
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------ backward

struct BwdLayout {
  size_t x, h, z[kMaxLayers], mean, rstd, m1, m2, dh, bytes;
};

__host__ __device__ inline BwdLayout bwd_layout(const Tower& t, int T) {
  BwdLayout s;
  size_t off = 0;
  s.x = off;
  off += align16((size_t)t.dims[0] * T * 2);
  s.h = off;
  off += align16((size_t)t.hid_max * T * 2);
  for (int l = 0; l < t.n_layers; ++l) {
    s.z[l] = off;
    off += (size_t)T * round4(t.dims[l + 1]) * 4;
  }
  s.mean = off;
  off += align16((size_t)t.n_layers * T * 4);
  s.rstd = off;
  off += align16((size_t)t.n_layers * T * 4);
  s.m1 = off;
  off += align16((size_t)T * 4);
  s.m2 = off;
  off += align16((size_t)T * 4);
  s.dh = off;
  off += (size_t)T * round4(t.all_max) * 4;
  s.bytes = off;
  return s;
}

__device__ __forceinline__ void put(float* p, float v, bool first) {
  *p = first ? v : *p + v;
}

template <int RPW>
__global__ void __launch_bounds__(kThreads)
tower_bwd_kernel(const __nv_bfloat16* __restrict__ x,
                 const float* __restrict__ dy, const float* __restrict__ P,
                 const float* __restrict__ PT,
                 const __grid_constant__ Tower t, int rows,
                 int n_tiles, const int* __restrict__ seed_p,
                 __nv_bfloat16* __restrict__ dx, float* __restrict__ part) {
  constexpr int T = RPW * kWarps;
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdLayout s = bwd_layout(t, T);
  __nv_bfloat16* X = reinterpret_cast<__nv_bfloat16*>(smem + s.x);
  __nv_bfloat16* H = reinterpret_cast<__nv_bfloat16*>(smem + s.h);
  float* MEAN = reinterpret_cast<float*>(smem + s.mean);
  float* RSTD = reinterpret_cast<float*>(smem + s.rstd);
  float* M1 = reinterpret_cast<float*>(smem + s.m1);
  float* M2 = reinterpret_cast<float*>(smem + s.m2);
  float* DH = reinterpret_cast<float*>(smem + s.dh);
  const int ldh = round4(t.all_max);
  const int L = t.n_layers;
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * RPW;
  const uint32_t seed = t.use_dropout ? (uint32_t)__ldg(seed_p) : 0u;
  float* my = part + (long long)blockIdx.x * t.total;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const bool first = tile == (int)blockIdx.x;
    const long long row0 = (long long)tile * T;

    // ---- recompute the forward, keeping z and the row statistics
    load_x<T>(x, rows, t.dims[0], row0, X);
    __syncthreads();
    for (int l = 0; l < L; ++l) {
      const int K = t.dims[l], N = t.dims[l + 1], ld = round4(N);
      float* Z = reinterpret_cast<float*>(smem + s.z[l]);
      gemm_fwd<RPW>(l == 0 ? X : H, K, P + t.w_off[l], P + t.b_off[l], N, Z,
                    ld);
      __syncthreads();
      const float* g = P + t.g_off[l];
      const float* be = P + t.be_off[l];
      for (int i = 0; i < RPW; ++i) {
        const int r = r0 + i;
        const float* zr = Z + r * ld;
        float mean, rstd;
        row_stats(zr, N, mean, rstd);
        if (lane == 0) {
          MEAN[l * T + r] = mean;
          RSTD[l * T + r] = rstd;
        }
        if (l + 1 < L)
          for (int c = lane; c < N; c += 32)
            H[c * T + r] = __float2bfloat16_rn(
                ln_dropout(t, seed, l, row0 + r, c, zr[c], mean, rstd,
                           __ldg(g + c), __ldg(be + c)));
      }
      __syncthreads();
    }

    // ---- dy of the tile; rows past the end are zero
    {
      const int n = t.dims[L];
      for (int idx = threadIdx.x; idx < T * n; idx += kThreads) {
        const int r = idx / n, c = idx - r * n;
        const long long gr = row0 + r;
        DH[r * ldh + c] = gr < rows ? dy[gr * n + c] : 0.f;
      }
    }
    __syncthreads();

    // ---- the layers in reverse
    for (int l = L - 1; l >= 0; --l) {
      const int K = t.dims[l], N = t.dims[l + 1], ld = round4(N);
      float* Z = reinterpret_cast<float*>(smem + s.z[l]);
      const float* g = P + t.g_off[l];

      // dropout backward in place; the row means of dxhat and dxhat * xhat
      for (int i = 0; i < RPW; ++i) {
        const int r = r0 + i;
        const float mean = MEAN[l * T + r], rstd = RSTD[l * T + r];
        float s1 = 0.f, s2 = 0.f;
        for (int c = lane; c < N; c += 32) {
          float d = DH[r * ldh + c];
          if (t.use_dropout) {
            const uint32_t bits = philox_bits(seed, (uint32_t)l,
                                              (uint32_t)(row0 + r),
                                              (uint32_t)c);
            d = bits < t.threshold ? d * t.inv_keep : 0.f;
            DH[r * ldh + c] = d;
          }
          const float xh = (Z[r * ld + c] - mean) * rstd;
          const float dxh = d * __ldg(g + c);
          s1 += dxh;
          s2 = fmaf(dxh, xh, s2);
        }
        s1 = warp_sum(s1);
        s2 = warp_sum(s2);
        if (lane == 0) {
          M1[r] = s1 / (float)N;
          M2[r] = s2 / (float)N;
        }
      }
      __syncthreads();

      // dz in place of z (a thread per column), and the vector gradients
      for (int c = threadIdx.x; c < N; c += kThreads) {
        const float gc = __ldg(g + c);
        float db = 0.f, dg = 0.f, dbe = 0.f;
        for (int r = 0; r < T; ++r) {
          const float d = DH[r * ldh + c];
          const float z = Z[r * ld + c];
          const float rstd = RSTD[l * T + r];
          const float xh = (z - MEAN[l * T + r]) * rstd;
          dg = fmaf(d, xh, dg);
          dbe += d;
          float dz = rstd * (d * gc - M1[r] - xh * M2[r]);
          dz = z > 0.f ? dz : 0.f;
          Z[r * ld + c] = dz;
          db += dz;
        }
        put(my + t.b_off[l] + c, db, first);
        put(my + t.g_off[l] + c, dg, first);
        put(my + t.be_off[l] + c, dbe, first);
      }
      __syncthreads();

      // this layer's bf16 input: x, or the previous layer's output again
      if (l > 0) {
        const int Np = t.dims[l];
        const int ldp = round4(Np);
        const float* Zp = reinterpret_cast<const float*>(smem + s.z[l - 1]);
        const float* gp = P + t.g_off[l - 1];
        const float* bep = P + t.be_off[l - 1];
        for (int i = 0; i < RPW; ++i) {
          const int r = r0 + i;
          const float mean = MEAN[(l - 1) * T + r];
          const float rstd = RSTD[(l - 1) * T + r];
          for (int c = lane; c < Np; c += 32)
            H[c * T + r] = __float2bfloat16_rn(
                ln_dropout(t, seed, l - 1, row0 + r, c, Zp[r * ldp + c], mean,
                           rstd, __ldg(gp + c), __ldg(bep + c)));
        }
      }
      __syncthreads();

      // dW += h^T dz, 4 x 4 elements a thread
      {
        const __nv_bfloat16* A = l == 0 ? X : H;
        const int nk = (K + 3) >> 2, nc = (N + 3) >> 2;
        float* dW = my + t.w_off[l];
        for (int item = threadIdx.x; item < nk * nc; item += kThreads) {
          const int k0 = (item / nc) * 4, c0 = (item % nc) * 4;
          float acc[4][4] = {};
          for (int r = 0; r < T; ++r) {
            const float4 dz = *reinterpret_cast<const float4*>(Z + r * ld + c0);
            float a[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              a[i] = k0 + i < K ? __bfloat162float(A[(k0 + i) * T + r]) : 0.f;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[i][0] = fmaf(a[i], dz.x, acc[i][0]);
              acc[i][1] = fmaf(a[i], dz.y, acc[i][1]);
              acc[i][2] = fmaf(a[i], dz.z, acc[i][2]);
              acc[i][3] = fmaf(a[i], dz.w, acc[i][3]);
            }
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (k0 + i >= K) continue;
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (c0 + j < N)
                put(dW + (long long)(k0 + i) * N + c0 + j, acc[i][j], first);
          }
        }
      }

      // dh of the layer below (f32 weights), or dx for the first layer
      gemm_bwd_dh<RPW>(Z, ld, N, PT + t.wt_off[l], K, DH, ldh,
                       l == 0 ? dx : nullptr, row0, rows);
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

int make_tower(const int* dims, int n_layers, int use_dropout,
               long long threshold, float inv_keep, Tower* t) {
  if (dims == nullptr || n_layers < 1 || n_layers > kMaxLayers) return 1;
  if (threshold < 0 || threshold > 0xFFFFFFFFll) return 1;
  t->n_layers = n_layers;
  t->in_max = t->hid_max = t->out_max = t->all_max = 1;
  for (int i = 0; i <= n_layers; ++i) {
    const int d = dims[i];
    if (d < 1 || d > kMaxWidth) return 1;
    t->dims[i] = d;
    if (i < n_layers && d > t->in_max) t->in_max = d;
    if (i > 0 && i < n_layers && d > t->hid_max) t->hid_max = d;
    if (i > 0 && d > t->out_max) t->out_max = d;
    if (d > t->all_max) t->all_max = d;
  }
  long long off = 0, offt = 0;
  for (int l = 0; l < n_layers; ++l) {
    const long long din = dims[l], dout = dims[l + 1];
    t->w_off[l] = off;
    off += din * dout;
    t->b_off[l] = off;
    off += dout;
    t->g_off[l] = off;
    off += dout;
    t->be_off[l] = off;
    off += dout;
    t->wt_off[l] = offt;
    offt += din * dout;
  }
  t->total = off;
  t->use_dropout = use_dropout ? 1 : 0;
  t->threshold = (uint32_t)threshold;
  t->inv_keep = inv_keep;
  return 0;
}

size_t fwd_bytes(const Tower& t, int T) {
  return align16((size_t)t.in_max * T * 2) + (size_t)T * round4(t.out_max) * 4;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" {

// x: bf16 [rows, dims[0]]; params: f32, per layer W [dims[l], dims[l+1]],
// b, g, be [dims[l+1]], packed in that order; dims: host int
// [n_layers + 1], each in [1, 512], n_layers <= 16; seed: device int32
// (read only when use_dropout); out: f32 [rows, dims[n_layers]].  Returns
// a cudaError_t (0 on success).
int ncf_tower_fwd(const void* x, const float* params, const int* dims,
                  int n_layers, int rows, const int* seed, int use_dropout,
                  long long threshold, float inv_keep, float* out,
                  void* stream) {
  Tower t;
  if (rows < 1 || make_tower(dims, n_layers, use_dropout, threshold,
                             inv_keep, &t) != 0)
    return (int)cudaErrorInvalidValue;
  if (use_dropout && seed == nullptr) return (int)cudaErrorInvalidValue;
  constexpr int RPW = 4;
  const int T = RPW * kWarps;
  const size_t bytes = fwd_bytes(t, T);
  if (bytes > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(tower_fwd_kernel<RPW>, bytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (rows + T - 1) / T;
  tower_fwd_kernel<RPW><<<tiles, kThreads, bytes, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, params, t, rows, seed, out);
  return (int)cudaGetLastError();
}

// x: bf16 [rows, dims[0]]; dy: f32 [rows, dims[n_layers]]; params as for
// ncf_tower_fwd; params_t: f32, per layer W^T [dims[l+1], dims[l]];
// scratch: f32 [max_blocks, P] where P is the packed params' length;
// grads: f32 [P] in the params' packing; dx: bf16 [rows, dims[0]].
int ncf_tower_bwd(const void* x, const float* dy, const float* params,
                  const float* params_t, const int* dims, int n_layers,
                  int rows, const int* seed, int use_dropout,
                  long long threshold, float inv_keep, int max_blocks,
                  float* scratch, float* grads, void* dx, void* stream) {
  Tower t;
  if (rows < 1 || max_blocks < 1 ||
      make_tower(dims, n_layers, use_dropout, threshold, inv_keep, &t) != 0)
    return (int)cudaErrorInvalidValue;
  if (use_dropout && seed == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int dev = 0, sms = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  int T;
  size_t bytes;
  if ((bytes = bwd_layout(t, 4 * kWarps).bytes) <= (size_t)kMaxSmem) {
    T = 4 * kWarps;
    err = allow_smem(tower_bwd_kernel<4>, bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &occ, tower_bwd_kernel<4>, kThreads, bytes);
  } else if ((bytes = bwd_layout(t, 2 * kWarps).bytes) <= (size_t)kMaxSmem) {
    T = 2 * kWarps;
    err = allow_smem(tower_bwd_kernel<2>, bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &occ, tower_bwd_kernel<2>, kThreads, bytes);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  if (occ < 1) return (int)cudaErrorInvalidConfiguration;
  const int tiles = (rows + T - 1) / T;
  int nblk = sms * occ;
  if (nblk > tiles) nblk = tiles;
  if (nblk > max_blocks) nblk = max_blocks;
  if (T == 4 * kWarps)
    tower_bwd_kernel<4><<<nblk, kThreads, bytes, s>>>(
        (const __nv_bfloat16*)x, dy, params, params_t, t, rows, tiles, seed,
        (__nv_bfloat16*)dx, scratch);
  else
    tower_bwd_kernel<2><<<nblk, kThreads, bytes, s>>>(
        (const __nv_bfloat16*)x, dy, params, params_t, t, rows, tiles, seed,
        (__nv_bfloat16*)dx, scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  long long want = (t.total + kThreads - 1) / kThreads;
  const int grid = (int)(want < 1024 ? want : 1024);
  reduce_partials<<<grid, kThreads, 0, s>>>(scratch, nblk, t.total, grads);
  return (int)cudaGetLastError();
}

const char* ncf_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
