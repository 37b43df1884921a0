// Device code shared by the port's top-k kernels (B5 topk_streaming.cu,
// B6 topk_streaming_int8.cu, B8 topk_exact.cu, B9 topk_segmax.cu):
//
//   score_tile      a TU-user x 128-item tile of q . T (+ bias) as a
//                   register-tiled f32 FMA product, operands staged through
//                   shared memory in 32-deep slices of D;
//   select_top_keys a block-wide MSB-first radix select of the k largest
//                   nonzero 64-bit keys of one user's candidate list;
//   key helpers     order-preserving float <-> uint32 maps and the merge
//                   position encoding of the segment kernels.
//
// Header only; each kernel source includes it and builds on its own.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ncf {

constexpr float kNegInf = -3.0e38f;
constexpr int kChunk = 128;    // items per scoring tile
constexpr int kDk = 32;        // D-slice staged per step
constexpr int kThreads = 256;  // scoring threads

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// order-preserving float -> uint32 (a larger float gives a larger word)
__device__ __forceinline__ unsigned int mono_f32(float v) {
  unsigned int b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float unmono_f32(unsigned int m) {
  unsigned int b = (m & 0x80000000u) ? (m & 0x7FFFFFFFu) : ~m;
  return __uint_as_float(b);
}

// pos -> item id for the segment kernels' keys: pos = ((block * seg_top +
// rank) * nseg + seg) * seg_width + off, id = (block * nseg + seg) *
// seg_width + off, the key's low word holding ~pos
__device__ __forceinline__ int key_id(unsigned long long key, int seg_width,
                                      int seg_top, int nseg) {
  unsigned int pos = ~(unsigned int)(key & 0xFFFFFFFFull);
  unsigned int off = pos % (unsigned)seg_width;
  unsigned int t = pos / (unsigned)seg_width;
  unsigned int seg = t % (unsigned)nseg;
  unsigned int block = t / (unsigned)nseg / (unsigned)seg_top;
  return (int)((block * (unsigned)nseg + seg) * (unsigned)seg_width + off);
}

// (value desc, then offset asc) for a segment's best two
template <typename V>
__device__ __forceinline__ bool better(V va, int oa, V vb, int ob) {
  return va > vb || (va == vb && oa < ob);
}

template <typename V>
__device__ __forceinline__ void insert2(V v, int o, V& v1, int& o1, V& v2,
                                        int& o2) {
  if (better(v, o, v1, o1)) {
    v2 = v1; o2 = o1; v1 = v; o1 = o;
  } else if (better(v, o, v2, o2)) {
    v2 = v; o2 = o;
  }
}

// floats of shared staging score_tile needs for TU users
template <int TU>
__host__ __device__ constexpr int stage_floats() {
  return kDk * (TU + 1 + kChunk + 1);
}

// out[ul * out_stride + il] = q[u0 + ul] . T[row0 + il] (+ bias) for the
// TU x 128 tile, or `pad` where row0 + il >= n_rows; users >= B score 0.
// Each thread owns UM users x IM items, strided (user ty + m*TY, item
// tx + j*TX) so shared reads are conflict-free.  `out` may alias `stage`:
// the product ends with a barrier before the epilogue writes.
template <typename TQ, typename TT, int TU, int UM, int IM>
__device__ __forceinline__ void score_tile(
    const TQ* __restrict__ q, const TT* __restrict__ table,
    const float* __restrict__ bias, int B, int D, long long n_rows, int u0,
    long long row0, float pad, float* stage, float* out, int out_stride) {
  constexpr int TX = kChunk / IM;
  constexpr int TY = TU / UM;
  static_assert(TX * TY == kThreads, "thread tiling must cover the block");
  constexpr int QSTR = TU + 1;
  constexpr int TSTR = kChunk + 1;
  float* Qs = stage;               // [kDk][QSTR]
  float* Ts = stage + kDk * QSTR;  // [kDk][TSTR]

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;

  float acc[UM][IM];
#pragma unroll
  for (int m = 0; m < UM; ++m)
#pragma unroll
    for (int j = 0; j < IM; ++j) acc[m][j] = 0.f;

  for (int d0 = 0; d0 < D; d0 += kDk) {
    for (int e = tid; e < kChunk * kDk; e += kThreads) {
      int r = e / kDk, c = e % kDk;
      long long row = row0 + r;
      int d = d0 + c;
      float v = 0.f;
      if (row < n_rows && d < D) v = to_f(table[row * D + d]);
      Ts[c * TSTR + r] = v;
    }
    for (int e = tid; e < TU * kDk; e += kThreads) {
      int r = e / kDk, c = e % kDk;
      int u = u0 + r;
      int d = d0 + c;
      float v = 0.f;
      if (u < B && d < D) v = to_f(q[(long long)u * D + d]);
      Qs[c * QSTR + r] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kDk; ++c) {
      float a[UM], b[IM];
#pragma unroll
      for (int m = 0; m < UM; ++m) a[m] = Qs[c * QSTR + ty + m * TY];
#pragma unroll
      for (int j = 0; j < IM; ++j) b[j] = Ts[c * TSTR + tx + j * TX];
#pragma unroll
      for (int m = 0; m < UM; ++m)
#pragma unroll
        for (int j = 0; j < IM; ++j) acc[m][j] = fmaf(a[m], b[j], acc[m][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < UM; ++m) {
#pragma unroll
    for (int j = 0; j < IM; ++j) {
      int ul = ty + m * TY;
      int il = tx + j * TX;
      long long row = row0 + il;
      float v = pad;
      if (row < n_rows) v = acc[m][j] + (bias ? bias[row] : 0.f);
      out[ul * out_stride + il] = v;
    }
  }
}

// The min(k, nonzero count) largest nonzero keys of kb[0, ncand) into
// sel[] (unordered); returns that count.  MSB-first radix select with
// 8-bit digits, stopping as soon as the boundary bin is taken whole; keys
// are unique, so the boundary bin always ends with one key.  Every thread
// of the NT-thread block calls it; it synchronises the block.
template <int NT, int MAXK>
__device__ int select_top_keys(const unsigned long long* __restrict__ kb,
                               int ncand, int k, unsigned long long* sel) {
  __shared__ unsigned int hist[256];
  __shared__ unsigned long long s_prefix, s_mask;
  __shared__ int s_need, s_done, s_count;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (tid == 0) {
    s_prefix = 0ull; s_mask = 0ull;
    s_need = k; s_done = 0; s_count = 0;
  }
  __syncthreads();

  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += NT) hist[i] = 0u;
    __syncthreads();
    const unsigned long long prefix = s_prefix, mask = s_mask;
    for (int base = 0; base < ncand; base += NT) {
      int i = base + tid;
      int digit = 256;  // no bin
      if (i < ncand) {
        unsigned long long key = kb[i];
        if (key != 0ull && (key & mask) == prefix)
          digit = (int)((key >> shift) & 0xFFull);
      }
      unsigned int peers = __match_any_sync(0xffffffffu, digit);
      if (digit < 256 && lane == __ffs(peers) - 1)
        atomicAdd(&hist[digit], (unsigned int)__popc(peers));
    }
    __syncthreads();
    if (tid == 0) {
      int need = s_need;
      if (shift == 56) {
        unsigned int total = 0u;
        for (int d = 0; d < 256; ++d) total += hist[d];
        if ((int)total <= need) s_done = 1;  // take every candidate
      }
      if (!s_done) {
        unsigned int cum = 0u;
        for (int d = 255; d >= 0; --d) {
          unsigned int h = hist[d];
          if ((int)(cum + h) >= need) {
            s_prefix = prefix | ((unsigned long long)d << shift);
            s_mask = mask | (0xFFull << shift);
            s_need = need - (int)cum;
            if ((int)h == s_need) s_done = 1;
            break;
          }
          cum += h;
        }
      }
    }
    __syncthreads();
    if (s_done) break;
  }

  // winners: nonzero keys whose selected prefix is at or above the boundary
  const unsigned long long prefix = s_prefix, mask = s_mask;
  for (int i = tid; i < ncand; i += NT) {
    unsigned long long key = kb[i];
    if (key != 0ull && (key & mask) >= prefix) {
      int slot = atomicAdd(&s_count, 1);
      if (slot < MAXK) sel[slot] = key;
    }
  }
  __syncthreads();
  return s_count < k ? s_count : k;
}

}  // namespace ncf
