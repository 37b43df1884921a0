// Segmented-max candidate keys for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ncf_tpu/ops/topk.py::topk_scores_segmented
// (body _segmax_kernel, topk.py:966; pallas_call at topk.py:1034).
//
// Function computed (the JAX kernel's output, the [B, n_pad_rows /
// seg_width] int32 candidate keys): score[u, i] = q[u] . T[i] + bias[i]
// (f32 accumulate), NEG_INF (-3e38) for i >= num_items; key[u, i] =
// (monotone_i32(score) & -seg_width) | (i & (seg_width - 1)), with
// monotone_i32(x) = bits ^ ((bits >> 31) & 0x7FFFFFFF); out[u, s] = the
// signed max of the keys of segment s (so among equal quantized scores the
// highest offset wins).  The top-k over the keys and the exact rescore of
// the winners stay outside, as in the reference.
//
// What bounds it on this card: at B=64 users, 4M items, D=64 in f32 the
// product is 3.3e10 FLOP (0.49 ms at 67 TFLOP/s) against 1.04 GB of table
// and 8 MB of keys (0.31 ms at 3.35 TB/s): compute-bound.
//
// Design (simple and right first): one block scores a TU-user x 128-item
// tile (topk_common.cuh's score_tile, scores in shared memory), then one
// warp per (user, segment) packs and max-reduces the keys and writes one
// int32.  The TPU's per-block output layout becomes the reference's
// post-transpose [B, segments] layout directly.

#include <climits>

#include "topk_common.cuh"

namespace {

using ncf::kChunk;
using ncf::kNegInf;
using ncf::kThreads;

__device__ __forceinline__ int monotone_i32(float x) {
  const int i = __float_as_int(x);
  return i ^ ((i >> 31) & 0x7FFFFFFF);
}

template <typename TT, int TU, int UM, int IM>
__global__ void __launch_bounds__(kThreads)
segmax_kernel(const float* __restrict__ q, const TT* __restrict__ table,
              const float* __restrict__ bias, int B, int D, int num_items,
              int seg_width, int n_utiles, int nseg_total,
              int* __restrict__ keys) {
  constexpr int SSTR = kChunk + 1;
  constexpr int STAGE = ncf::stage_floats<TU>();
  constexpr int SCORES = TU * SSTR;
  __shared__ float smem[STAGE > SCORES ? STAGE : SCORES];
  float* S = smem;

  const int tid = threadIdx.x;
  const int utile = blockIdx.x % n_utiles;
  const long long chunk = blockIdx.x / n_utiles;
  const long long row0 = chunk * kChunk;
  const int u0 = utile * TU;
  ncf::score_tile<float, TT, TU, UM, IM>(q, table, bias, B, D, num_items, u0,
                                         row0, kNegInf, smem, S, SSTR);
  __syncthreads();

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int segs = kChunk / seg_width;
  const int per = seg_width / 32;
  for (int p = warp; p < TU * segs; p += kThreads / 32) {
    int ul = p / segs;
    int s = p % segs;
    int u = u0 + ul;
    long long gseg = row0 / seg_width + s;
    if (u >= B || gseg >= nseg_total) continue;  // warp-uniform
    int best = INT_MIN;
    for (int e = 0; e < per; ++e) {
      int off = lane + e * 32;
      int key = (monotone_i32(S[ul * SSTR + s * seg_width + off])
                 & -seg_width) | off;
      best = key > best ? key : best;
    }
#pragma unroll
    for (int x = 16; x > 0; x >>= 1) {
      int other = __shfl_xor_sync(0xffffffffu, best, x);
      best = other > best ? other : best;
    }
    if (lane == 0) keys[(long long)u * nseg_total + gseg] = best;
  }
}

template <typename TT>
cudaError_t launch(const float* q, const void* table, const float* bias,
                   int B, int D, int num_items, int n_pad_rows, int seg_width,
                   int* keys, cudaStream_t s) {
  const long long nchunks = ((long long)n_pad_rows + kChunk - 1) / kChunk;
  const int nseg_total = n_pad_rows / seg_width;
  if (B <= 8) {
    segmax_kernel<TT, 8, 1, 4><<<(unsigned)nchunks, kThreads, 0, s>>>(
        q, (const TT*)table, bias, B, D, num_items, seg_width, 1, nseg_total,
        keys);
  } else {
    const int n_utiles = (B + 63) / 64;
    segmax_kernel<TT, 64, 4, 8>
        <<<(unsigned)(nchunks * n_utiles), kThreads, 0, s>>>(
            q, (const TT*)table, bias, B, D, num_items, seg_width, n_utiles,
            nseg_total, keys);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q: [B, D] f32; table: [num_items, D], dtype 0 = float32, 1 = bfloat16;
// bias: [num_items] f32 or null; n_pad_rows: the catalog padded to the
// reference's item block (a multiple of seg_width).  keys: [B,
// n_pad_rows / seg_width] int32.  Returns a cudaError_t (0 on success).
int ncf_topk_segmax(const float* q, const void* table, const float* bias,
                    int dtype, int B, int D, int num_items, int n_pad_rows,
                    int seg_width, int* keys, void* stream) {
  if (B <= 0 || D <= 0 || num_items <= 0 || n_pad_rows < num_items ||
      (dtype != 0 && dtype != 1) || n_pad_rows % seg_width != 0 ||
      (seg_width != 32 && seg_width != 64 && seg_width != 128))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(dtype == 0
                   ? launch<float>(q, table, bias, B, D, num_items,
                                   n_pad_rows, seg_width, keys, s)
                   : launch<__nv_bfloat16>(q, table, bias, B, D, num_items,
                                           n_pad_rows, seg_width, keys, s));
}

const char* ncf_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
