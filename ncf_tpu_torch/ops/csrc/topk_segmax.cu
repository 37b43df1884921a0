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
// Tolerance.  A key keeps the bits of an f32 score above the offset, so a
// sum taken in another order can move it.  On small integers the sums are
// exact (the split leaves lo = 0) and the keys equal the plain version's
// bit for bit.  Otherwise, wherever the kernel's key of a segment differs
// from the plain version's, decode both winners, i_K and i_P, score them
// in f64 and require
//   s(i_P) - s(i_K) <= seg_width * ulp(|s(i_P)| + 2 eps) + 2 eps,
// eps = 1e-5 * max over the two of sum_d |q_d T[i, d]| + 1e-6, the tile's
// stated error (topk_common.cuh); the ulp is f32's, taken where the score
// may stand after that error.  The rule's one home in code is
// ops/topk.py::segmax_key_violations, which the tests and the chip smoke
// apply.

// What bounds it on this card: at B=64 users, 4M items, D=64 in f32 the
// 1.04 GB table and bias and 8 MB of keys take 0.31 ms at 3.35 TB/s, and
// the split-TF32 product (three TF32 products, 1.0e11 operations) 0.20 ms
// at 495 TFLOP/s: bound by the table's bytes.
//
// Design: topk_common.cuh's tensor-core tile, as B5 and B8 take it.
// Persistent blocks each hold one tile of TU users (8, 16, 32 or 64: the
// smallest that covers B, within the shared memory) and walk the 128-item
// tiles walker, walker + nwalk, ... up to n_pad_rows, the table streaming
// through the cp.async ring (split-TF32 mma.sync for f32 tables, two TF32
// products for bf16 tables with the queries kept in f32).  The segment max
// is taken from the C fragments in registers; the scores never reach
// shared memory.  A lane holds items g and g + 8 of its warp's 16 (g =
// lane / 4) for users 2t and 2t + 1 of each 8-user slice (t = lane % 4):
// it packs each score with its own item's offset, keeps the larger of its
// two items' keys, and three xor-shuffles over the lanes of equal t give
// the warp's max over its 16 items.  The warps of a segment (8 for seg
// 128, 4 for 64, 2 for 32) meet in a shared array of 8 x TU ints, and one
// int32 per (user, segment) is stored, a user's segments of the tile
// side by side.

#include <climits>

#include "topk_common.cuh"

namespace {

namespace tc = ncf::tc;
using ncf::kNegInf;
constexpr int kWarps = tc::kThreads / 32;

__device__ __forceinline__ int monotone_i32(float x) {
  const int i = __float_as_int(x);
  return i ^ ((i >> 31) & 0x7FFFFFFF);
}

template <typename TT, int TU>
__host__ size_t segmax_smem_bytes(int D) {
  return tc::ring_smem_bytes<float, TT, TU>(D) + (size_t)kWarps * TU * 4;
}

template <typename TT, int TU>
__global__ void __launch_bounds__(tc::kThreads)
segmax_tc_kernel(const float* __restrict__ q, const TT* __restrict__ table,
                 const float* __restrict__ bias, int B, int D, int num_items,
                 int n_pad_rows, int seg_width, int n_utiles, int mode,
                 int* __restrict__ keys) {
  extern __shared__ __align__(16) unsigned char smem[];
  const tc::Geom g = tc::geom<float, TT, TU>(D);
  unsigned char* qs = smem;
  unsigned char* ring = smem + g.q_bytes;
  int* red = (int*)(ring + tc::kStages * g.stage_bytes);  // [kWarps][TU]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, t = lane & 3;
  const int utile = blockIdx.x % n_utiles;
  const int walker = blockIdx.x / n_utiles;
  const int nwalk = gridDim.x / n_utiles;
  const int u0 = utile * TU;
  const int nseg_total = n_pad_rows / seg_width;
  const int segs = tc::kItems / seg_width;  // segments a tile: 1, 2 or 4
  const int wps = seg_width / 16;           // warps a segment: 8, 4 or 2
  tc::stage_queries<float, TU>(q, B, D, u0, g, qs);
  __syncthreads();

  tc::stream_fragments<float, TT, TU>(
      table, bias, D, num_items, n_pad_rows, walker, nwalk, mode, g, qs,
      ring,
      [&](const float (&acc)[TU / 8][4], const unsigned char* st,
          long long row0) {
        const float* sb = bias ? (const float*)(st + g.bias_off) : nullptr;
        int best[TU / 8][2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int il = warp * 16 + gr + 8 * h;
          const bool real = row0 + il < num_items;
          const float b = (real && sb) ? sb[il] : 0.f;
          const int off = il & (seg_width - 1);
#pragma unroll
          for (int n = 0; n < TU / 8; ++n)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float v = real ? acc[n][2 * h + j] + b : kNegInf;
              const int key = (monotone_i32(v) & -seg_width) | off;
              best[n][j] = h == 0 || key > best[n][j] ? key : best[n][j];
            }
        }
#pragma unroll
        for (int n = 0; n < TU / 8; ++n)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            int m = best[n][j];
#pragma unroll
            for (int x = 4; x < 32; x <<= 1)
              m = max(m, __shfl_xor_sync(0xffffffffu, m, x));
            if (gr == 0) red[warp * TU + n * 8 + 2 * t + j] = m;
          }
        __syncthreads();
        for (int e = tid; e < TU * segs; e += tc::kThreads) {
          const int ul = e / segs, s = e % segs, u = u0 + ul;
          const long long gseg = row0 / seg_width + s;
          if (u >= B || gseg >= nseg_total) continue;
          int m = INT_MIN;
          for (int w = s * wps; w < (s + 1) * wps; ++w)
            m = max(m, red[w * TU + ul]);
          keys[(long long)u * nseg_total + gseg] = m;
        }
      });
}

template <typename TT, int TU>
cudaError_t launch_tu(const float* q, const void* table, const float* bias,
                      int B, int D, int num_items, int n_pad_rows,
                      int seg_width, int* keys, cudaStream_t s) {
  static const cudaError_t attr =
      tc::allow_max_smem((const void*)segmax_tc_kernel<TT, TU>);
  if (attr != cudaSuccess) return attr;
  const size_t smem = segmax_smem_bytes<TT, TU>(D);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, segmax_tc_kernel<TT, TU>, tc::kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int n_utiles = (B + TU - 1) / TU;
  const long long ntiles =
      ((long long)n_pad_rows + tc::kItems - 1) / tc::kItems;
  long long nwalk = (long long)per_sm * sms / n_utiles;
  if (nwalk > ntiles) nwalk = ntiles;
  if (nwalk < 1) nwalk = 1;
  const int mode = tc::copy_mode(table, D, (int)sizeof(TT));
  segmax_tc_kernel<TT, TU><<<(unsigned)(nwalk * n_utiles), tc::kThreads,
                             smem, s>>>(
      q, (const TT*)table, bias, B, D, num_items, n_pad_rows, seg_width,
      n_utiles, mode, keys);
  return cudaGetLastError();
}

template <typename TT>
cudaError_t launch(const float* q, const void* table, const float* bias,
                   int B, int D, int num_items, int n_pad_rows, int seg_width,
                   int* keys, cudaStream_t s) {
  int optin = 0;
  const cudaError_t err = tc::smem_optin(&optin);
  if (err != cudaSuccess) return err;
  const int tu = tc::pick_user_tile(B, optin, [&](int t) {
    return t == 64 ? segmax_smem_bytes<TT, 64>(D)
           : t == 32 ? segmax_smem_bytes<TT, 32>(D)
           : t == 16 ? segmax_smem_bytes<TT, 16>(D)
                     : segmax_smem_bytes<TT, 8>(D);
  });
  if (tu == 0) return cudaErrorInvalidValue;
#define NCF_LAUNCH(TU_)                                                    \
  return launch_tu<TT, TU_>(q, table, bias, B, D, num_items, n_pad_rows,  \
                            seg_width, keys, s)
  switch (tu) {
    case 64: NCF_LAUNCH(64);
    case 32: NCF_LAUNCH(32);
    case 16: NCF_LAUNCH(16);
    default: NCF_LAUNCH(8);
  }
#undef NCF_LAUNCH
}

}  // namespace

extern "C" {

// q: [B, D] f32; table: [num_items, D], dtype 0 = float32, 1 = bfloat16;
// bias: [num_items] f32 or null; n_pad_rows: the catalog padded to the
// reference's item block (a multiple of seg_width).  keys: [B,
// n_pad_rows / seg_width] int32.  D <= 128.  Returns a cudaError_t (0 on
// success); errors during the run surface at the next synchronisation.
int ncf_topk_segmax(const float* q, const void* table, const float* bias,
                    int dtype, int B, int D, int num_items, int n_pad_rows,
                    int seg_width, int* keys, void* stream) {
  if (B <= 0 || D <= 0 || D > tc::kMaxD || num_items <= 0 ||
      n_pad_rows < num_items || (dtype != 0 && dtype != 1) ||
      (seg_width != 32 && seg_width != 64 && seg_width != 128) ||
      n_pad_rows % seg_width != 0)
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
