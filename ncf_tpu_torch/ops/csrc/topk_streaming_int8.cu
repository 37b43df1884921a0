// Int8 streaming segment top-k retrieval for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ncf_tpu/ops/topk.py::
// topk_scores_streaming_int8 (body _streaming_kernel_int8, topk.py:772;
// pallas_call at topk.py:894).
//
// Function computed (the JAX kernel's, bit for bit; all integer):
//   acc[u, i] = q8[u] . T8[i]            int8 x int8 -> int32, K = D + 3
//   (the last three columns are the bias digits against the query's
//   weights 127, 127, 1, so the bias is inside acc).  Items are cut into
//   segments of seg_width consecutive ids; each segment surfaces its best
//   seg_top by (acc desc, offset asc), the reference's packed key
//   acc * seg_width + (seg_width - 1 - offset); the result is the top-k
//   of those, equal values in the order of the reference's running merge
//   [carry; m1 of every segment; m2 of every segment] (item block, then
//   rank, then segment) — the merge order of B5 (topk_streaming.cu).
//   The returned value is acc * q_scale, or NEG_INF where acc <=
//   _PAD_FLOOR + 0.5 (padded rows score exactly _PAD_FLOOR and are never
//   masked); ids are clamped to num_items - 1.  Slots beyond the
//   candidates (fewer than k segments) take B5's fill id: the best
//   candidate of the blocks before the last, or 0 with one block.
//
// What bounds it on this card: at the serving shape (B=64 users, 4M items,
// K=67) the product is 3.4e10 int8 operations (17 us at the 1,979 TOP/s
// int8 tensor-core peak) against 268 MB of table (80 us at 3.35 TB/s), so
// the bytes bound it.  This first version runs __dp4a on the CUDA cores
// (4 int8 MACs an instruction), which makes it compute-bound in practice;
// the tensor-core path (mma.sync s8, then wgmma) is later work.
//
// Design (simple and right first):
//   pass 1 (seg_topk_int8_kernel): one block scores a chunk of 128 items
//     against a tile of TU users.  Rows of K = D+3 bytes are not 4-byte
//     aligned, so both operands are packed into int32 words of 4 int8
//     while staged through shared memory (K zero-padded to a multiple of
//     4), and each thread runs __dp4a over its register tile.  One warp
//     per (user, segment) keeps the segment's best two (acc desc, offset
//     asc) and writes each as a 64-bit key (acc ^ sign << 32 | ~pos), pos
//     encoded as in B5, so a larger key is exactly a better candidate.
//   pass 2 (merge_int8_kernel): one block per user selects the k largest
//     keys (topk_common.cuh's radix select), ranks them, dequantizes.
// Both launches go on the caller's stream; the caller owns all buffers.

#include <climits>

#include "topk_common.cuh"

namespace {

using ncf::kChunk;
using ncf::kNegInf;
using ncf::kThreads;
constexpr int kW = 16;           // int32 words of K staged per step
constexpr int kMergeThreads = 512;
constexpr int kMaxK = 64;
constexpr float kPadFloor = -32385.0f;   // topk.py::_PAD_FLOOR

__device__ __forceinline__ int pack4(const int8_t* __restrict__ row, int d,
                                     int K) {
  unsigned int w = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (d + j < K) w |= (unsigned int)(uint8_t)row[d + j] << (8 * j);
  return (int)w;
}

template <int TU, int UM, int IM>
__global__ void __launch_bounds__(kThreads)
seg_topk_int8_kernel(const int8_t* __restrict__ q,
                     const int8_t* __restrict__ table, int B, int K,
                     int n_rows, int seg_width, int seg_top, int nseg,
                     int n_utiles, int ncand,
                     unsigned long long* __restrict__ keys) {
  constexpr int TX = kChunk / IM;
  constexpr int TY = TU / UM;
  static_assert(TX * TY == kThreads, "thread tiling must cover the block");
  constexpr int QSTR = TU + 1;
  constexpr int TSTR = kChunk + 1;
  constexpr int SSTR = kChunk + 1;
  constexpr int STAGE = kW * (QSTR + TSTR);
  constexpr int SCORES = TU * SSTR;
  __shared__ int smem[STAGE > SCORES ? STAGE : SCORES];
  int* Qs = smem;               // [kW][QSTR] packed words
  int* Ts = smem + kW * QSTR;   // [kW][TSTR]
  int* S = smem;                // [TU][SSTR], reused after the product

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int utile = blockIdx.x % n_utiles;
  const long long chunk = blockIdx.x / n_utiles;
  const long long row0 = chunk * kChunk;
  const int u0 = utile * TU;
  const int nw = (K + 3) / 4;

  int acc[UM][IM];
#pragma unroll
  for (int m = 0; m < UM; ++m)
#pragma unroll
    for (int j = 0; j < IM; ++j) acc[m][j] = 0;

  for (int w0 = 0; w0 < nw; w0 += kW) {
    for (int e = tid; e < kChunk * kW; e += kThreads) {
      int r = e / kW, c = e % kW;
      long long row = row0 + r;
      int w = w0 + c;
      int v = 0;
      if (row < n_rows && w < nw) v = pack4(table + row * K, 4 * w, K);
      Ts[c * TSTR + r] = v;
    }
    for (int e = tid; e < TU * kW; e += kThreads) {
      int r = e / kW, c = e % kW;
      int u = u0 + r;
      int w = w0 + c;
      int v = 0;
      if (u < B && w < nw) v = pack4(q + (long long)u * K, 4 * w, K);
      Qs[c * QSTR + r] = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kW; ++c) {
      int a[UM], b[IM];
#pragma unroll
      for (int m = 0; m < UM; ++m) a[m] = Qs[c * QSTR + ty + m * TY];
#pragma unroll
      for (int j = 0; j < IM; ++j) b[j] = Ts[c * TSTR + tx + j * TX];
#pragma unroll
      for (int m = 0; m < UM; ++m)
#pragma unroll
        for (int j = 0; j < IM; ++j) acc[m][j] = __dp4a(a[m], b[j], acc[m][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < UM; ++m)
#pragma unroll
    for (int j = 0; j < IM; ++j)
      S[(ty + m * TY) * SSTR + tx + j * TX] = acc[m][j];
  __syncthreads();

  // one warp per (user, segment): top-seg_top by (acc desc, offset asc);
  // rows >= n_rows lie in segments >= nseg_total, never read
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int segs = kChunk / seg_width;
  const int per = seg_width / 32;
  const long long nseg_total = ((long long)n_rows + seg_width - 1) / seg_width;
  for (int p = warp; p < TU * segs; p += kThreads / 32) {
    int ul = p / segs;
    int s = p % segs;
    int u = u0 + ul;
    long long gseg = row0 / seg_width + s;
    if (u >= B || gseg >= nseg_total) continue;  // warp-uniform
    int v1 = INT_MIN, v2 = INT_MIN;
    int o1 = 0x7FFFFFFF, o2 = 0x7FFFFFFF;
    for (int e = 0; e < per; ++e) {
      int off = lane + e * 32;
      ncf::insert2(S[ul * SSTR + s * seg_width + off], off, v1, o1, v2, o2);
    }
#pragma unroll
    for (int x = 16; x > 0; x >>= 1) {
      int w1 = __shfl_xor_sync(0xffffffffu, v1, x);
      int p1 = __shfl_xor_sync(0xffffffffu, o1, x);
      int w2 = __shfl_xor_sync(0xffffffffu, v2, x);
      int p2 = __shfl_xor_sync(0xffffffffu, o2, x);
      ncf::insert2(w1, p1, v1, o1, v2, o2);
      ncf::insert2(w2, p2, v1, o1, v2, o2);
    }
    if (lane < seg_top) {
      int v = lane == 0 ? v1 : v2;
      int o = lane == 0 ? o1 : o2;
      const unsigned int blk = (unsigned int)(gseg / nseg);
      const unsigned int sib = (unsigned int)(gseg % nseg);
      const unsigned int pos =
          ((blk * seg_top + lane) * nseg + sib) * seg_width + (unsigned int)o;
      keys[(long long)u * ncand + gseg * seg_top + lane] =
          ((unsigned long long)((unsigned int)v ^ 0x80000000u) << 32)
          | (unsigned int)(~pos);
    }
  }
}

__global__ void __launch_bounds__(kMergeThreads)
merge_int8_kernel(const unsigned long long* __restrict__ keys, int ncand,
                  int early, int k, int num_items, int seg_width,
                  int seg_top, int nseg, const float* __restrict__ q_scale,
                  float* __restrict__ out_vals, int* __restrict__ out_ids) {
  __shared__ unsigned long long sel[kMaxK];
  __shared__ unsigned long long s_best;

  const int tid = threadIdx.x;
  const unsigned long long* kb = keys + (long long)blockIdx.x * ncand;
  if (tid == 0) s_best = 0ull;
  const int n = ncf::select_top_keys<kMergeThreads, kMaxK>(kb, ncand, k, sel);
  float* ov = out_vals + (long long)blockIdx.x * k;
  int* oi = out_ids + (long long)blockIdx.x * k;
  if (tid < n) {
    unsigned long long key = sel[tid];
    int rank = 0;
    for (int j = 0; j < n; ++j) rank += sel[j] > key;
    const int acc = (int)((unsigned int)(key >> 32) ^ 0x80000000u);
    const float v = (float)acc;
    const int id = ncf::key_id(key, seg_width, seg_top, nseg);
    ov[rank] = v > kPadFloor + 0.5f ? v * q_scale[0] : kNegInf;
    oi[rank] = id < num_items - 1 ? id : num_items - 1;
  }
  if (n < k) {  // block-uniform: empty slots take the early blocks' best
    unsigned long long best = 0ull;
    for (int i = tid; i < early; i += kMergeThreads) {
      unsigned long long key = kb[i];
      best = key > best ? key : best;
    }
    atomicMax(&s_best, best);
    __syncthreads();
    int fill = 0;
    if (s_best != 0ull) fill = ncf::key_id(s_best, seg_width, seg_top, nseg);
    fill = fill < num_items - 1 ? fill : num_items - 1;
    for (int r = n + tid; r < k; r += kMergeThreads) {
      ov[r] = kNegInf;
      oi[r] = fill;
    }
  }
}

}  // namespace

extern "C" {

// q: [B, K] int8 quantized queries (weights 127, 127, 1 in the last three
// columns); table: [n_rows, K] int8, n_rows = nblocks * nseg * seg_width;
// q_scale: one f32 on the device.  keys: [B, ncand] uint64 scratch with
// ncand = n_rows / seg_width * seg_top.  Returns a cudaError_t (0 on
// success); errors during the run surface at the next synchronisation.
int ncf_topk_streaming_int8(const void* q, const void* table,
                            const float* q_scale, int B, int K, int n_rows,
                            int num_items, int seg_width, int seg_top,
                            int nseg, int nblocks, int k, void* keys,
                            float* out_vals, int* out_ids, void* stream) {
  if (B <= 0 || K <= 0 || n_rows <= 0 || num_items <= 0 || k <= 0 ||
      k > kMaxK || (seg_top != 1 && seg_top != 2) || nseg <= 0 ||
      nblocks <= 0 || n_rows % seg_width != 0 ||
      (seg_width != 32 && seg_width != 64 && seg_width != 128))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int ncand = n_rows / seg_width * seg_top;
  unsigned long long* kp = (unsigned long long*)keys;
  const long long nchunks = ((long long)n_rows + kChunk - 1) / kChunk;
  const int8_t* q8 = (const int8_t*)q;
  const int8_t* t8 = (const int8_t*)table;
  if (B <= 8) {
    seg_topk_int8_kernel<8, 1, 4><<<(unsigned)nchunks, kThreads, 0, s>>>(
        q8, t8, B, K, n_rows, seg_width, seg_top, nseg, 1, ncand, kp);
  } else {
    const int n_utiles = (B + 63) / 64;
    seg_topk_int8_kernel<64, 4, 8>
        <<<(unsigned)(nchunks * n_utiles), kThreads, 0, s>>>(
            q8, t8, B, K, n_rows, seg_width, seg_top, nseg, n_utiles, ncand,
            kp);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  long long early = (long long)(nblocks - 1) * nseg * seg_top;
  if (early > ncand) early = ncand;
  merge_int8_kernel<<<B, kMergeThreads, 0, s>>>(
      kp, ncand, (int)early, k, num_items, seg_width, seg_top, nseg, q_scale,
      out_vals, out_ids);
  return (int)cudaGetLastError();
}

const char* ncf_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
