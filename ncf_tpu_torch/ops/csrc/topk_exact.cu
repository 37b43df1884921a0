// Exact blocked top-k retrieval for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ncf_tpu/ops/topk.py::topk_scores_pallas
// (body _topk_kernel, topk.py:121; pallas_call at topk.py:186).
//
// Function computed (the JAX kernel's): score[u, i] = q[u] . T[i] + bias[i]
// (f32 accumulate), exact top-k by (value desc, id asc): the reference
// extracts k rounds per item block with ties to the lowest column and
// merges the carry before the block, so equal values keep the lower id.
// Scores at or below NEG_INF (-3e38) never surface; slots left empty come
// back as NEG_INF with the reference's id: the best item before the last
// item block of `block_items`, or 0 (the carry's first row entering the
// last block).  Ids are not clamped.  k <= 256.
//
// What bounds it on this card: at B=64 users, 4M items, D=64 in f32 the
// product is 3.3e10 FLOP (0.49 ms at the 67 TFLOP/s f32 CUDA-core peak)
// against 1.04 GB of table (0.31 ms at 3.35 TB/s): compute-bound.
//
// Design (simple and right first; the TPU's k unrolled extraction rounds
// over every column become one selection per chunk):
//   pass 1 (exact_chunk_kernel): one block scores 8 users x 2048 items,
//     sixteen 128-item tiles of topk_common.cuh's score_tile into a
//     [8][2048] f32 buffer in shared memory (dynamic, 90 KB).  One warp per
//     user then radix-selects the chunk's top min(k, real) by an
//     order-preserving 32-bit value (four 8-bit digit rounds; equal values
//     are taken lowest index first) and writes them as 64-bit keys
//     (value << 32 | ~id) into [B, nchunks * k] scratch, empty slots 0.
//   pass 2 (merge_exact_kernel): one block per user selects the k largest
//     keys (topk_common.cuh's radix select), ranks them and fills the
//     empty slots.
// Both launches go on the caller's stream; the caller owns all buffers.

#include "topk_common.cuh"

namespace {

using ncf::kChunk;
using ncf::kNegInf;
using ncf::kThreads;
constexpr int kSel = 2048;       // items per selection chunk
constexpr int kTU = 8;           // users per pass-1 block (one warp each)
constexpr int kMaxK = 256;
constexpr int kMergeThreads = 512;
constexpr int kSmemBytes =
    (ncf::stage_floats<kTU>() + kTU * kSel) * 4 + (kThreads / 32) * 256 * 4;

template <typename TT>
__global__ void __launch_bounds__(kThreads)
exact_chunk_kernel(const float* __restrict__ q, const TT* __restrict__ table,
                   const float* __restrict__ bias, int B, int D,
                   int num_items, int k, int n_utiles, int nchunks,
                   unsigned long long* __restrict__ keys) {
  extern __shared__ float dyn[];
  float* stage = dyn;
  float* S = dyn + ncf::stage_floats<kTU>();             // [kTU][kSel]
  unsigned int* hist = (unsigned int*)(S + kTU * kSel);  // [warps][256]

  const int tid = threadIdx.x;
  const int utile = blockIdx.x % n_utiles;
  const long long chunk = blockIdx.x / n_utiles;
  const long long base = chunk * kSel;
  const int u0 = utile * kTU;
  for (int t = 0; t < kSel / kChunk; ++t)
    ncf::score_tile<float, TT, kTU, 1, 4>(q, table, bias, B, D, num_items,
                                          u0, base + t * kChunk, kNegInf,
                                          stage, S + t * kChunk, kSel);
  __syncthreads();

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int u = u0 + warp;
  if (u >= B) return;  // warp-uniform; no block barrier follows
  const float* row = S + warp * kSel;
  unsigned int* h = hist + warp * 256;
  const unsigned int full = 0xffffffffu;

  // threshold value T (prefix, full mask) and how many of the keys equal
  // to T to take (need); or all: the chunk has at most k real scores
  unsigned int prefix = 0u, mask = 0u;
  int need = k, all = 0;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int d = lane; d < 256; d += 32) h[d] = 0u;
    __syncwarp();
    for (int i = lane; i < kSel; i += 32) {
      float v = row[i];
      unsigned int key = v > kNegInf ? ncf::mono_f32(v) : 0u;
      if (key != 0u && (key & mask) == prefix)
        atomicAdd(&h[(key >> shift) & 0xFFu], 1u);
    }
    __syncwarp();
    if (lane == 0) {
      if (shift == 24) {
        unsigned int total = 0u;
        for (int d = 0; d < 256; ++d) total += h[d];
        if ((int)total <= need) all = 1;
      }
      if (!all) {
        unsigned int cum = 0u;
        for (int d = 255; d >= 0; --d) {
          unsigned int hh = h[d];
          if ((int)(cum + hh) >= need) {
            prefix |= (unsigned int)d << shift;
            mask |= 0xFFu << shift;
            need -= (int)cum;
            break;
          }
          cum += hh;
        }
      }
    }
    prefix = __shfl_sync(full, prefix, 0);
    mask = __shfl_sync(full, mask, 0);
    need = __shfl_sync(full, need, 0);
    all = __shfl_sync(full, all, 0);
    __syncwarp();
    if (all) break;
  }

  unsigned long long* out =
      keys + ((long long)u * nchunks + chunk) * (long long)k;
  const unsigned int lt = (1u << lane) - 1u;
  int written = 0, eq_seen = 0;
  for (int i0 = 0; i0 < kSel; i0 += 32) {
    const int i = i0 + lane;
    const float v = row[i];
    const unsigned int key = v > kNegInf ? ncf::mono_f32(v) : 0u;
    const bool eq = !all && key != 0u && key == prefix;
    const unsigned int eqb = __ballot_sync(full, eq);
    const int eq_rank = eq_seen + __popc(eqb & lt);
    eq_seen += __popc(eqb);
    const bool take =
        key != 0u && (all || key > prefix || (eq && eq_rank < need));
    const unsigned int tb = __ballot_sync(full, take);
    if (take) {
      const unsigned int gid = (unsigned int)(base + i);
      out[written + __popc(tb & lt)] =
          ((unsigned long long)key << 32) | (unsigned int)(~gid);
    }
    written += __popc(tb);
  }
  for (int r = written + lane; r < k; r += 32) out[r] = 0ull;
}

__global__ void __launch_bounds__(kMergeThreads)
merge_exact_kernel(const unsigned long long* __restrict__ keys, int ncand,
                   int k, int early_items, float* __restrict__ out_vals,
                   int* __restrict__ out_ids) {
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
    ov[rank] = ncf::unmono_f32((unsigned int)(key >> 32));
    oi[rank] = (int)~(unsigned int)(key & 0xFFFFFFFFull);
  }
  if (n < k) {  // block-uniform: empty slots take the early items' best
    unsigned long long best = 0ull;
    for (int i = tid; i < ncand; i += kMergeThreads) {
      unsigned long long key = kb[i];
      int id = (int)~(unsigned int)(key & 0xFFFFFFFFull);
      if (key != 0ull && id < early_items && key > best) best = key;
    }
    atomicMax(&s_best, best);
    __syncthreads();
    int fill = 0;
    if (s_best != 0ull) fill = (int)~(unsigned int)(s_best & 0xFFFFFFFFull);
    for (int r = n + tid; r < k; r += kMergeThreads) {
      ov[r] = kNegInf;
      oi[r] = fill;
    }
  }
}

template <typename TT>
cudaError_t launch_pass1(const float* q, const void* table, const float* bias,
                         int B, int D, int num_items, int k, int nchunks,
                         unsigned long long* keys, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      exact_chunk_kernel<TT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return err;
  const int n_utiles = (B + kTU - 1) / kTU;
  exact_chunk_kernel<TT><<<(unsigned)((long long)nchunks * n_utiles),
                           kThreads, kSmemBytes, s>>>(
      q, (const TT*)table, bias, B, D, num_items, k, n_utiles, nchunks, keys);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q: [B, D] f32; table: [num_items, D], dtype 0 = float32, 1 = bfloat16;
// bias: [num_items] f32 or null.  early_items: the items before the last
// item block (its fill rule).  keys: [B, ceil(num_items / 2048) * k]
// uint64 scratch.  Returns a cudaError_t (0 on success); errors during the
// run surface at the next synchronisation.
int ncf_topk_exact(const float* q, const void* table, const float* bias,
                   int dtype, int B, int D, int num_items, int k,
                   int early_items, void* keys, float* out_vals,
                   int* out_ids, void* stream) {
  if (B <= 0 || D <= 0 || num_items <= 0 || k <= 0 || k > kMaxK ||
      early_items < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nchunks = (num_items + kSel - 1) / kSel;
  unsigned long long* kp = (unsigned long long*)keys;
  cudaError_t err =
      dtype == 0
          ? launch_pass1<float>(q, table, bias, B, D, num_items, k, nchunks,
                                kp, s)
          : launch_pass1<__nv_bfloat16>(q, table, bias, B, D, num_items, k,
                                        nchunks, kp, s);
  if (err != cudaSuccess) return (int)err;
  merge_exact_kernel<<<B, kMergeThreads, 0, s>>>(kp, nchunks * k, k,
                                                 early_items, out_vals,
                                                 out_ids);
  return (int)cudaGetLastError();
}

const char* ncf_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
