// Exact blocked top-k retrieval for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ncf_tpu/ops/topk.py::topk_scores_pallas
// (topk.py:161; body _topk_kernel, topk.py:121; pallas_call at
// topk.py:186).
//
// Function computed (the JAX kernel's): score[u, i] = q[u] . T[i] + bias[i]
// (f32 accumulate), exact top-k by (value desc, id asc): the reference
// extracts k rounds per item block with ties to the lowest column and
// merges the carry before the block, so equal values keep the lower id.
// Scores at or below NEG_INF (-3e38) never surface; slots left empty come
// back as NEG_INF with the reference's id: the best item before the last
// item block of `block_items`, or 0 (the carry's first row entering the
// last block).  Ids are not clamped.  k <= 256, D <= 128.
//
// What bounds it on this card: at B=64 users, 4M items, D=64 in f32 the
// 1.04 GB table takes 0.31 ms at 3.35 TB/s and the split-TF32 product
// (three TF32 products, 1.0e11 operations) 0.20 ms at 495 TFLOP/s: bound
// by the table's bytes.
//
// Design:
//   pass 1 (exact_tc_kernel): persistent blocks, each holding one tile of
//     TU users (up to 64, the table then staged once for 64 users) and
//     walking the 128-item tiles walker, walker + nwalk, ... through
//     topk_common.cuh's tensor-core tile and cp.async ring (the product
//     is split-TF32 for f32 tables, two TF32 products for bf16 tables with
//     the queries kept in f32).  Each user keeps a running threshold, the
//     k-th best 64-bit key so far (value << 32 | ~id: keys are unique and
//     totally ordered, so equal values go to the lower id), and a
//     candidate buffer in shared memory.  Four threads a user scan the
//     tile's scores; only a score whose key clears the threshold enters
//     the buffer.  When a buffer could overflow on the next tile, one warp
//     keeps its k best (a bitwise search for the k-th value, below the
//     bits all candidates share, then a compaction) and raises the
//     threshold.  After the first few tiles almost no score passes, so
//     the selection no longer histograms every score.  At the end each
//     (user, block) writes its k best keys (0 for empty slots) into its own
//     slice of the scratch: nothing depends on the order in which blocks
//     run.
//   pass 2 (merge_exact_kernel): one block per user selects the k largest
//     of the nwalk * k keys (topk_common.cuh's radix select), ranks them
//     and fills the empty slots.  Slots are empty only when fewer than k
//     real scores exist in all, and then every real score was kept, so the
//     fill rule can be computed from the keys.
// Both launches go on the caller's stream; the caller owns all buffers.

#include "topk_common.cuh"

namespace {

namespace tc = ncf::tc;
using ncf::kNegInf;
constexpr int kMaxK = 256;
constexpr int kMergeThreads = 512;

// Keep the k largest of the n (> k) unique nonzero keys of buf[0, n) in
// buf[0, k), unordered, and return a threshold T with exactly those k keys
// >= T.  One warp.  First the k-th largest value word V, searched bit by
// bit below the bits every candidate shares; only when more than k keys
// reach V (equal values) the id words of those at V decide.
__device__ unsigned long long warp_keep_top(unsigned long long* buf, int n,
                                            int k) {
  const unsigned int full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  unsigned int hmax = 0u, hmin = 0xffffffffu;
  for (int i = lane; i < n; i += 32) {
    const unsigned int h = (unsigned int)(buf[i] >> 32);
    hmax = h > hmax ? h : hmax;
    hmin = h < hmin ? h : hmin;
  }
  hmax = __reduce_max_sync(full, hmax);
  hmin = __reduce_min_sync(full, hmin);
  unsigned int V = hmax;
  if (hmax != hmin) {
    const int top = 31 - __clz(hmax ^ hmin);
    V = top == 31 ? 0u : hmax & ~((2u << top) - 1u);
    for (int bit = top; bit >= 0; --bit) {
      const unsigned int c = V | (1u << bit);
      unsigned int cnt = 0;
      for (int i = lane; i < n; i += 32)
        cnt += (unsigned int)(buf[i] >> 32) >= c;
      if ((int)__reduce_add_sync(full, cnt) >= k) V = c;
    }
  }
  unsigned int gt = 0, eq = 0;
  for (int i = lane; i < n; i += 32) {
    const unsigned int h = (unsigned int)(buf[i] >> 32);
    gt += h > V;
    eq += h == V;
  }
  gt = __reduce_add_sync(full, gt);
  eq = __reduce_add_sync(full, eq);
  unsigned long long T = (unsigned long long)V << 32;
  if ((int)(gt + eq) > k) {  // equal values: the (k - gt)-th id word at V
    const int need = k - (int)gt;
    unsigned int L = 0u;
    for (int bit = 31; bit >= 0; --bit) {
      const unsigned int c = L | (1u << bit);
      unsigned int cnt = 0;
      for (int i = lane; i < n; i += 32) {
        const unsigned long long key = buf[i];
        cnt += (unsigned int)(key >> 32) == V && (unsigned int)key >= c;
      }
      if ((int)__reduce_add_sync(full, cnt) >= need) L = c;
    }
    T |= L;
  }
  const unsigned int lt = (1u << lane) - 1u;
  int written = 0;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const unsigned long long key = i < n ? buf[i] : 0ull;
    const bool take = i < n && key >= T;
    const unsigned int b = __ballot_sync(full, take);
    __syncwarp();
    if (take) buf[written + __popc(b & lt)] = key;  // never past index i
    written += __popc(b);
    __syncwarp();
  }
  return T;
}

template <typename TT, int TU>
__host__ size_t exact_smem_bytes(int D, int cap) {
  return tc::ring_smem_bytes<float, TT, TU>(D) + (size_t)TU * cap * 8 +
         (size_t)TU * 8 + (size_t)TU * 4;
}

template <typename TT, int TU>
__global__ void __launch_bounds__(tc::kThreads)
exact_tc_kernel(const float* __restrict__ q, const TT* __restrict__ table,
                const float* __restrict__ bias, int B, int D, int num_items,
                int k, int cap, int n_utiles, int mode,
                unsigned long long* __restrict__ keys) {
  extern __shared__ __align__(16) unsigned char smem[];
  const tc::Geom g = tc::geom<float, TT, TU>(D);
  unsigned char* qs = smem;
  unsigned char* ring = smem + g.q_bytes;
  unsigned long long* cand =                        // [TU][cap]
      (unsigned long long*)(ring + tc::kStages * g.stage_bytes);
  unsigned long long* thr = cand + (size_t)TU * cap;  // [TU]
  int* cnt = (int*)(thr + TU);                        // [TU]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int utile = blockIdx.x % n_utiles;
  const int walker = blockIdx.x / n_utiles;
  const int nwalk = gridDim.x / n_utiles;
  const int u0 = utile * TU;
  const int nu = B - u0 < TU ? B - u0 : TU;
  const int ul = tid >> 2, c = tid & 3;  // TU * 4 threads scan the scores
  tc::stage_queries<float, TU>(q, B, D, u0, g, qs);
  for (int i = tid; i < TU; i += tc::kThreads) {
    thr[i] = 0ull;
    cnt[i] = 0;
  }
  __syncthreads();

  tc::stream_tiles<float, TT, TU>(
      table, bias, D, num_items, walker, nwalk, mode, kNegInf, g, qs, ring,
      [&](const float* S, long long row0) {
        // thread (user ul, 32-item chunk c); a score passes when its key
        // clears the user's threshold (its value at least the
        // threshold's, the cheap test first)
        const long long left = num_items - row0 - c * 32;
        const int lim = left < 32 ? (int)left : 32;
        if (ul < nu && lim > 0) {
          const unsigned long long t = thr[ul];
          const float tv =
              t ? ncf::unmono_f32((unsigned int)(t >> 32)) : kNegInf;
          const float* row = S + ul * tc::kSStride + tc::score_slot(c * 32);
          const unsigned int id0 = (unsigned int)(row0 + c * 32);
#pragma unroll 8
          for (int i = 0; i < 32; ++i) {
            const float v = row[i];
            if (i >= lim || !(v > kNegInf && v >= tv)) continue;
            const unsigned long long key =
                ((unsigned long long)ncf::mono_f32(v) << 32) |
                (unsigned int)(~(id0 + i));
            if (key > t) {
              const int slot = atomicAdd(&cnt[ul], 1);
              cand[(size_t)ul * cap + slot] = key;
            }
          }
        }
        __syncthreads();
        // room for the next tile's 128 scores in every buffer
        for (int w = warp; w < nu; w += tc::kThreads / 32) {
          const int n = cnt[w];
          if (n > cap - tc::kItems) {
            const unsigned long long t =
                warp_keep_top(cand + (size_t)w * cap, n, k);
            if (lane == 0) {
              thr[w] = t;
              cnt[w] = k;
            }
            __syncwarp();
          }
        }
      });

  for (int w = warp; w < nu; w += tc::kThreads / 32) {
    int n = cnt[w];
    unsigned long long* buf = cand + (size_t)w * cap;
    if (n > k) {
      warp_keep_top(buf, n, k);
      n = k;
    }
    unsigned long long* out =
        keys + ((long long)(u0 + w) * nwalk + walker) * (long long)k;
    for (int j = lane; j < k; j += 32) out[j] = j < n ? buf[j] : 0ull;
  }
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
  const int n =
      ncf::select_top_keys<kMergeThreads, kMaxK, 4>(kb, ncand, k, sel);
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

template <typename TT, int TU>
cudaError_t launch_tu(const float* q, const void* table, const float* bias,
                      int B, int D, int num_items, int k, int cap, int nwalk,
                      unsigned long long* keys, cudaStream_t s) {
  static const cudaError_t attr =
      tc::allow_max_smem((const void*)exact_tc_kernel<TT, TU>);
  if (attr != cudaSuccess) return attr;
  const int n_utiles = (B + TU - 1) / TU;
  const int mode = tc::copy_mode(table, D, (int)sizeof(TT));
  exact_tc_kernel<TT, TU><<<(unsigned)((long long)nwalk * n_utiles),
                            tc::kThreads, exact_smem_bytes<TT, TU>(D, cap),
                            s>>>(q, (const TT*)table, bias, B, D, num_items, k,
                                 cap, n_utiles, mode, keys);
  return cudaGetLastError();
}

// the ring and the candidate buffers decide the user tile
template <typename TT>
cudaError_t launch_pass1(const float* q, const void* table, const float* bias,
                         int B, int D, int num_items, int k, int nwalk,
                         unsigned long long* keys, cudaStream_t s) {
  int optin = 0;
  const cudaError_t err = tc::smem_optin(&optin);
  if (err != cudaSuccess) return err;
  // room for k kept keys and one tile's 128 scores
  const int cap = (k + tc::kItems + 31) / 32 * 32;
  const int tu = tc::pick_user_tile(B, optin, [&](int t) {
    return t == 64 ? exact_smem_bytes<TT, 64>(D, cap)
           : t == 32 ? exact_smem_bytes<TT, 32>(D, cap)
           : t == 16 ? exact_smem_bytes<TT, 16>(D, cap)
                     : exact_smem_bytes<TT, 8>(D, cap);
  });
  if (tu == 0) return cudaErrorInvalidValue;
#define NCF_LAUNCH(TU_)                                                    \
  return launch_tu<TT, TU_>(q, table, bias, B, D, num_items, k, cap, nwalk, \
                            keys, s)
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
// bias: [num_items] f32 or null.  early_items: the items before the last
// item block (its fill rule).  nwalk: blocks walking the item tiles per
// user tile (any value >= 1).  keys: [B, nwalk * k] uint64 scratch.
// Returns a cudaError_t (0 on success); errors during the run surface at
// the next synchronisation.
int ncf_topk_exact(const float* q, const void* table, const float* bias,
                   int dtype, int B, int D, int num_items, int k,
                   int early_items, int nwalk, void* keys, float* out_vals,
                   int* out_ids, void* stream) {
  if (B <= 0 || D <= 0 || D > tc::kMaxD || num_items <= 0 || k <= 0 ||
      k > kMaxK || early_items < 0 || nwalk <= 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned long long* kp = (unsigned long long*)keys;
  cudaError_t err =
      dtype == 0
          ? launch_pass1<float>(q, table, bias, B, D, num_items, k, nwalk, kp,
                                s)
          : launch_pass1<__nv_bfloat16>(q, table, bias, B, D, num_items, k,
                                        nwalk, kp, s);
  if (err != cudaSuccess) return (int)err;
  merge_exact_kernel<<<B, kMergeThreads, 0, s>>>(kp, nwalk * k, k,
                                                 early_items, out_vals,
                                                 out_ids);
  return (int)cudaGetLastError();
}

const char* ncf_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
