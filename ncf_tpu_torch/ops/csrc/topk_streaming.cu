// Streaming segment top-k retrieval for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ncf_tpu/ops/topk.py::topk_scores_streaming
// (body _streaming_kernel, topk.py:381; pallas_call at topk.py:553).
//
// Function computed (the JAX kernel's, which is NOT plain exact top-k):
//   score[u, i] = q[u] . T[i] + bias[i]          (f32 accumulate)
//   items are cut into segments of seg_width consecutive global ids; each
//   segment surfaces its best seg_top (value desc, lower offset first);
//   the result is the top-k of those candidates.  Equal values keep the
//   order of the reference's running merge [carry; m1 of every segment;
//   m2 of every segment]: item block (nseg segments), then rank (m1
//   before m2), then segment.  Rows >= n_rows and scores <= NEG_INF
//   (-3e38, the bias of padded rows) never surface; slots left empty come
//   back as NEG_INF with the reference's id there: the best candidate of
//   the blocks before the last (the carry's top-1 entering the last
//   block), or 0 with one block.
//
// What bounds it on this card: at the serving shape (B=64 users, 4M items,
// D=64, f32 table) the 1.04 GB table takes 0.31 ms at 3.35 TB/s, and the
// split-TF32 product (three TF32 products, 1.0e11 operations) 0.20 ms at
// 495 TFLOP/s: bound by the table's bytes, at every batch size up to 64.
// At B=1024 x 1M in bf16 the product (0.13 ms at 989 TFLOP/s) bounds it.
//
// Design:
//   pass 1 (seg_topk_tc_kernel): persistent blocks, each holding one tile
//     of TU users (8, 16, 32 or 64: the smallest that covers B, within
//     the shared memory) and walking the 128-item tiles walker, walker +
//     nwalk, ...  topk_common.cuh's tensor-core tile scores each tile
//     (items on the M side, users on the N side; split-TF32 mma.sync for
//     f32, bf16 mma.sync for bf16) while cp.async copies the next tile
//     into the second stage of the ring, so table loads overlap the
//     product.  The tile's scores land in shared memory; four threads a
//     user each take the top two of 32 items, the chunks of a segment
//     merge by shuffles, and the segment's top seg_top are written each
//     as a 64-bit key (monotone f32 bits << 32 | ~pos), pos =
//     ((block * seg_top + rank) * nseg + segment) * seg_width + offset, so
//     a larger key is exactly a better candidate under (value desc, then
//     merge order) and the id is recovered from pos.  Blocks of one
//     walker over the user tiles read the same item tiles at the same
//     time, so the table comes from device memory about once and then
//     from L2.  Nothing carries between blocks, unlike the TPU grid's
//     running top-k scratch; every key has its own slot.
//   pass 2 (merge_topk_kernel): one block per user selects the k largest
//     candidate keys by an MSB-first radix select over the 64-bit keys
//     (8-bit digits, stopping as soon as the boundary bin is taken whole,
//     eight loads in flight a thread; topk_common.cuh, shared with the
//     other top-k kernels),
//     gathers the <= 64 winners in shared memory and ranks them.  When
//     fewer than k candidates exist, the block also takes the largest key
//     of the blocks before the last for the empty slots' id.
// Both launches go on the caller's stream; the caller owns all buffers.

#include "topk_common.cuh"

namespace {

namespace tc = ncf::tc;
using ncf::kNegInf;
#define NCF_MINUS_INF __int_as_float(0xff800000)
constexpr int kMergeThreads = 512;
constexpr int kMaxK = 64;

__device__ __forceinline__ unsigned long long make_key(float v,
                                                       unsigned int pos) {
  return ((unsigned long long)ncf::mono_f32(v) << 32) | (unsigned int)(~pos);
}

__device__ __forceinline__ float key_value(unsigned long long key) {
  return ncf::unmono_f32((unsigned int)(key >> 32));
}

template <typename T, int TU>
__global__ void __launch_bounds__(tc::kThreads)
seg_topk_tc_kernel(const T* __restrict__ q, const T* __restrict__ table,
                   const float* __restrict__ bias, int B, int D, int n_rows,
                   int seg_width, int seg_top, int nseg, int n_utiles,
                   int ncand, int mode, unsigned long long* __restrict__ keys) {
  extern __shared__ __align__(16) unsigned char smem[];
  const tc::Geom g = tc::geom<T, T, TU>(D);
  unsigned char* qs = smem;
  unsigned char* ring = smem + g.q_bytes;

  const int tid = threadIdx.x;
  const int utile = blockIdx.x % n_utiles;
  const int walker = blockIdx.x / n_utiles;
  const int nwalk = gridDim.x / n_utiles;
  const int u0 = utile * TU;
  tc::stage_queries<T, TU>(q, B, D, u0, g, qs);
  __syncthreads();

  const unsigned int nseg_total =
      (unsigned int)(((long long)n_rows + seg_width - 1) / seg_width);
  const int chunks = seg_width / 32;     // 32-item chunks of a segment
  // thread (user ul, 32-item chunk c): TU * 4 threads, whole warps
  const int ul = tid >> 2, c = tid & 3;
  // scores + bias, padded rows out of reach; then each thread takes its
  // chunk's top two by (value desc, offset asc): offsets ascend, so a
  // later equal value never displaces an earlier one; the chunks of a
  // segment (neighbouring lanes) merge by shuffles
  tc::stream_tiles<T, T, TU>(
      table, bias, D, n_rows, walker, nwalk, mode, NCF_MINUS_INF, g, qs, ring,
      [&](const float* S, long long row0) {
        if (ul >= TU) return;                    // warp-uniform
        const float* row = S + ul * tc::kSStride + tc::score_slot(c * 32);
        float v1 = NCF_MINUS_INF, v2 = NCF_MINUS_INF;
        int o1 = 0x7FFFFFFF, o2 = 0x7FFFFFFF;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const float v = row[i];
          if (v > v1) {
            v2 = v1; o2 = o1; v1 = v; o1 = c * 32 + i;
          } else if (v > v2) {
            v2 = v; o2 = c * 32 + i;
          }
        }
        for (int x = 1; x < chunks; x <<= 1) {
          const float w1 = __shfl_xor_sync(0xffffffffu, v1, x);
          const int p1 = __shfl_xor_sync(0xffffffffu, o1, x);
          const float w2 = __shfl_xor_sync(0xffffffffu, v2, x);
          const int p2 = __shfl_xor_sync(0xffffffffu, o2, x);
          ncf::insert2(w1, p1, v1, o1, v2, o2);
          ncf::insert2(w2, p2, v1, o1, v2, o2);
        }
        const int u = u0 + ul;
        const unsigned int gseg =                // 4 / chunks segments a tile
            (unsigned int)(row0 / tc::kItems) * (4 / chunks) + c / chunks;
        if (c % chunks != 0 || u >= B || gseg >= nseg_total) return;
        const unsigned int blk = gseg / (unsigned int)nseg;
        const unsigned int sib = gseg % (unsigned int)nseg;
        unsigned long long* out =
            keys + (long long)u * ncand + (long long)gseg * seg_top;
        for (int r = 0; r < seg_top; ++r) {
          const float v = r == 0 ? v1 : v2;
          const unsigned int off = (unsigned int)(r == 0 ? o1 : o2) &
                                   (unsigned int)(seg_width - 1);
          out[r] = v > kNegInf  // else an empty candidate
                       ? make_key(v, ((blk * seg_top + r) * nseg + sib) *
                                         seg_width + off)
                       : 0ull;
        }
      });
}

__global__ void __launch_bounds__(kMergeThreads)
merge_topk_kernel(const unsigned long long* __restrict__ keys, int ncand,
                  int early, int k, int num_items, int seg_width,
                  int seg_top, int nseg, float* __restrict__ out_vals,
                  int* __restrict__ out_ids) {
  __shared__ unsigned long long sel[kMaxK];
  __shared__ unsigned long long s_best;

  const int tid = threadIdx.x;
  const unsigned long long* kb = keys + (long long)blockIdx.x * ncand;
  if (tid == 0) s_best = 0ull;
  const int n =
      ncf::select_top_keys<kMergeThreads, kMaxK, 8>(kb, ncand, k, sel);
  float* ov = out_vals + (long long)blockIdx.x * k;
  int* oi = out_ids + (long long)blockIdx.x * k;
  if (tid < n) {
    unsigned long long key = sel[tid];
    int rank = 0;
    for (int j = 0; j < n; ++j) rank += sel[j] > key;
    int id = ncf::key_id(key, seg_width, seg_top, nseg);
    ov[rank] = key_value(key);
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

template <typename T, int TU>
cudaError_t launch_tu(const void* q, const void* table, const float* bias,
                      int B, int D, int n_rows, int seg_width, int seg_top,
                      int nseg, int ncand, unsigned long long* keys,
                      cudaStream_t stream) {
  static const cudaError_t attr =
      tc::allow_max_smem((const void*)seg_topk_tc_kernel<T, TU>);
  if (attr != cudaSuccess) return attr;
  const size_t smem = tc::ring_smem_bytes<T, T, TU>(D);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, seg_topk_tc_kernel<T, TU>, tc::kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int n_utiles = (B + TU - 1) / TU;
  const long long ntiles = ((long long)n_rows + tc::kItems - 1) / tc::kItems;
  long long nwalk = (long long)per_sm * sms / n_utiles;
  if (nwalk > ntiles) nwalk = ntiles;
  if (nwalk < 1) nwalk = 1;
  const int mode = tc::copy_mode(table, D, (int)sizeof(T));
  seg_topk_tc_kernel<T, TU><<<(unsigned)(nwalk * n_utiles), tc::kThreads,
                              smem, stream>>>(
      (const T*)q, (const T*)table, bias, B, D, n_rows, seg_width, seg_top,
      nseg, n_utiles, ncand, mode, keys);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_pass1(const void* q, const void* table, const float* bias,
                         int B, int D, int n_rows, int seg_width, int seg_top,
                         int nseg, int ncand, unsigned long long* keys,
                         cudaStream_t stream) {
  int optin = 0;
  const cudaError_t err = tc::smem_optin(&optin);
  if (err != cudaSuccess) return err;
  const int tu = tc::pick_user_tile(B, optin, [&](int t) {
    return t == 64 ? tc::ring_smem_bytes<T, T, 64>(D)
           : t == 32 ? tc::ring_smem_bytes<T, T, 32>(D)
           : t == 16 ? tc::ring_smem_bytes<T, T, 16>(D)
                     : tc::ring_smem_bytes<T, T, 8>(D);
  });
  if (tu == 0) return cudaErrorInvalidValue;
#define NCF_LAUNCH(TU_)                                                     \
  return launch_tu<T, TU_>(q, table, bias, B, D, n_rows, seg_width, seg_top, \
                           nseg, ncand, keys, stream)
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

// dtype: 0 = float32, 1 = bfloat16 (q and table share it).  bias may be
// null.  nseg: segments per item block of the reference's merge; nblocks
// = ceil(n_rows / (nseg * seg_width)).  keys: [B, ncand] uint64 scratch
// with ncand = ceil(n_rows / seg_width) * seg_top.  Returns a cudaError_t
// (0 on success); errors during the run surface at the caller's next
// synchronisation.
int ncf_topk_streaming(const void* q, const void* table, const float* bias,
                       int dtype, int B, int D, int n_rows, int num_items,
                       int seg_width, int seg_top, int nseg, int nblocks,
                       int k, void* keys, float* out_vals, int* out_ids,
                       void* stream) {
  if (B <= 0 || D <= 0 || n_rows <= 0 || num_items <= 0 || k <= 0 ||
      k > kMaxK || (seg_top != 1 && seg_top != 2) || nseg <= 0 ||
      nblocks <= 0 ||
      (seg_width != 32 && seg_width != 64 && seg_width != 128) ||
      D > tc::kMaxD)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int ncand = (int)(((long long)n_rows + seg_width - 1) / seg_width)
                    * seg_top;
  unsigned long long* kp = (unsigned long long*)keys;
  cudaError_t err =
      dtype == 0
          ? launch_pass1<float>(q, table, bias, B, D, n_rows, seg_width,
                                seg_top, nseg, ncand, kp, s)
          : launch_pass1<__nv_bfloat16>(q, table, bias, B, D, n_rows,
                                        seg_width, seg_top, nseg, ncand, kp,
                                        s);
  if (err != cudaSuccess) return (int)err;
  long long early = (long long)(nblocks - 1) * nseg * seg_top;
  if (early > ncand) early = ncand;
  merge_topk_kernel<<<B, kMergeThreads, 0, s>>>(
      kp, ncand, (int)early, k, num_items, seg_width, seg_top, nseg,
      out_vals, out_ids);
  return (int)cudaGetLastError();
}

const char* ncf_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
