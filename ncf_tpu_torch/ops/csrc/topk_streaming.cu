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
// D=64, f32 table) the product is 3.3e10 FLOP against 1.04 GB of table:
// 0.49 ms at the 67 TFLOP/s f32 CUDA-core peak vs 0.31 ms at 3.35 TB/s, so
// it is compute-bound in f32; at B=1 it is bound by the table bytes.
//
// Design (simple and right first):
//   pass 1 (seg_topk_kernel): one block scores a chunk of 128 items against
//     a tile of TU users with a register-tiled f32 FMA product (operands
//     staged through shared memory in 32-deep slices of D, so the table is
//     read once per user tile and the [B, I] score matrix never reaches
//     device memory).  The chunk's scores go to shared memory; one warp
//     per (user, segment) reduces them to the segment's top seg_top and
//     writes each as a 64-bit key (monotone f32 bits << 32 | ~pos), pos =
//     ((block * seg_top + rank) * nseg + segment) * seg_width + offset, so
//     a larger key is exactly a better candidate under (value desc, then
//     merge order) and the id is recovered from pos.
//     Blocks of one item chunk over consecutive user tiles run next to
//     each other, so a chunk is read from device memory about once and
//     then from L2.  Blocks are independent: nothing carries between them,
//     unlike the TPU grid's running top-k scratch.
//   pass 2 (merge_topk_kernel): one block per user selects the k largest
//     candidate keys by an MSB-first radix select over the 64-bit keys
//     (8-bit digits, stopping as soon as the boundary bin is taken whole),
//     gathers the <= 64 winners in shared memory and ranks them.  When
//     fewer than k candidates exist, the block also takes the largest key
//     of the blocks before the last for the empty slots' id.
// Both launches go on the caller's stream; the caller owns all buffers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -3.0e38f;
#define NCF_MINUS_INF __int_as_float(0xff800000)
constexpr int kChunk = 128;    // items per pass-1 block
constexpr int kDk = 32;        // D-slice staged per step
constexpr int kThreads = 256;  // pass-1 threads
constexpr int kMergeThreads = 512;
constexpr int kMaxK = 64;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ unsigned long long make_key(float v,
                                                       unsigned int pos) {
  unsigned int b = __float_as_uint(v);
  unsigned int m = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((unsigned long long)m << 32) | (unsigned int)(~pos);
}

__device__ __forceinline__ float key_value(unsigned long long key) {
  unsigned int m = (unsigned int)(key >> 32);
  unsigned int b = (m & 0x80000000u) ? (m & 0x7FFFFFFFu) : ~m;
  return __uint_as_float(b);
}

// pos -> item id: pos = ((block * seg_top + rank) * nseg + seg) *
// seg_width + off, id = (block * nseg + seg) * seg_width + off
__device__ __forceinline__ int key_id(unsigned long long key, int seg_width,
                                      int seg_top, int nseg) {
  unsigned int pos = ~(unsigned int)(key & 0xFFFFFFFFull);
  unsigned int off = pos % (unsigned)seg_width;
  unsigned int t = pos / (unsigned)seg_width;
  unsigned int seg = t % (unsigned)nseg;
  unsigned int block = t / (unsigned)nseg / (unsigned)seg_top;
  return (int)((block * (unsigned)nseg + seg) * (unsigned)seg_width + off);
}

__device__ __forceinline__ bool better(float va, int oa, float vb, int ob) {
  return va > vb || (va == vb && oa < ob);
}

__device__ __forceinline__ void insert2(float v, int o, float& v1, int& o1,
                                        float& v2, int& o2) {
  if (better(v, o, v1, o1)) {
    v2 = v1; o2 = o1; v1 = v; o1 = o;
  } else if (better(v, o, v2, o2)) {
    v2 = v; o2 = o;
  }
}

// TU users x 128 items per block; each thread owns UM users x IM items,
// strided (user ty + m*TY, item tx + j*TX) so shared reads are conflict-free.
template <typename T, int TU, int UM, int IM>
__global__ void __launch_bounds__(kThreads)
seg_topk_kernel(const T* __restrict__ q, const T* __restrict__ table,
                const float* __restrict__ bias, int B, int D, int n_rows,
                int seg_width, int seg_top, int nseg, int n_utiles,
                int ncand, unsigned long long* __restrict__ keys) {
  constexpr int TX = kChunk / IM;
  constexpr int TY = TU / UM;
  static_assert(TX * TY == kThreads, "thread tiling must cover the block");
  constexpr int QSTR = TU + 1;
  constexpr int TSTR = kChunk + 1;
  constexpr int SSTR = kChunk + 1;
  constexpr int STAGE = kDk * (QSTR + TSTR);
  constexpr int SCORES = TU * SSTR;
  __shared__ float smem[STAGE > SCORES ? STAGE : SCORES];
  float* Qs = smem;               // [kDk][QSTR]
  float* Ts = smem + kDk * QSTR;  // [kDk][TSTR]
  float* S = smem;                // [TU][SSTR], reused after the product

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int utile = blockIdx.x % n_utiles;
  const long long chunk = blockIdx.x / n_utiles;
  const long long row0 = chunk * kChunk;
  const int u0 = utile * TU;

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

  // epilogue: bias, padded rows out of reach
#pragma unroll
  for (int m = 0; m < UM; ++m) {
#pragma unroll
    for (int j = 0; j < IM; ++j) {
      int ul = ty + m * TY;
      int il = tx + j * TX;
      long long row = row0 + il;
      float v = NCF_MINUS_INF;
      if (row < n_rows) v = acc[m][j] + (bias ? bias[row] : 0.f);
      S[ul * SSTR + il] = v;
    }
  }
  __syncthreads();

  // one warp per (user, segment): top-seg_top by (value desc, offset asc)
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
    float v1 = NCF_MINUS_INF, v2 = NCF_MINUS_INF;
    int o1 = 0x7FFFFFFF, o2 = 0x7FFFFFFF;
    for (int e = 0; e < per; ++e) {
      int off = lane + e * 32;
      insert2(S[ul * SSTR + s * seg_width + off], off, v1, o1, v2, o2);
    }
#pragma unroll
    for (int x = 16; x > 0; x >>= 1) {
      float w1 = __shfl_xor_sync(0xffffffffu, v1, x);
      int p1 = __shfl_xor_sync(0xffffffffu, o1, x);
      float w2 = __shfl_xor_sync(0xffffffffu, v2, x);
      int p2 = __shfl_xor_sync(0xffffffffu, o2, x);
      insert2(w1, p1, v1, o1, v2, o2);
      insert2(w2, p2, v1, o1, v2, o2);
    }
    if (lane < seg_top) {
      float v = lane == 0 ? v1 : v2;
      int o = lane == 0 ? o1 : o2;
      unsigned long long key = 0ull;  // empty candidate
      if (v > kNegInf) {
        const unsigned int blk = (unsigned int)(gseg / nseg);
        const unsigned int sib = (unsigned int)(gseg % nseg);
        key = make_key(v, ((blk * seg_top + lane) * nseg + sib) * seg_width
                              + (unsigned int)o);
      }
      keys[(long long)u * ncand + gseg * seg_top + lane] = key;
    }
  }
}

__global__ void __launch_bounds__(kMergeThreads)
merge_topk_kernel(const unsigned long long* __restrict__ keys, int ncand,
                  int early, int k, int num_items, int seg_width,
                  int seg_top, int nseg, float* __restrict__ out_vals,
                  int* __restrict__ out_ids) {
  __shared__ unsigned int hist[256];
  __shared__ unsigned long long sel[kMaxK];
  __shared__ unsigned long long s_prefix, s_mask, s_best;
  __shared__ int s_need, s_done, s_count;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const unsigned long long* kb = keys + (long long)blockIdx.x * ncand;
  if (tid == 0) {
    s_prefix = 0ull; s_mask = 0ull; s_best = 0ull;
    s_need = k; s_done = 0; s_count = 0;
  }
  __syncthreads();

  // MSB-first radix select of the k-th largest nonzero key; keys are
  // unique (ids are), so the boundary bin always ends with one key
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += kMergeThreads) hist[i] = 0u;
    __syncthreads();
    const unsigned long long prefix = s_prefix, mask = s_mask;
    for (int base = 0; base < ncand; base += kMergeThreads) {
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
  for (int i = tid; i < ncand; i += kMergeThreads) {
    unsigned long long key = kb[i];
    if (key != 0ull && (key & mask) >= prefix) {
      int slot = atomicAdd(&s_count, 1);
      if (slot < kMaxK) sel[slot] = key;
    }
  }
  __syncthreads();
  const int n = s_count < k ? s_count : k;
  float* ov = out_vals + (long long)blockIdx.x * k;
  int* oi = out_ids + (long long)blockIdx.x * k;
  if (tid < n) {
    unsigned long long key = sel[tid];
    int rank = 0;
    for (int j = 0; j < n; ++j) rank += sel[j] > key;
    int id = key_id(key, seg_width, seg_top, nseg);
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
    if (s_best != 0ull) fill = key_id(s_best, seg_width, seg_top, nseg);
    fill = fill < num_items - 1 ? fill : num_items - 1;
    for (int r = n + tid; r < k; r += kMergeThreads) {
      ov[r] = kNegInf;
      oi[r] = fill;
    }
  }
}

template <typename T>
cudaError_t launch_pass1(const void* q, const void* table, const float* bias,
                         int B, int D, int n_rows, int seg_width, int seg_top,
                         int nseg, int ncand, unsigned long long* keys,
                         cudaStream_t stream) {
  const long long nchunks = ((long long)n_rows + kChunk - 1) / kChunk;
  if (B <= 8) {
    const int n_utiles = (B + 7) / 8;
    seg_topk_kernel<T, 8, 1, 4><<<(unsigned)(nchunks * n_utiles), kThreads,
                                  0, stream>>>(
        (const T*)q, (const T*)table, bias, B, D, n_rows, seg_width, seg_top,
        nseg, n_utiles, ncand, keys);
  } else {
    const int n_utiles = (B + 63) / 64;
    seg_topk_kernel<T, 64, 4, 8><<<(unsigned)(nchunks * n_utiles), kThreads,
                                   0, stream>>>(
        (const T*)q, (const T*)table, bias, B, D, n_rows, seg_width, seg_top,
        nseg, n_utiles, ncand, keys);
  }
  return cudaGetLastError();
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
      (seg_width != 32 && seg_width != 64 && seg_width != 128))
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
