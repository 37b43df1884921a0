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
// the bytes bound it.  The first version ran __dp4a on the CUDA cores (4
// MACs an instruction) and was compute-bound at 23x the byte bound.
//
// Design:
//   pass 1 (seg_topk_s8_kernel): the product on the int8 tensor cores,
//     mma.sync m16n8k32 s8 x s8 -> s32, in the shape of B5's tile
//     (topk_common.cuh's tc::): 128 items a tile on the M side (16 a
//     warp), a tile of TU users (8, 16, 32 or 64: the smallest that
//     covers B) on the N side, persistent blocks that each keep one user
//     tile and walk the item tiles walker, walker + nwalk, ...  K is
//     zero-padded to a multiple of 32 (three k-steps at K=67): the padded
//     query bytes are zero, so whatever the table side holds there adds
//     nothing.  Integer sums are exact in any order, so every tile, user
//     tile and k order gives the plain version's acc bit for bit.
//     The table stays in the reference's [Ipad, K] layout.  Rows of K
//     bytes are not 16-byte aligned, but the 128 rows of a tile are one
//     contiguous span of 128*K bytes, a multiple of 16 starting at a
//     multiple of 16: it streams through a four-stage cp.async ring (two
//     or one for rows too wide to fit four) as 16-byte chunks (the last,
//     short tile's tail zero-filled), with byte copies only where the
//     table's base is not 16-byte aligned; three tiles' copies stay in
//     flight while one is scored, two barriers a tile.  The A
//     fragments are read straight from that span: the 4 bytes at row r,
//     column k are two aligned words of it shifted together
//     (__funnelshift_r), with no repack pass (one that made them
//     ldmatrix loads measured slower); the queries are staged once a
//     block as K-padded rows and, for K <= 128 bytes, their fragments
//     loaded once into registers (else by ldmatrix every tile).  The
//     tile's int32 scores land in shared memory (skewed rows, as B5's);
//     four threads a user each take the best two of 32 items through the
//     reference's packed key (a max, and a max of mins for the second),
//     the chunks of a segment merge by shuffles, and each winner is
//     written as a 64-bit key (acc ^ sign) << 32 | ~pos, pos encoded as
//     in B5, so a larger key is exactly a better candidate.
//   pass 2 (merge_int8_kernel): one block per user selects the k largest
//     keys (topk_common.cuh's radix select, eight loads in flight a
//     thread), ranks them, dequantizes.
// Both launches go on the caller's stream; the caller owns all buffers.

#include <climits>

#include "topk_common.cuh"

namespace {

namespace tc = ncf::tc;
using ncf::kNegInf;
constexpr int kMergeThreads = 512;
constexpr int kMaxK = 64;
constexpr int kMaxKBytes = 1027;         // D <= 1024: keys stay in int32
constexpr float kPadFloor = -32385.0f;   // topk.py::_PAD_FLOOR

// The queries' fragments stay in registers for rows of K <= 128 bytes
// (every served width: the product is then at most kRegSteps k-steps
// deep); wider rows read them from shared memory every tile.
constexpr int kRegSteps = 4;

// staged geometry of a block holding TU users: the queries, the tile's
// [TU][kSStride] int32 scores and a ring of NST spans
struct Geom8 {
  int kp;           // K padded to the product depth (32 bytes a k-step)
  int qw;           // 32-bit words per staged query row (== 4 mod 8:
                    // ldmatrix reads hit 32 banks)
  int q_bytes;      // staged queries
  int s_bytes;      // the tile's scores
  int span_bytes;   // one ring stage: 128 rows of K bytes, plus the reads
                    // past their end of the last rows' words
};

template <int TU>
__host__ __device__ inline Geom8 geom8(int K) {
  Geom8 g;
  g.kp = (K + 31) / 32 * 32;
  g.qw = g.kp / 4 + 4;
  g.q_bytes = TU * g.qw * 4;
  g.s_bytes = TU * tc::kSStride * 4;
  g.span_bytes = (tc::kItems * K + g.kp + 16 + 15) / 16 * 16;
  return g;
}

template <int TU, int NST>
__host__ inline size_t smem_bytes(int K) {
  const Geom8 g = geom8<TU>(K);
  return (size_t)g.q_bytes + g.s_bytes + (size_t)NST * g.span_bytes;
}

// (m1 > m2) and (n1 > n2), distinct keys: m1, m2 become the best two
__device__ __forceinline__ void top2_merge(int& m1, int& m2, int n1, int n2) {
  m2 = max(max(m2, n2), min(m1, n1));
  m1 = max(m1, n1);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a 16-byte copy of which only the first `bytes` come from global memory,
// the rest zero-filled
__device__ __forceinline__ void cp_async16_tail(uint32_t dst, const void* src,
                                                int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

// rows row0 .. row0 + 127 of the table (fewer at the end) as one span
__device__ void stage_span(const int8_t* __restrict__ table, int K,
                           long long n_rows, long long row0, bool aligned,
                           unsigned char* st) {
  const long long left = n_rows - row0;
  const int bytes = (int)((left < tc::kItems ? left : tc::kItems) * K);
  const int8_t* src = table + row0 * K;
  if (aligned) {
    const uint32_t dst = (uint32_t)__cvta_generic_to_shared(st);
    for (int c = threadIdx.x; c * 16 < bytes; c += tc::kThreads) {
      const int n = bytes - c * 16;
      if (n >= 16) tc::cp_async16(dst + c * 16, src + c * 16);
      else cp_async16_tail(dst + c * 16, src + c * 16, n);
    }
  } else {
    for (int e = threadIdx.x; e < bytes; e += tc::kThreads)
      ((int8_t*)st)[e] = src[e];
  }
}

// queries of users u0 .. u0 + TU - 1 as [TU][qw] words, zero past B and K
template <int TU>
__device__ void stage_queries8(const int8_t* __restrict__ q, int B, int K,
                               int u0, const Geom8& g, unsigned char* qs) {
  for (int e = threadIdx.x; e < TU * g.kp; e += tc::kThreads) {
    const int ul = e / g.kp, k = e % g.kp, u = u0 + ul;
    qs[ul * g.qw * 4 + k] =
        (u < B && k < K) ? (unsigned char)q[(long long)u * K + k] : 0;
  }
}

// The B fragments (queries) of users 8n .. 8n + 7, k-step s, for KS =
// kp / 32 k-steps: loaded once a block, as the queries do not change from
// tile to tile.
template <int TU, int KS>
__device__ __forceinline__ void load_query_frags(
    const unsigned char* qs, const Geom8& g,
    uint32_t (&qb)[TU / 8][KS > 0 ? KS : 1][2]) {
  const int lane = threadIdx.x & 31;
  const uint32_t b_addr = (uint32_t)__cvta_generic_to_shared(qs) +
                          ((lane & 7) * g.qw + ((lane >> 3) & 1) * 4) * 4;
#pragma unroll
  for (int n = 0; n < TU / 8; ++n)
#pragma unroll
    for (int s = 0; s < KS; ++s)
      tc::ldsm_x2(b_addr + (n * 8 * g.qw + s * 8) * 4, qb[n][s][0],
                  qb[n][s][1]);
}

// The word at byte r*K + 4c of a span: the two aligned words around it
// shifted together.
__device__ __forceinline__ uint32_t span_word(const uint32_t* span, int o) {
  return __funnelshift_r(span[o >> 2], span[(o >> 2) + 1], (o & 3) * 8);
}

// acc[n][.] = the C fragments of this warp's 16 items x users 8n .. 8n+7.
// A fragment register j of lane (gr, t) holds row gr (+8 for odd j),
// bytes 4t .. 4t + 3 (+16 for j >= 2) of the k-step: in the span, the
// word at byte r*K + 32 s + 4t, aligned or not.  The B fragments come
// from registers (KS > 0) or from the staged queries.
template <int TU, int KS>
__device__ __forceinline__ void tile_product8(
    const unsigned char* st, const unsigned char* qs, const Geom8& g, int K,
    const uint32_t (&qb)[TU / 8][KS > 0 ? KS : 1][2],
    int (&acc)[TU / 8][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < TU / 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0;
  const uint32_t* span = (const uint32_t*)st;
  const int o0 = (warp * 16 + gr) * K + 4 * t, o1 = o0 + 8 * K;
  auto a_frag = [&](int kw, uint32_t (&a)[4]) {
    a[0] = span_word(span, o0 + 4 * kw);
    a[1] = span_word(span, o1 + 4 * kw);
    a[2] = span_word(span, o0 + 4 * kw + 16);
    a[3] = span_word(span, o1 + 4 * kw + 16);
  };
  if constexpr (KS > 0) {
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      uint32_t a[4];
      a_frag(s * 8, a);
#pragma unroll
      for (int n = 0; n < TU / 8; ++n)
        mma_s8(acc[n], a, qb[n][s][0], qb[n][s][1]);
    }
  } else {
    const int lr = lane & 7, lj = lane >> 3;
    const uint32_t b_addr = (uint32_t)__cvta_generic_to_shared(qs) +
                            (lr * g.qw + (lj & 1) * 4) * 4;
#pragma unroll 3
    for (int kw = 0; kw < g.kp / 4; kw += 8) {
      uint32_t a[4];
      a_frag(kw, a);
#pragma unroll
      for (int n = 0; n < TU / 8; ++n) {
        uint32_t b0, b1;
        tc::ldsm_x2(b_addr + (n * 8 * g.qw + kw) * 4, b0, b1);
        mma_s8(acc[n], a, b0, b1);
      }
    }
  }
}

template <int TU, int NST, int KS>
__global__ void __launch_bounds__(tc::kThreads, 2)
seg_topk_s8_kernel(const int8_t* __restrict__ q,
                   const int8_t* __restrict__ table, int B, int K,
                   int n_rows, int seg_width, int seg_top, int nseg,
                   int n_utiles, int ncand, int aligned,
                   unsigned long long* __restrict__ keys) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Geom8 g = geom8<TU>(K);
  unsigned char* qs = smem;
  int* S = (int*)(smem + g.q_bytes);
  unsigned char* ring = smem + g.q_bytes + g.s_bytes;

  const int tid = threadIdx.x;
  const int utile = blockIdx.x % n_utiles;
  const int walker = blockIdx.x / n_utiles;
  const int nwalk = gridDim.x / n_utiles;
  const int u0 = utile * TU;
  stage_queries8<TU>(q, B, K, u0, g, qs);

  const long long ntiles = ((long long)n_rows + tc::kItems - 1) / tc::kItems;
  const unsigned int nseg_total = (unsigned int)(n_rows / seg_width);
  const int shift = __ffs(seg_width) - 1;
  const int chunks = seg_width / 32;     // 32-item chunks of a segment
  // thread (user ul, 32-item chunk c): TU * 4 threads, whole warps
  const int ul = tid >> 2, c = tid & 3;
  const int key_base = seg_width - 1 - ((c * 32) & (seg_width - 1));
  auto load_tile = [&](long long i) {
    const long long tile = walker + i * nwalk;
    if (tile < ntiles)
      stage_span(table, K, n_rows, tile * tc::kItems, aligned,
                 ring + (i % NST) * g.span_bytes);
    tc::cp_async_commit();
  };
  for (int i = 0; i < NST - 1; ++i) load_tile(i);
  uint32_t qb[TU / 8][KS > 0 ? KS : 1][2];
  if constexpr (KS > 0) {
    __syncthreads();  // the staged queries
    load_query_frags<TU, KS>(qs, g, qb);
  }
  for (long long i = 0; walker + i * nwalk < ntiles; ++i) {
    // into the stage of tile i - 1, whose product ended before the
    // second barrier of its turn
    load_tile(i + NST - 1);
    tc::cp_async_wait<NST - 1>();
    __syncthreads();  // the span, and the first time the queries, visible
    int acc[TU / 8][4];
    tile_product8<TU, KS>(ring + (i % NST) * g.span_bytes, qs, g, K, qb,
                          acc);
    // the scores of rows past n_rows lie in segments past nseg_total and
    // are never read; S is free since the barrier ending the last turn
    {
      const int lane = tid & 31, warp = tid >> 5;
      const int gr = lane >> 2, t = lane & 3;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int slot = tc::score_slot(warp * 16 + gr + 8 * h);
#pragma unroll
        for (int n = 0; n < TU / 8; ++n)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            S[(n * 8 + 2 * t + j) * tc::kSStride + slot] = acc[n][2 * h + j];
      }
    }
    __syncthreads();
    if (ul < TU) {  // warp-uniform
      // the reference's packed key, less the chunk's constant offset:
      // acc * seg_width - i, larger for a larger acc, then a lower offset;
      // keys of one segment are distinct, so the second best is the
      // largest of the values each new key pushes out
      // two halves of the chunk as two independent chains, then merged
      const int* row = S + ul * tc::kSStride + tc::score_slot(c * 32);
      int m1 = INT_MIN, m2 = INT_MIN, n1 = INT_MIN, n2 = INT_MIN;
      if (seg_top == 1) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          m1 = max(m1, row[j] * seg_width - j);
          n1 = max(n1, row[j + 16] * seg_width - (j + 16));
        }
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int a = row[j] * seg_width - j;
          const int b = row[j + 16] * seg_width - (j + 16);
          m2 = max(m2, min(m1, a));
          m1 = max(m1, a);
          n2 = max(n2, min(n1, b));
          n1 = max(n1, b);
        }
      }
      top2_merge(m1, m2, n1, n2);
      m1 += key_base;
      m2 += key_base;
      for (int x = 1; x < chunks; x <<= 1)
        top2_merge(m1, m2, __shfl_xor_sync(0xffffffffu, m1, x),
                   __shfl_xor_sync(0xffffffffu, m2, x));
      const int u = u0 + ul;
      const unsigned int gseg =              // 4 / chunks segments a tile
          (unsigned int)((walker + i * nwalk) * (4 / chunks)) + c / chunks;
      if (c % chunks == 0 && u < B && gseg < nseg_total) {
        const unsigned int blk = gseg / (unsigned int)nseg;
        const unsigned int sib = gseg % (unsigned int)nseg;
        unsigned long long* out =
            keys + (long long)u * ncand + (long long)gseg * seg_top;
        for (int r = 0; r < seg_top; ++r) {
          const int m = r == 0 ? m1 : m2;
          const int v = m >> shift;                          // acc
          const unsigned int off =
              (unsigned int)(seg_width - 1 - (m & (seg_width - 1)));
          const unsigned int pos =
              ((blk * seg_top + r) * nseg + sib) * seg_width + off;
          out[r] = ((unsigned long long)((unsigned int)v ^ 0x80000000u)
                    << 32) | (unsigned int)(~pos);
        }
      }
    }
    // no barrier here: the next turn's first barrier orders these reads
    // of S before its writes, and the stage its copies refill was last
    // read by the product two barriers ago
  }
  tc::cp_async_wait<0>();
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
  const int n =
      ncf::select_top_keys<kMergeThreads, kMaxK, 8>(kb, ncand, k, sel);
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

template <int TU, int NST, int KS>
cudaError_t launch_tu(const int8_t* q, const int8_t* table, int B, int K,
                      int n_rows, int seg_width, int seg_top, int nseg,
                      int ncand, unsigned long long* keys,
                      cudaStream_t stream) {
  static const cudaError_t attr = tc::allow_max_smem(
      (const void*)seg_topk_s8_kernel<TU, NST, KS>);
  if (attr != cudaSuccess) return attr;
  const size_t smem = smem_bytes<TU, NST>(K);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, seg_topk_s8_kernel<TU, NST, KS>, tc::kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int n_utiles = (B + TU - 1) / TU;
  const long long ntiles = ((long long)n_rows + tc::kItems - 1) / tc::kItems;
  long long nwalk = (long long)per_sm * sms / n_utiles;
  if (nwalk > ntiles) nwalk = ntiles;
  if (nwalk < 1) nwalk = 1;
  const int aligned = (uintptr_t)table % 16 == 0;
  seg_topk_s8_kernel<TU, NST, KS>
      <<<(unsigned)(nwalk * n_utiles), tc::kThreads, smem, stream>>>(
          q, table, B, K, n_rows, seg_width, seg_top, nseg, n_utiles, ncand,
          aligned, keys);
  return cudaGetLastError();
}

cudaError_t launch_pass1(const int8_t* q, const int8_t* table, int B, int K,
                         int n_rows, int seg_width, int seg_top, int nseg,
                         int ncand, unsigned long long* keys,
                         cudaStream_t stream) {
  int optin = 0;
  const cudaError_t err = tc::smem_optin(&optin);
  if (err != cudaSuccess) return err;
  const int tu = tc::pick_user_tile(B, optin, [&](int t) {
    return t == 64 ? smem_bytes<64, 4>(K)
           : t == 32 ? smem_bytes<32, 4>(K)
           : t == 16 ? smem_bytes<16, 4>(K)
                     : smem_bytes<8, 4>(K);
  });
  const int ks = (K + 31) / 32;  // k-steps
#define NCF_LAUNCH(TU_, NST_, KS_)                                        \
  return launch_tu<TU_, NST_, KS_>(q, table, B, K, n_rows, seg_width,     \
                                   seg_top, nseg, ncand, keys, stream)
#define NCF_LAUNCH4(TU_)                     \
  switch (ks) {                               \
    case 1: NCF_LAUNCH(TU_, 4, 1);            \
    case 2: NCF_LAUNCH(TU_, 4, 2);            \
    case 3: NCF_LAUNCH(TU_, 4, 3);            \
    case kRegSteps: NCF_LAUNCH(TU_, 4, 4);    \
    default: NCF_LAUNCH(TU_, 4, 0);           \
  }
  switch (tu) {
    case 64: NCF_LAUNCH4(64);
    case 32: NCF_LAUNCH4(32);
    case 16: NCF_LAUNCH4(16);
    case 8: NCF_LAUNCH4(8);
    default:  // rows too wide for four stages: 8 users, two or one
      if (smem_bytes<8, 2>(K) <= (size_t)optin) NCF_LAUNCH(8, 2, 0);
      if (smem_bytes<8, 1>(K) > (size_t)optin) return cudaErrorInvalidValue;
      NCF_LAUNCH(8, 1, 0);
  }
#undef NCF_LAUNCH4
#undef NCF_LAUNCH
}

}  // namespace

extern "C" {

// q: [B, K] int8 quantized queries (weights 127, 127, 1 in the last three
// columns), K <= 1027; table: [n_rows, K] int8, n_rows = nblocks * nseg *
// seg_width; q_scale: one f32 on the device.  keys: [B, ncand] uint64
// scratch with ncand = n_rows / seg_width * seg_top.  Returns a
// cudaError_t (0 on success); errors during the run surface at the next
// synchronisation.
int ncf_topk_streaming_int8(const void* q, const void* table,
                            const float* q_scale, int B, int K, int n_rows,
                            int num_items, int seg_width, int seg_top,
                            int nseg, int nblocks, int k, void* keys,
                            float* out_vals, int* out_ids, void* stream) {
  if (B <= 0 || K <= 0 || K > kMaxKBytes || n_rows <= 0 || num_items <= 0 ||
      k <= 0 || k > kMaxK || (seg_top != 1 && seg_top != 2) || nseg <= 0 ||
      nblocks <= 0 ||
      (seg_width != 32 && seg_width != 64 && seg_width != 128) ||
      n_rows % seg_width != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int ncand = n_rows / seg_width * seg_top;
  unsigned long long* kp = (unsigned long long*)keys;
  cudaError_t err = launch_pass1((const int8_t*)q, (const int8_t*)table, B,
                                 K, n_rows, seg_width, seg_top, nseg, ncand,
                                 kp, s);
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
