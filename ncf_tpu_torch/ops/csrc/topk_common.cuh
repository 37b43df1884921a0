// Device code shared by the port's top-k kernels (B5 topk_streaming.cu,
// B6 topk_streaming_int8.cu, B8 topk_exact.cu, B9 topk_segmax.cu):
//
//   tc::            the tensor-core tile of B5, B8 and B9: 128 items x TU
//                   users with mma.sync (split-TF32 for f32 tables, bf16
//                   for bf16), the table streamed through a cp.async ring;
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

#include <type_traits>

namespace ncf {

constexpr float kNegInf = -3.0e38f;

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

// The min(k, nonzero count) largest nonzero keys of kb[0, ncand) into
// sel[] (unordered); returns that count.  MSB-first radix select with
// 8-bit digits, stopping as soon as the boundary bin is taken whole; keys
// are unique, so the boundary bin always ends with one key.  Each thread
// keeps ILP loads in flight.  Every thread of the NT-thread block calls
// it; it synchronises the block.
template <int NT, int MAXK, int ILP = 1>
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
    for (int base = 0; base < ncand; base += NT * ILP) {
      unsigned long long keys[ILP];
#pragma unroll
      for (int j = 0; j < ILP; ++j) {
        const int i = base + j * NT + tid;
        keys[j] = i < ncand ? kb[i] : 0ull;
      }
#pragma unroll
      for (int j = 0; j < ILP; ++j) {
        const unsigned long long key = keys[j];
        int digit = 256;  // no bin
        if (key != 0ull && (key & mask) == prefix)
          digit = (int)((key >> shift) & 0xFFull);
        unsigned int peers = __match_any_sync(0xffffffffu, digit);
        if (digit < 256 && lane == __ffs(peers) - 1)
          atomicAdd(&hist[digit], (unsigned int)__popc(peers));
      }
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
  for (int base = 0; base < ncand; base += NT * ILP) {
    unsigned long long keys[ILP];
#pragma unroll
    for (int j = 0; j < ILP; ++j) {
      const int i = base + j * NT + tid;
      keys[j] = i < ncand ? kb[i] : 0ull;
    }
#pragma unroll
    for (int j = 0; j < ILP; ++j) {
      const unsigned long long key = keys[j];
      if (key != 0ull && (key & mask) >= prefix) {
        int slot = atomicAdd(&s_count, 1);
        if (slot < MAXK) sel[slot] = key;
      }
    }
  }
  __syncthreads();
  return s_count < k ? s_count : k;
}

// ----------------------------------------------------------------------
// Tensor-core scoring of B5, B8 and B9.
//
// score[item, user] = sum_d T[item, d] q[user, d] for a tile of 128 items
// (the M side: 16 rows a warp, 8 warps) x TU users (the N side: TU / 8
// slices of 8 columns) with mma.sync, so a request of B <= 8 users fills
// one N slice.  Operands by table type:
//   f32 table, f32 queries: split-TF32.  x = hi + lo with hi =
//     tf32_rna(x) and lo = tf32_rna(x - hi) (the subtraction is exact);
//     lo.hi + hi.lo + hi.hi accumulate in f32 (m16n8k8 tf32).  The dropped
//     lo.lo and lo's own rounding leave about 2^-21 of |q_d T_d| per
//     product, far inside the callers' 1e-5 sum|q.v| + 1e-6; one TF32
//     product (5e-4) would not be.  Small integers split with lo = 0 and
//     stay exact, so ties stay ties.
//   bf16 table, f32 queries (B8, B9): a bf16 value is exact in TF32, so two
//     products, lo.t + hi.t.
//   bf16 table, bf16 queries (B5 casts them): one m16n8k16 bf16 product
//     with f32 accumulation; the products are exact.
// D is zero-padded to the instruction depth in shared memory.  Every
// (item, user) score runs the same k-loop of instructions whatever TU and
// the user's column, so a user's scores do not depend on the batch.
//
// The table streams through a ring of two stages: while one 128-row tile
// is scored, cp.async copies the next (16-byte copies where rows and
// pointer allow, else 4-byte, else element copies for bf16 rows of odd
// length).  A block keeps one tile of users and walks the item tiles
// walker, walker + nwalk, ...; the tile's 128 biases come with it.  B9's
// epilogue reads the C fragments in registers (stream_fragments); B5's
// and B8's read the tile's scores [TU][kSStride] (skewed, score_slot),
// which overwrite the stage just read after the product (stream_tiles).
namespace tc {

constexpr int kItems = 128;     // items per tile
constexpr int kThreads = 256;   // 8 warps, 16 items each
constexpr int kStages = 2;      // ring depth
constexpr int kSStride = 132;   // floats per score row (128 + 4 skew)
constexpr int kMaxD = 128;      // widest row the callers accept

enum CopyMode { kCopy16 = 0, kCopy4 = 1, kCopyElem = 2 };

// staged geometry; rows are a multiple of 4 words plus 4 (== 4 mod 8), so
// the fragment loads of 8 rows x 4 words fall in 32 distinct banks
struct Geom {
  int kp;           // D padded to the product depth (8 f32, 16 bf16 tables)
  int sw;           // 32-bit words per staged table row
  int qw;           // 32-bit words per staged query row (one plane)
  int q_bytes;      // staged queries: hi and lo planes for f32 queries
  int bias_off;     // the tile's 128 biases within a stage, after the
                    // table rows or the scores, whichever is larger
  int stage_bytes;  // one ring stage
};

template <typename TQ, typename TT, int TU>
__host__ __device__ inline Geom geom(int D) {
  Geom g;
  const bool t16 = sizeof(TT) == 2, q16 = sizeof(TQ) == 2;
  g.kp = t16 ? (D + 15) / 16 * 16 : (D + 7) / 8 * 8;
  g.sw = (t16 ? g.kp / 2 : g.kp) + 4;
  g.qw = (q16 ? g.kp / 2 : g.kp) + 4;
  g.q_bytes = (q16 ? 1 : 2) * TU * g.qw * 4;
  const int tile = kItems * g.sw * 4, scores = TU * kSStride * 4;
  g.bias_off = tile > scores ? tile : scores;
  g.stage_bytes = g.bias_off + kItems * 4;
  return g;
}

template <typename TQ, typename TT, int TU>
__host__ inline size_t ring_smem_bytes(int D) {
  const Geom g = geom<TQ, TT, TU>(D);
  return (size_t)g.q_bytes + (size_t)kStages * g.stage_bytes;
}

__host__ inline int copy_mode(const void* table, int D, int esz) {
  const uintptr_t p = (uintptr_t)table;
  const int row = D * esz;
  if (row % 16 == 0 && p % 16 == 0) return kCopy16;
  if (row % 4 == 0 && p % 4 == 0) return kCopy4;
  return kCopyElem;
}

// the most dynamic shared memory a block may take on the current device
__host__ inline cudaError_t smem_optin(int* optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
  return err;
}

// let `kernel` take that much, with the whole carve-out for shared
// memory; called once per kernel
__host__ inline cudaError_t allow_max_smem(const void* kernel) {
  int optin = 0;
  cudaError_t err = smem_optin(&optin);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  return err;
}

// the user tile: the smallest of 8, 16, 32, 64 that covers B (64 above),
// halved while the shared memory need(tile) does not fit in a block; 0
// when not even 8 users fit
template <typename Need>
__host__ inline int pick_user_tile(int B, int optin, Need need) {
  int tu = B > 32 ? 64 : B > 16 ? 32 : B > 8 ? 16 : 8;
  while (tu > 8 && need(tu) > (size_t)optin) tu /= 2;
  return need(tu) > (size_t)optin ? 0 : tu;
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 matrices of 16-bit pairs, one 32-bit word a lane: lane l
// gives the address of row l % 8 of matrix l / 8 and receives word l % 4
// of row l / 4 of each matrix, the layout of the mma fragments
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(addr) : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

template <typename T>
__device__ __forceinline__ T zero_of() {
  if constexpr (sizeof(T) == 2) return __float2bfloat16(0.f);
  else return 0.f;
}

// queries of users u0 .. u0 + TU - 1 (zero past B and past D): f32
// queries as their TF32 hi and lo planes, bf16 queries as they are
template <typename TQ, int TU>
__device__ void stage_queries(const TQ* __restrict__ q, int B, int D, int u0,
                              const Geom& g, unsigned char* qs) {
  for (int e = threadIdx.x; e < TU * g.kp; e += kThreads) {
    const int ul = e / g.kp, d = e % g.kp, u = u0 + ul;
    const bool real = u < B && d < D;
    if constexpr (sizeof(TQ) == 4) {
      uint32_t hi, lo;
      split_tf32(real ? q[(long long)u * D + d] : 0.f, hi, lo);
      uint32_t* plane = (uint32_t*)qs;
      plane[ul * g.qw + d] = hi;
      plane[(TU + ul) * g.qw + d] = lo;
    } else {
      ((TQ*)qs)[ul * 2 * g.qw + d] =
          real ? q[(long long)u * D + d] : zero_of<TQ>();
    }
  }
}

// rows row0 .. row0 + 127 of the table (and of the bias, if any) into a
// stage (rows past n_rows are left as they are: their scores are replaced
// by the pad); the padding columns D .. kp - 1 are zeroed every time, as
// the previous tile's scores may lie there
template <typename TT>
__device__ void stage_tile(const TT* __restrict__ table,
                           const float* __restrict__ bias, int D,
                           long long n_rows, long long row0, const Geom& g,
                           int mode, unsigned char* st) {
  const int tid = threadIdx.x;
  const long long left = n_rows - row0;
  const int rows = left < kItems ? (int)left : kItems;
  if (bias && tid < rows)
    cp_async4((uint32_t)__cvta_generic_to_shared(st + g.bias_off) + tid * 4,
              bias + row0 + tid);
  const int row_bytes = D * (int)sizeof(TT);
  const char* src = (const char*)(table + row0 * D);
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(st);
  // thread tid copies pieces tid, tid + kThreads, ... of per pieces a
  // row; (row, piece) advance without a division per piece
  const int piece =
      mode == kCopy16 ? 16 : mode == kCopy4 ? 4 : (int)sizeof(TT);
  const int per = row_bytes / piece;
  const int dr = kThreads / per, dc = kThreads % per;
  int r = tid / per, c = tid % per;
  while (r < rows) {
    const uint32_t to = dst + r * g.sw * 4 + c * piece;
    const char* from = src + (long long)r * row_bytes + c * piece;
    if (mode == kCopy16) cp_async16(to, from);
    else if (mode == kCopy4) cp_async4(to, from);
    else ((TT*)(st + r * g.sw * 4))[c] = ((const TT*)from)[0];
    c += dc;
    r += dr;
    if (c >= per) {
      c -= per;
      ++r;
    }
  }
  const int pad = g.kp - D;
  for (int e = tid; e < kItems * pad; e += kThreads) {
    const int r = e / pad, c = D + e % pad;
    ((TT*)(st + r * g.sw * 4))[c] = zero_of<TT>();
  }
}

// acc[n][.] = the C fragments of this warp's 16 items x users 8n .. 8n + 7.
// Fragments of 32-bit words come by ldmatrix (rows 16-byte aligned):
// matrix lane / 8 of the A fragment is rows +8 for odd lanes / 8 and
// words +4 from lane 16; of the B fragment words +4 for odd lanes / 8 and
// the lo plane from lane 16.
template <typename TQ, typename TT, int TU>
__device__ __forceinline__ void tile_product(const unsigned char* st,
                                             const unsigned char* qs,
                                             const Geom& g,
                                             float (&acc)[TU / 8][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lr = lane & 7, lj = lane >> 3;
#pragma unroll
  for (int n = 0; n < TU / 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;
  const uint32_t st_s = (uint32_t)__cvta_generic_to_shared(st);
  const uint32_t qs_s = (uint32_t)__cvta_generic_to_shared(qs);
  const uint32_t b_addr =
      qs_s + ((lr + (lj >> 1) * TU) * g.qw + (lj & 1) * 4) * 4;
  if constexpr (std::is_same<TT, float>::value) {
    const uint32_t a_addr =
        st_s + ((warp * 16 + lr + (lj & 1) * 8) * g.sw + (lj >> 1) * 4) * 4;
#pragma unroll 4
    for (int k0 = 0; k0 < g.kp; k0 += 8) {
      uint32_t a[4], ah[4], al[4];
      ldsm_x4(a_addr + k0 * 4, a[0], a[1], a[2], a[3]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        split_tf32(__uint_as_float(a[j]), ah[j], al[j]);
#pragma unroll
      for (int n = 0; n < TU / 8; ++n) {
        uint32_t bh0, bh1, bl0, bl1;
        ldsm_x4(b_addr + (n * 8 * g.qw + k0) * 4, bh0, bh1, bl0, bl1);
        mma_tf32(acc[n], al, bh0, bh1);
        mma_tf32(acc[n], ah, bl0, bl1);
        mma_tf32(acc[n], ah, bh0, bh1);
      }
    }
  } else if constexpr (std::is_same<TQ, float>::value) {
    const int gr = lane >> 2, t = lane & 3;
    const __nv_bfloat16* A =
        (const __nv_bfloat16*)st + (warp * 16 + gr) * 2 * g.sw + t;
    const int r8 = 16 * g.sw;
    for (int k0 = 0; k0 < g.kp; k0 += 8) {
      uint32_t a[4];
      a[0] = __float_as_uint(__bfloat162float(A[k0]));
      a[1] = __float_as_uint(__bfloat162float(A[k0 + r8]));
      a[2] = __float_as_uint(__bfloat162float(A[k0 + 4]));
      a[3] = __float_as_uint(__bfloat162float(A[k0 + r8 + 4]));
#pragma unroll
      for (int n = 0; n < TU / 8; ++n) {
        uint32_t bh0, bh1, bl0, bl1;
        ldsm_x4(b_addr + (n * 8 * g.qw + k0) * 4, bh0, bh1, bl0, bl1);
        mma_tf32(acc[n], a, bl0, bl1);
        mma_tf32(acc[n], a, bh0, bh1);
      }
    }
  } else {
    const uint32_t a_addr =
        st_s + ((warp * 16 + lr + (lj & 1) * 8) * g.sw + (lj >> 1) * 4) * 4;
#pragma unroll 4
    for (int kw = 0; kw < g.kp / 2; kw += 8) {
      uint32_t a[4];
      ldsm_x4(a_addr + kw * 4, a[0], a[1], a[2], a[3]);
#pragma unroll
      for (int n = 0; n < TU / 8; ++n) {
        uint32_t b0, b1;
        ldsm_x2(b_addr + (n * 8 * g.qw + kw) * 4, b0, b1);
        mma_bf16(acc[n], a, b0, b1);
      }
    }
  }
}

// Item il of a score row sits at il + il / 32: one float of skew after
// every 32, so the C-fragment stores and the epilogues' reads of 32
// consecutive items by (user, chunk) threads each hit 32 banks.
__device__ __forceinline__ int score_slot(int il) { return il + (il >> 5); }

// S[user][score_slot(item)] = acc (+ the staged bias) for rows < n_rows,
// else pad
template <int TU>
__device__ __forceinline__ void store_scores(const float (&acc)[TU / 8][4],
                                             const float* sbias,
                                             long long n_rows, long long row0,
                                             float pad, float* S) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int il = warp * 16 + gr + 8 * h;
    const long long row = row0 + il;
    const bool real = row < n_rows;
    const float b = (real && sbias) ? sbias[il] : 0.f;
#pragma unroll
    for (int n = 0; n < TU / 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        S[(n * 8 + 2 * t + j) * kSStride + score_slot(il)] =
            real ? acc[n][2 * h + j] + b : pad;
  }
}

// Walk this block's item tiles (walker, walker + nwalk, ...) of the
// walk_rows >= n_rows rows through the ring and call epi(acc, st, row0)
// with each tile's C fragments (tile_product's layout); the stage st
// still holds the tile's rows and biases during the call, and rows past
// n_rows hold no table row.  Every thread makes the call, so epi may
// synchronise the block.  The queries must be staged and visible (a
// barrier) before the call.
template <typename TQ, typename TT, int TU, typename Epi>
__device__ void stream_fragments(const TT* __restrict__ table,
                                 const float* __restrict__ bias, int D,
                                 long long n_rows, long long walk_rows,
                                 int walker, int nwalk, int mode,
                                 const Geom& g, const unsigned char* qs,
                                 unsigned char* ring, Epi&& epi) {
  const long long ntiles = (walk_rows + kItems - 1) / kItems;
  auto load_tile = [&](long long i) {
    const long long tile = walker + i * nwalk;
    if (tile < ntiles)
      stage_tile(table, bias, D, n_rows, tile * kItems, g, mode,
                 ring + (i % kStages) * g.stage_bytes);
    cp_async_commit();
  };
  for (int i = 0; i < kStages - 1; ++i) load_tile(i);
  for (long long i = 0; walker + i * nwalk < ntiles; ++i) {
    // into the stage of tile i - 1, free since the barrier ending its turn
    load_tile(i + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    unsigned char* st = ring + (i % kStages) * g.stage_bytes;
    float acc[TU / 8][4];
    tile_product<TQ, TT, TU>(st, qs, g, acc);
    epi(acc, st, (walker + i * nwalk) * kItems);
    __syncthreads();
  }
  cp_async_wait<0>();
}

// stream_fragments with the tile's scores written to shared memory first:
// epi(S, row0) reads them at S[user * kSStride + score_slot(item)], the
// rows past n_rows holding `pad`
template <typename TQ, typename TT, int TU, typename Epi>
__device__ void stream_tiles(const TT* __restrict__ table,
                             const float* __restrict__ bias, int D,
                             long long n_rows, int walker, int nwalk,
                             int mode, float pad, const Geom& g,
                             const unsigned char* qs, unsigned char* ring,
                             Epi&& epi) {
  stream_fragments<TQ, TT, TU>(
      table, bias, D, n_rows, n_rows, walker, nwalk, mode, g, qs, ring,
      [&](const float (&acc)[TU / 8][4], unsigned char* st, long long row0) {
        __syncthreads();  // every warp has read the stage
        float* S = (float*)st;
        store_scores<TU>(acc,
                         bias ? (const float*)(st + g.bias_off) : nullptr,
                         n_rows, row0, pad, S);
        __syncthreads();
        epi((const float*)S, row0);
      });
}

}  // namespace tc

}  // namespace ncf
