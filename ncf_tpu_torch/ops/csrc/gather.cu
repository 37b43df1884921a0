// Embedding row gather for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ncf_tpu/ops/pallas_embedding.py::
// pallas_embedding_lookup (_pallas_gather, pallas_embedding.py:115; body
// _gather_kernel :47; pallas_call :133): out[r] = table[ids[r]], a copy
// of the row's bytes (bit-identical to table[ids]).  A negative id counts
// from the end, as in PyTorch indexing.  Every id must lie in [-N, N): the
// kernel does not check (the callers' ids always do).  Rows are a multiple
// of 4 bytes, as in the reference (_pack_128_lanes rejects any other).
// Offsets are 64-bit: the [12M, 128] f32 user table puts id * row_bytes
// past 2^31.
//
// What bounds it on this card: bytes.  Each id is read once and each
// output row written once (NeuMF serving, 237,184 ids of 256-byte rows:
// 61 MB of output, 18.7 us at 3.35 TB/s); the table (0.95 MB there) stays
// in L2, so the row reads are L2 hits and the output's writes to device
// memory set the pace.
//
// Design.  The TPU kernel keeps 32 row DMAs in flight from its scalar
// core.  Here:
//  - A group of T threads copies one row, T the row's vector words
//    rounded up to a power of two and capped at 32, so a warp moves 32 / T
//    rows at once (2 rows of 256 bytes, 4 of 128, 8 of 64); a row longer
//    than 32 words loops within its group.  A thread moves 16-byte words
//    where the row size and both base pointers allow, else 8, else 4.
//  - A warp takes 32 ids at a time with one coalesced load (lane i holds
//    id i) and hands each group its row's id with __shfl_sync; the next
//    32 ids are loaded before the current ones are copied.
//  - Each thread issues kInFlight independent loads before its stores,
//    so a warp keeps up to 2 KB of reads in flight (4 blocks of 8 warps
//    an SM at least: 64 KB an SM, beyond the ~25 KB that 3.35 TB/s at
//    ~1 us of latency asks for).  For a chunk the warp's
//    store instruction writes 32 / T consecutive rows: full 512-byte runs.
//  - The grid is what the card holds resident (the wrapper's plan, SMs
//    times kMinBlocks) at most, and the warps walk the id chunks with a
//    grid stride.
//  - The launch plan (word width, T, grid) comes from ops/gather.py::
//    launch_plan, where the CPU tests check it.
//  - Stores are __stcs (evict-first: the output, 61 MB at NeuMF's scan,
//    more than L2's 50 MB, is not kept there in favour of the table).
//    Against plain stores at that shape on an H100 80GB HBM3 (700 W),
//    chip_smoke.py's device times, four runs of two pairs each, ms
//    evict-first / plain: 0.0222 / 0.0227, 0.0218 / 0.0226, 0.0224 /
//    0.0225, 0.0222 / 0.0224, 0.0208 / 0.0210, 0.0205 / 0.0210, 0.02238 /
//    0.02242, 0.0218 / 0.0226: evict-first faster by 0.2-3.6% in all
//    eight, so it is the only store the kernel has.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // ops/gather.py THREADS
constexpr int kMinBlocks = 4;   // ops/gather.py BLOCKS_PER_SM
constexpr int kInFlight = 4;    // loads a thread keeps in flight

__device__ __forceinline__ long long load_id(const void* ids, int ids64,
                                             long long i, long long n,
                                             long long num_rows) {
  if (i >= n) return 0;
  long long id = ids64 ? __ldg((const long long*)ids + i)
                       : (long long)__ldg((const int*)ids + i);
  return id < 0 ? id + num_rows : id;
}

// table, out: rows of row_words words of type W.  T = 1 << tlog threads a
// row; a warp's 32 rows of a chunk: group g = lane >> tlog takes local
// rows g + G * j (G = 32 >> tlog groups, j < T), thread t = lane & (T - 1)
// takes words t + T * m (m < iters).  Items q = m * T + j, kInFlight at a
// time.
template <typename W>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
gather_kernel(const W* __restrict__ table, const void* __restrict__ ids,
              int ids64, long long n, int row_words, long long num_rows,
              int tlog, W* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int T = 1 << tlog;
  const int G = 32 >> tlog;
  const int g = lane >> tlog;
  const int t = lane & (T - 1);
  const int iters = (row_words + T - 1) >> tlog;
  const int items = T * iters;
  const long long stride = (long long)gridDim.x * (kThreads / 32);
  long long chunk = (long long)blockIdx.x * (kThreads / 32) +
                    (threadIdx.x >> 5);
  long long my = load_id(ids, ids64, chunk * 32 + lane, n, num_rows);
  for (; chunk * 32 < n; chunk += stride) {
    const long long base = chunk * 32;
    const long long nxt =
        load_id(ids, ids64, (chunk + stride) * 32 + lane, n, num_rows);
    const long long here = n - base;            // rows of this chunk, >= 1
    for (int q0 = 0; q0 < items; q0 += kInFlight) {
      W v[kInFlight];
      unsigned ok = 0;                          // items loaded, a bit each
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int q = q0 + u;
        const int r = g + G * (q & (T - 1));    // the chunk's row
        const int k = t + T * (q >> tlog);      // the row's word
        const long long id = __shfl_sync(0xffffffffu, my, r);
        if (q < items && r < here && k < row_words) {
          v[u] = __ldg(table + id * row_words + k);
          ok |= 1u << u;
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int q = q0 + u;
        const int r = g + G * (q & (T - 1));
        const int k = t + T * (q >> tlog);
        if (ok >> u & 1u) __stcs(out + (base + r) * row_words + k, v[u]);
      }
    }
    my = nxt;
  }
}

template <typename W>
int launch(const void* table, const void* ids, int ids64, long long n,
           int row_bytes, long long num_rows, int tlog, int grid, void* out,
           cudaStream_t s) {
  gather_kernel<W><<<grid, kThreads, 0, s>>>(
      (const W*)table, ids, ids64, n, row_bytes / (int)sizeof(W), num_rows,
      tlog, (W*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// table: [num_rows, row_bytes / element size]; ids: n int32 (ids64 = 0) or
// int64 (ids64 = 1); out: [n, row] in the table's type.  The plan: width
// (4, 8 or 16 bytes a word; it divides row_bytes and both pointers), tlog
// (log2 of the threads a row, 0..5), grid (blocks).
// Returns a cudaError_t (0 on success).
int ncf_gather(const void* table, const void* ids, int ids64, long long n,
               int row_bytes, long long num_rows, int width, int tlog,
               int grid, void* out, void* stream) {
  const uintptr_t align = (uintptr_t)table | (uintptr_t)out;
  if (n < 0 || row_bytes <= 0 || num_rows <= 0 ||
      (ids64 != 0 && ids64 != 1) || (width != 4 && width != 8 &&
                                     width != 16) ||
      row_bytes % width != 0 || align % width != 0 || tlog < 0 ||
      tlog > 5 || grid <= 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (width == 16)
    return launch<int4>(table, ids, ids64, n, row_bytes, num_rows, tlog,
                        grid, out, s);
  if (width == 8)
    return launch<int2>(table, ids, ids64, n, row_bytes, num_rows, tlog,
                        grid, out, s);
  return launch<int>(table, ids, ids64, n, row_bytes, num_rows, tlog, grid,
                     out, s);
}

const char* ncf_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
