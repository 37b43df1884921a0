// Embedding row gather for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ncf_tpu/ops/pallas_embedding.py::
// pallas_embedding_lookup (_pallas_gather, pallas_embedding.py:115; body
// _gather_kernel :47; pallas_call :133): out[r] = table[ids[r]], a copy
// of the row's bytes (bit-identical to table[ids]).  A negative id counts
// from the end, as in PyTorch indexing.  Every id must lie in [-N, N): the
// kernel does not check (the callers' ids always do).  Rows are a multiple
// of 4 bytes, as in the reference (_pack_128_lanes rejects any other).
//
// What bounds it on this card: bytes.  Each output row is read once and
// written once (NeuMF serving, 237k ids of 256-byte rows: 61 MB of output,
// 18 us at 3.35 TB/s; the table is 0.95 MB and stays in L2).
//
// Design: the TPU kernel issues one row DMA per id from its scalar core.
// Here one warp copies one row at a time (grid-stride over the ids), with
// 16-byte vector loads and stores where the row size and both base
// pointers allow, else 4-byte words.  Rows are independent, so
// there is nothing to order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename W>
__device__ __forceinline__ void copy_row(const char* __restrict__ src,
                                         char* __restrict__ dst, int words,
                                         int lane) {
  const W* s = (const W*)src;
  W* d = (W*)dst;
  for (int i = lane; i < words; i += 32) d[i] = s[i];
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const char* __restrict__ table, const void* __restrict__ ids,
              int ids64, long long n, int row_bytes, long long num_rows,
              char* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (kThreads / 32);
  const int words = row_bytes / (int)sizeof(W);
  for (long long r = (long long)blockIdx.x * (kThreads / 32) +
                     (threadIdx.x >> 5);
       r < n; r += warps) {
    long long id = ids64 ? ((const long long*)ids)[r] : ((const int*)ids)[r];
    if (id < 0) id += num_rows;
    copy_row<W>(table + id * row_bytes, out + r * row_bytes, words, lane);
  }
}

}  // namespace

extern "C" {

// table: [num_rows, row_bytes / element size]; ids: n int32 (ids64 = 0) or
// int64 (ids64 = 1); out: [n, row] in the table's type.  row_bytes and
// both pointers are multiples of 4.  Returns a cudaError_t (0 on success).
int ncf_gather(const void* table, const void* ids, int ids64, long long n,
               int row_bytes, long long num_rows, void* out, void* stream) {
  const uintptr_t align = (uintptr_t)table | (uintptr_t)out;
  if (n < 0 || row_bytes <= 0 || row_bytes % 4 != 0 || align % 4 != 0 ||
      num_rows <= 0 || (ids64 != 0 && ids64 != 1))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  long long blocks = (n + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 132 * 16) blocks = 132 * 16;
  const char* t = (const char*)table;
  char* o = (char*)out;
  if (row_bytes % 16 == 0 && align % 16 == 0)
    gather_kernel<int4><<<(unsigned)blocks, kThreads, 0, s>>>(
        t, ids, ids64, n, row_bytes, num_rows, o);
  else
    gather_kernel<int><<<(unsigned)blocks, kThreads, 0, s>>>(
        t, ids, ids64, n, row_bytes, num_rows, o);
  return (int)cudaGetLastError();
}

const char* ncf_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
