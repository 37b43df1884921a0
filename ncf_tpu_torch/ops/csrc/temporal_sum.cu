// Fused temporal lookup-sum for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// ncf_tpu/ops/pallas_temporal.py::fused_lookup_sum (body _make_kernel,
// pallas_temporal.py:40; pallas_call in _fused_lookup_sum_t at :77).
//
// Function computed: out[b, d] = ((t0[ids[0, b], d] + t1[ids[1, b], d])
//   + t2[ids[2, b], d]) + t3[ids[3, b], d], summed in f32 in that order, for
// K <= 4 tables of one width dt (hour[24], day[7], month[12] and the
// sinusoid pe[365] on the training path); an id outside [0, rows_k)
// contributes 0.  The result is [B, dt] directly: the TPU's transposed
// [dt, B] output was a lane-layout artefact.  With the same order of adds
// the result is bit-identical to the plain PyTorch sum of gathers.
//
// What bounds it on this card: the bytes.  At the training step's shape
// (B = 16,384, dt = 32) it reads 262 KB of ids and 52 KB of tables and
// writes 2.1 MB, about 0.7 us at 3.35 TB/s; the output is nearly all of it,
// and a launch costs about as much again.
//
// Design: each thread owns one 16-byte quarter (a float4) of one example's
// row, so dt/4 threads serve an example (8 at dt = 32: four examples fill a
// warp, whose loads of a table row and whose store each cover 512
// contiguous bytes).  A block of 256 threads serves E = 256 / (dt/4)
// examples; it first stages their K x E ids in shared memory, one
// coalesced load of E ids per table (2,048 warp loads at the step's shape
// instead of one broadcast load per example and table), so every id load
// is in flight before the first table load.  Tables are read as float4
// through the read-only cache, where their 52 KB stay resident.  A width
// that is not a multiple of 4, or a table or output not 16-byte aligned,
// takes the same kernel with one float a thread.  A row wider than 1,024
// floats has its quarters walked by the block's 256 threads.  The grid is
// one block per E examples (512 blocks at the step's shape): a grid of
// two blocks an SM striding over the groups measured slower on the H100
// (PERF.md, B3's row).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTables = 4;

struct Tables {
  const float* t[kMaxTables];
  int rows[kMaxTables];
};

__device__ __forceinline__ float vadd(float a, float b) { return a + b; }
__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ void vzero(float& v) { v = 0.f; }
__device__ __forceinline__ void vzero(float4& v) {
  v = make_float4(0.f, 0.f, 0.f, 0.f);
}

// T is float4 (V = 4 floats a thread) or float (V = 1); q = dt / V pieces
// a row, qt = min(q, kThreads) threads an example, E = kThreads / qt
// examples a block; thread t of block g serves example g * E + t / qt,
// pieces t % qt, t % qt + qt, ...
template <typename T>
__global__ void __launch_bounds__(kThreads)
temporal_sum_kernel(const int* __restrict__ ids, Tables tabs, int K, int B,
                    int q, int qt, int E, float* __restrict__ out) {
  __shared__ int sid[kMaxTables][kThreads];
  const int tid = threadIdx.x;
  const int el = tid / qt;
  const int c0 = tid - el * qt;
  const int e0 = blockIdx.x * E;
  const int n = min(E, B - e0);
  for (int j = tid; j < K * E; j += kThreads) {
    const int k = j / E;
    const int i = j - k * E;
    if (i < n) sid[k][i] = __ldg(ids + (long long)k * B + e0 + i);
  }
  __syncthreads();
  if (el >= n) return;
  // unrolled, so that constant indices keep the struct in registers
  const T* row[kMaxTables];
#pragma unroll
  for (int k = 0; k < kMaxTables; ++k) {
    const int id = k < K ? sid[k][el] : -1;
    row[k] = (id >= 0 && id < tabs.rows[k])
                 ? reinterpret_cast<const T*>(tabs.t[k]) + (long long)id * q
                 : nullptr;
  }
  T* dst = reinterpret_cast<T*>(out) + (long long)(e0 + el) * q;
  for (int c = c0; c < q; c += qt) {
    T acc;
#pragma unroll
    for (int k = 0; k < kMaxTables; ++k) {
      if (k >= K) break;
      T v;
      if (row[k] != nullptr)
        v = __ldg(row[k] + c);
      else
        vzero(v);
      acc = k == 0 ? v : vadd(acc, v);
    }
    dst[c] = acc;
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" {

// ids: int32 [K, B]; t0..t3: f32 [rows_k, dt] (unused ones null with rows
// 0); out: f32 [B, dt].  Returns a cudaError_t (0 on success); errors
// during the run surface at the caller's next synchronisation.
int ncf_temporal_sum(const int* ids, int K, int B, int dt, const float* t0,
                     int rows0, const float* t1, int rows1, const float* t2,
                     int rows2, const float* t3, int rows3, float* out,
                     void* stream) {
  if (K <= 0 || K > kMaxTables || B < 0 || dt <= 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Tables tabs = {{t0, t1, t2, t3}, {rows0, rows1, rows2, rows3}};
  bool vec = dt % 4 == 0 && aligned16(out);
  for (int k = 0; k < K; ++k) {
    if (tabs.t[k] == nullptr || tabs.rows[k] <= 0)
      return (int)cudaErrorInvalidValue;
    vec = vec && aligned16(tabs.t[k]);
  }
  const int q = vec ? dt / 4 : dt;
  const int qt = q < kThreads ? q : kThreads;
  const int E = kThreads / qt;
  const int blocks = (B + E - 1) / E;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    temporal_sum_kernel<float4><<<blocks, kThreads, 0, s>>>(
        ids, tabs, K, B, q, qt, E, out);
  else
    temporal_sum_kernel<float><<<blocks, kThreads, 0, s>>>(
        ids, tabs, K, B, q, qt, E, out);
  return (int)cudaGetLastError();
}

const char* ncf_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
