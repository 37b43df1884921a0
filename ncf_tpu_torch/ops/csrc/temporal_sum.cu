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
// writes 2.1 MB, about 0.7 us at 3.35 TB/s; launch latency dominates.
//
// Design: a block is 8 rows x 32 lanes; each row of threads loads its
// example's K ids once (one broadcast read per warp) and walks d across
// the lanes, so a warp reads each looked-up table row with consecutive
// lanes and writes one coalesced output row; no thread divides.  The
// tables (52 KB in all) are read through the read-only cache, where they
// stay resident; the TPU's one-hot matmuls existed only to feed its matrix
// unit.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;  // threads along dt
constexpr int kRows = 8;    // examples per block
constexpr int kMaxTables = 4;

struct Tables {
  const float* t[kMaxTables];
  int rows[kMaxTables];
};

__global__ void __launch_bounds__(kLanes * kRows)
temporal_sum_kernel(const int* __restrict__ ids, Tables tabs, int K, int B,
                    int dt, float* __restrict__ out) {
  const int b = blockIdx.x * kRows + threadIdx.y;
  if (b >= B) return;
  // unrolled, so that constant indices keep the struct out of local memory
  const float* row[kMaxTables];
#pragma unroll
  for (int k = 0; k < kMaxTables; ++k) {
    const int id = k < K ? __ldg(ids + (long long)k * B + b) : -1;
    row[k] = (id >= 0 && id < tabs.rows[k]) ? tabs.t[k] + (long long)id * dt
                                            : nullptr;
  }
  float* dst = out + (long long)b * dt;
  for (int d = threadIdx.x; d < dt; d += kLanes) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxTables; ++k) {
      if (k >= K) break;
      const float v = row[k] != nullptr ? __ldg(row[k] + d) : 0.f;
      acc = k == 0 ? v : acc + v;
    }
    dst[d] = acc;
  }
}

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
  for (int k = 0; k < K; ++k)
    if (tabs.t[k] == nullptr || tabs.rows[k] <= 0)
      return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((B + kRows - 1) / kRows);
  temporal_sum_kernel<<<blocks, dim3(kLanes, kRows), 0,
                        (cudaStream_t)stream>>>(ids, tabs, K, B, dt, out);
  return (int)cudaGetLastError();
}

const char* ncf_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
