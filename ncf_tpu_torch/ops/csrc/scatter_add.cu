// Embedding-gradient scatter-add for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// ncf_tpu/ops/pallas_scatter.py::onehot_scatter_add (body _make_kernel,
// pallas_scatter.py:50; pallas_call in _scatter_add at :161).
//
// Function computed (the TPU kernel's):
//   out[i, :] = sum over n with ids[n] == i of round_mode(g[n, :])
// into a zeroed f32 [num_rows, D] table; ids outside [0, num_rows) add
// nothing.  round_mode: 0 "split" adds float(bf16(g)) + float(bf16(g -
// bf16(g))) (about 16 mantissa bits), 1 "bf16" adds float(bf16(g)), 2 "f32"
// adds g.  g is f32 or bf16 and is read as it is (no upcast copy).  2-D ids
// [rows, slots] with g [rows, slots, D] are walked slot-major, as the
// reference flattens them: when a slot's ids come in sorted runs, the
// atomics of neighbouring warps land on neighbouring table rows.
//
// What bounds it on this card: the bytes.  At the item table of the
// training step (81,920 bf16 rows of 128 into 3,706 x 128 f32) it reads
// 21 MB of gradients and ids and writes 1.9 MB, 6.9 us at 3.35 TB/s; the
// f32 atomics resolve in L2, where the 1.9 MB table stays resident.
//
// Design: the TPU kernel turned the scatter into one-hot matmuls on its
// matrix unit, holding the whole accumulator in VMEM.  Hopper has fast L2
// atomics instead: the table is zeroed with cudaMemsetAsync, then each warp
// takes one input row and adds it across D with f32 atomicAdd, lanes on
// consecutive columns.  Atomics add in an order that changes from run to
// run, so results agree with a sequential sum within a few f32 ulps of
// sum |g| per element, not bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocksX = 65535;
constexpr int kMaxSlots = 65535;  // gridDim.y

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
scatter_add_kernel(const int* __restrict__ ids, const T* __restrict__ g,
                   int rows, int slots, int D, int num_rows,
                   float* __restrict__ out) {
  // blockIdx.y is the slot: blocks are issued slot-major, as the reference
  // flattens 2-D ids, and no thread divides to find its element
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.y;
  for (int b = blockIdx.x * kWarps + (threadIdx.x >> 5); b < rows;
       b += gridDim.x * kWarps) {
    const long long e = (long long)b * slots + s;
    const int id = __ldg(ids + e);
    if (id < 0 || id >= num_rows) continue;  // warp-uniform
    const T* src = g + e * D;
    float* dst = out + (long long)id * D;
    for (int d = lane; d < D; d += 32) {
      float x = load(src + d);
      float v;
      if (kMode == 0) {
        float hi = bf16_round(x);
        v = hi + bf16_round(x - hi);
      } else if (kMode == 1) {
        v = bf16_round(x);
      } else {
        v = x;
      }
      atomicAdd(dst + d, v);
    }
  }
}

template <typename T>
cudaError_t launch(const int* ids, const void* g, int rows, int slots, int D,
                   int num_rows, int mode, float* out, cudaStream_t s) {
  const int want = (rows + kWarps - 1) / kWarps;
  const dim3 grid((unsigned)(want < kMaxBlocksX ? want : kMaxBlocksX),
                  (unsigned)slots);
  const T* gp = (const T*)g;
  if (mode == 0)
    scatter_add_kernel<T, 0><<<grid, kThreads, 0, s>>>(ids, gp, rows, slots,
                                                       D, num_rows, out);
  else if (mode == 1)
    scatter_add_kernel<T, 1><<<grid, kThreads, 0, s>>>(ids, gp, rows, slots,
                                                       D, num_rows, out);
  else
    scatter_add_kernel<T, 2><<<grid, kThreads, 0, s>>>(ids, gp, rows, slots,
                                                       D, num_rows, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// ids: int32 [rows, slots] (slots <= 65,535); g: [rows, slots, D] of dtype
// 0 = float32, 1 = bfloat16; mode: 0 split, 1 bf16, 2 f32; out: f32
// [num_rows, D], zeroed here.  Returns a cudaError_t (0 on success); errors
// during the run surface at the caller's next synchronisation.
int ncf_scatter_add(const int* ids, const void* g, int dtype, int rows,
                    int slots, int D, int num_rows, int mode, float* out,
                    void* stream) {
  if (rows < 0 || slots <= 0 || slots > kMaxSlots || D <= 0 ||
      num_rows <= 0 || (dtype != 0 && dtype != 1) || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(
      out, 0, (size_t)num_rows * (size_t)D * sizeof(float), s);
  if (err != cudaSuccess || rows == 0) return (int)err;
  err = dtype == 0
            ? launch<float>(ids, g, rows, slots, D, num_rows, mode, out, s)
            : launch<__nv_bfloat16>(ids, g, rows, slots, D, num_rows, mode,
                                    out, s);
  return (int)err;
}

const char* ncf_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
