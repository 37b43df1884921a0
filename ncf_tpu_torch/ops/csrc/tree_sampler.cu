// Weighted negative draws by inverse CDF with first-non-positive rejection,
// for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// ncf_tpu/ops/pallas_sampler.py::tree_sample_negatives (body _make_kernel,
// pallas_sampler.py:83; pallas_call in _tree_sample at :145).
//
// Function computed (the TPU kernel's): for slot n and round r,
//   draw[r, n] = min(#{i : cdf[i] <= u[r, n]}, num_items - 1)
// and the slot keeps the first round whose draw is not pos[n / neg] (the
// positive of its row), else the last round's draw.  On a nondecreasing
// CDF the count is an upper-bound binary search, which is exactly what the
// TPU's 128-ary tree descent counts, so the ids are bit-identical given the
// same uniforms.  pos = -1 rejects nothing (the stratified sampler's pooled
// draw).
//
// What bounds it on this card: at the training step's shape (R = 2 rounds x
// 65,536 slots over a 3,706-item CDF) it reads 0.5 MB of uniforms and
// writes 0.26 MB of ids, about 0.3 us at 3.35 TB/s; each draw costs ~12
// dependent shared-memory probes, so in practice launch latency dominates.
//
// Design: one thread per slot.  The CDF is staged in shared memory when it
// fits in 48 KB (12,288 items; ML-1M's 3,706 take 15 KB) and searched in
// device memory through the read-only cache otherwise, so every vocabulary
// is served (the TPU kernel's 32,768-item gate was a VMEM limit).  Values
// are compared as f32 directly (the TPU kernel's HIGHEST-precision matmul
// was only there to keep the MXU from rounding the boundaries).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSharedItems = 12288;  // 48 KB of f32

// #{i < n : cdf[i] <= u} on a nondecreasing array
__device__ __forceinline__ int count_le(const float* cdf, int n, float u) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (cdf[mid] <= u) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
tree_sample_kernel(const float* __restrict__ u, int R, int N,
                   const int* __restrict__ pos, int neg,
                   const float* __restrict__ cdf, int n_cdf, int num_items,
                   int* __restrict__ out) {
  extern __shared__ float s_cdf[];
  const float* c = cdf;
  if (kShared) {
    for (int i = threadIdx.x; i < n_cdf; i += blockDim.x) s_cdf[i] = cdf[i];
    __syncthreads();
    c = s_cdf;
  }
  const int n = blockIdx.x * blockDim.x + threadIdx.x;  // N < 2^31
  if (n >= N) return;
  const int p = pos[n / neg];
  int pick = 0;
  for (int r = R - 1; r >= 0; --r) {  // the reference's where-chain
    int d = count_le(c, n_cdf, u[(long long)r * N + n]);
    d = d < num_items - 1 ? d : num_items - 1;
    if (r == R - 1 || d != p) pick = d;
  }
  out[n] = pick;
}

}  // namespace

extern "C" {

// u: f32 [R, N]; pos: int32 [N / neg] (slot n belongs to row n / neg);
// cdf: f32 [n_cdf], nondecreasing; out: int32 [N].  Returns a cudaError_t
// (0 on success); errors during the run surface at the caller's next
// synchronisation.
int ncf_tree_sample(const float* u, int R, int N, const int* pos, int neg,
                    int n_cdf, const float* cdf, int num_items, int* out,
                    void* stream) {
  if (R <= 0 || N <= 0 || neg <= 0 || N % neg || n_cdf <= 0 ||
      num_items <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)((N + kThreads - 1) / kThreads);
  if (n_cdf <= kSharedItems) {
    tree_sample_kernel<true><<<blocks, kThreads, n_cdf * sizeof(float), s>>>(
        u, R, N, pos, neg, cdf, n_cdf, num_items, out);
  } else {
    tree_sample_kernel<false><<<blocks, kThreads, 0, s>>>(
        u, R, N, pos, neg, cdf, n_cdf, num_items, out);
  }
  return (int)cudaGetLastError();
}

const char* ncf_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
