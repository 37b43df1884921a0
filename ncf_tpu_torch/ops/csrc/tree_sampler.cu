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
// CDF the count is an upper-bound search, which is exactly what the TPU's
// 128-ary tree descent counts, so the ids are bit-identical given the same
// uniforms.  With one round there is nothing to reject and pos is not read
// (the stratified sampler's pooled draw).
//
// What bounds it on this card: at the training step's shapes (the pooled
// draw: 1 round x 65,536 sorted slots; the iid draw: 2 rounds x 65,536
// slots with positives; a 3,706-item CDF) it moves under 1 MB, about
// 0.25 us at 3.35 TB/s, so the launch and a few dependent memory trips
// decide its time.
//
// Design.  One kernel, for any order of the uniforms.  A block takes kRun
// consecutive slots, four a thread, loaded and stored 16 bytes at a time
// where N and the pointers allow.  Its threads probe the CDF at kThreads
// evenly spaced entries while the uniforms load; the block's least and
// greatest uniform then bracket every answer between two probes, [lo,
// hi), and only that bracket is staged in shared memory.  Sorted uniforms
// (the stratified sampler's pooled draw) give a block a bracket of a few
// dozen entries at ML-1M; iid uniforms give it the whole CDF, as the
// TPU kernel stages it.  A bracket wider than the staging space (kStaged,
// 48 KB of f32) is searched in device memory through the read-only cache,
// so every vocabulary is served (the TPU kernel's 32,768-item gate was a
// VMEM limit).  Every search is a branchless upper-bound search of fixed
// length (the same steps for every value of a range), so a thread keeps
// its four slots' searches in flight together.  A run's last two rounds
// of uniforms and its positives are loaded before the CDF, so their trip
// to memory overlaps its.  Values are compared as f32 directly (the TPU
// kernel's HIGHEST-precision matmul was only there to keep the MXU from
// rounding the boundaries).
//
// Precondition: the CDF is nondecreasing (as the port's make_sampling_cdf,
// a sequential sum on the CPU, gives it).  Where it decreases, an
// upper-bound search and the plain version's count may differ.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 4;                    // slots a thread
constexpr int kRun = kThreads * kSlots;      // slots a block takes
constexpr int kWarps = kThreads / 32;
constexpr int kStaged = 12288;               // widest bracket staged: 48 KB
constexpr int kHeld = 2;                     // rounds loaded ahead

template <bool kGlobal>
__device__ __forceinline__ float at(const float* c, int i) {
  if constexpr (kGlobal) return __ldg(c + i);
  else return c[i];
}

// #{i < n : c[i] <= u[j]} for each j, on a nondecreasing c: the interval
// [base, base + len] holds the answer; each step halves len by a probe
// whose position depends only on n, so the kSlots searches run together
template <bool kGlobal>
__device__ __forceinline__ void count_le(const float* c, int n,
                                         const float (&u)[kSlots],
                                         int (&cnt)[kSlots]) {
#pragma unroll
  for (int j = 0; j < kSlots; ++j) cnt[j] = 0;
  int len = n;
  while (len > 1) {
    const int half = len >> 1;
#pragma unroll
    for (int j = 0; j < kSlots; ++j)
      cnt[j] += at<kGlobal>(c, cnt[j] + half - 1) <= u[j] ? half : 0;
    len -= half;
  }
  if (len == 1) {
#pragma unroll
    for (int j = 0; j < kSlots; ++j) cnt[j] += at<kGlobal>(c, cnt[j]) <= u[j];
  }
}

// u[r * N + n0 + j] for j < kSlots (0 past N), 16 bytes at a time when vec
__device__ __forceinline__ void load_run(const float* __restrict__ u, int r,
                                         int N, long long n0, bool vec,
                                         float (&v)[kSlots]) {
  const float* row = u + (long long)r * N;
  if (vec && n0 < N) {
    const float4 w = __ldg((const float4*)(row + n0));
    v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
  } else {
#pragma unroll
    for (int j = 0; j < kSlots; ++j)
      v[j] = n0 + j < N ? __ldg(row + n0 + j) : 0.f;
  }
}

__device__ __forceinline__ void store_run(int* __restrict__ out, int N,
                                          long long n0, bool vec,
                                          const int (&d)[kSlots]) {
  if (vec && n0 < N) {
    *(int4*)(out + n0) = make_int4(d[0], d[1], d[2], d[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kSlots; ++j)
      if (n0 + j < N) out[n0 + j] = d[j];
  }
}

// What a run needs besides the CDF, loaded before the CDF is: rounds
// R - 1 .. R - kHeld of the uniforms (the others load as they are drawn)
// and, with more than one round, the positives
struct Run {
  float held[kHeld][kSlots];
  int pos[kSlots];
};

__device__ __forceinline__ void load_inputs(const float* __restrict__ u,
                                            int R, int N,
                                            const int* __restrict__ pos,
                                            int neg, long long n0, bool vec,
                                            Run& run) {
#pragma unroll
  for (int h = 0; h < kHeld; ++h)
    if (R - 1 - h >= 0) load_run(u, R - 1 - h, N, n0, vec, run.held[h]);
#pragma unroll
  for (int j = 0; j < kSlots; ++j)
    run.pos[j] = R > 1 && n0 + j < N ? __ldg(pos + (int)(n0 + j) / neg) : 0;
}

// draws of rounds R - 1 .. 0 for slots n0 .. n0 + 3 against c[0, n) (the
// CDF from entry lo on), clipped and rejected as the reference's
// where-chain does
template <bool kGlobal>
__device__ __forceinline__ void draw_run(const float* __restrict__ u, int R,
                                         int N, const float* c, int n, int lo,
                                         int num_items, long long n0,
                                         bool vec, const Run& run,
                                         int (&pick)[kSlots]) {
  auto draw = [&](int r, const float (&v)[kSlots]) {
    int d[kSlots];
    count_le<kGlobal>(c, n, v, d);
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      d[j] = v[j] == v[j] ? d[j] + lo : 0;  // NaN counts nothing
      d[j] = d[j] < num_items - 1 ? d[j] : num_items - 1;
      if (r == R - 1 || d[j] != run.pos[j]) pick[j] = d[j];
    }
  };
#pragma unroll
  for (int h = 0; h < kHeld; ++h)
    if (R - 1 - h >= 0) draw(R - 1 - h, run.held[h]);
  for (int r = R - 1 - kHeld; r >= 0; --r) {
    float v[kSlots];
    load_run(u, r, N, n0, vec, v);
    draw(r, v);
  }
}

// cdf[0, n) into shared memory, 16 bytes at a time where aligned
__device__ __forceinline__ void stage(const float* __restrict__ cdf, int n,
                                      float* s) {
  int i = 0;
  if ((size_t)cdf % 16 == 0) {
    for (int q = threadIdx.x; q < n / 4; q += kThreads)
      ((float4*)s)[q] = __ldg((const float4*)cdf + q);
    i = n / 4 * 4;
  }
  for (i += threadIdx.x; i < n; i += kThreads) s[i] = __ldg(cdf + i);
}

__global__ void __launch_bounds__(kThreads)
tree_sample_kernel(const float* __restrict__ u, int R, int N,
                   const int* __restrict__ pos, int neg,
                   const float* __restrict__ cdf, int n_cdf, int num_items,
                   int vec, int* __restrict__ out) {
  // the warps' least and greatest uniforms, then the staged bracket
  extern __shared__ __align__(16) float s_cdf[];
  float* s_min = s_cdf;
  float* s_max = s_cdf + kWarps;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long n0 = ((long long)blockIdx.x * kThreads + tid) * kSlots;

  // probe j at entry j * stride, j < kThreads: loads in flight with u's
  const int stride = (n_cdf + kThreads - 1) / kThreads;
  const int nprobe = (n_cdf + stride - 1) / stride;
  const float probe = tid < nprobe ? __ldg(cdf + tid * stride) : 0.f;
  Run run;
  load_inputs(u, R, N, pos, neg, n0, vec, run);
  float lo_u = __int_as_float(0x7f800000), hi_u = -lo_u;  // +inf, -inf
  auto extend = [&](const float (&v)[kSlots]) {
#pragma unroll
    for (int j = 0; j < kSlots; ++j)
      if (n0 + j < N) {  // fminf / fmaxf pass over NaN
        lo_u = fminf(lo_u, v[j]);
        hi_u = fmaxf(hi_u, v[j]);
      }
  };
#pragma unroll
  for (int h = 0; h < kHeld; ++h)
    if (R - 1 - h >= 0) extend(run.held[h]);
  for (int r = R - 1 - kHeld; r >= 0; --r) {
    float v[kSlots];
    load_run(u, r, N, n0, vec, v);
    extend(v);
  }
#pragma unroll
  for (int x = 16; x > 0; x >>= 1) {
    lo_u = fminf(lo_u, __shfl_xor_sync(0xffffffffu, lo_u, x));
    hi_u = fmaxf(hi_u, __shfl_xor_sync(0xffffffffu, hi_u, x));
  }
  if (lane == 0) {
    s_min[warp] = lo_u;
    s_max[warp] = hi_u;
  }
  __syncthreads();
  for (int w = 0; w < kWarps; ++w) {
    lo_u = fminf(lo_u, s_min[w]);
    hi_u = fmaxf(hi_u, s_max[w]);
  }
  // probes at or below the least uniform: every entry up to the last of
  // them counts for every slot; the first probe above the greatest one
  // and every entry after it count for none.  (The two counts are also
  // the barrier after which s_min and s_max may be overwritten.)
  const int below = __syncthreads_count(tid < nprobe && probe <= lo_u);
  const int upto = __syncthreads_count(tid < nprobe && probe <= hi_u);
  const int lo = below > 0 ? (below - 1) * stride + 1 : 0;
  int hi = upto < nprobe ? upto * stride : n_cdf;
  hi = hi > lo ? hi : lo;
  const int len = hi - lo;  // block-uniform

  int pick[kSlots];
  if (len <= kStaged) {
    stage(cdf + lo, len, s_cdf);
    __syncthreads();
    draw_run<false>(u, R, N, s_cdf, len, lo, num_items, n0, vec, run, pick);
  } else {
    draw_run<true>(u, R, N, cdf + lo, len, lo, num_items, n0, vec, run,
                   pick);
  }
  store_run(out, N, n0, vec, pick);
}

}  // namespace

extern "C" {

// u: f32 [R, N]; pos: int32 [N / neg] (slot n belongs to row n / neg; not
// read when R == 1); cdf: f32 [n_cdf], nondecreasing; out: int32 [N].
// Returns a cudaError_t (0 on success); errors during the run surface at
// the caller's next synchronisation.
int ncf_tree_sample(const float* u, int R, int N, const int* pos, int neg,
                    int n_cdf, const float* cdf, int num_items, int* out,
                    void* stream) {
  if (R <= 0 || N <= 0 || neg <= 0 || N % neg || n_cdf <= 0 ||
      num_items <= 0)
    return (int)cudaErrorInvalidValue;
  const int vec = N % kSlots == 0 && (size_t)u % 16 == 0 &&
                  (size_t)out % 16 == 0;
  const long long runs = ((long long)N + kRun - 1) / kRun;
  // room for the widest bracket a block may stage (it holds the warps'
  // least and greatest uniforms before that)
  int staged = n_cdf < kStaged ? n_cdf : kStaged;
  staged = staged > 2 * kWarps ? staged : 2 * kWarps;
  tree_sample_kernel<<<(unsigned)runs, kThreads, staged * sizeof(float),
                       (cudaStream_t)stream>>>(u, R, N, pos, neg, cdf, n_cdf,
                                               num_items, vec, out);
  return (int)cudaGetLastError();
}

const char* ncf_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
