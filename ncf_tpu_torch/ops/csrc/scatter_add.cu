// Deterministic embedding-gradient scatter-add for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// ncf_tpu/ops/pallas_scatter.py::onehot_scatter_add (body _make_kernel,
// pallas_scatter.py:50; pallas_call in _scatter_add at :161).
//
// Function computed (the TPU kernel's):
//   out[i, :] = sum over n with ids[n] == i of round_mode(g[n, :])
// into an f32 [num_rows, D] table; ids outside [0, num_rows) add nothing.
// round_mode: 0 "split" adds float(bf16(g)) + float(bf16(g - bf16(g)))
// (about 16 mantissa bits), 1 "bf16" adds float(bf16(g)), 2 "f32" adds g.
// g is f32 or bf16 and is read as it is (no upcast copy).
//
// The order of the adds is fixed: each element of row i is the sequential
// f32 sum, in flattened order, of that row's rounded values, starting
// from 0.0 -- what a sequential np.add.at in f32 computes.  2-D ids [rows,
// slots] are flattened slot-major, as the reference flattens them.  So
// the result does not depend on the run, the launch or the card, and
// equals the plain version bit for bit.  The TPU kernel reached the same
// property by summing one-hot matmuls over a sequential grid of id
// chunks; Hopper has no sequential grid, and f32 atomics add in an order
// that changes from run to run.
//
// Design: group by id, then reduce each group in order.  The caller sorts
// the flattened ids stably (positions with equal ids keep their flattened
// order) and passes the sorted ids with their flattened positions.  Here
// one warp takes one table row and up to 128 of its columns (1, 2 or 4 a
// lane, one for rows of up to 32 values): it finds the row's run in the
// sorted ids by a 32-way search (32 probes a step, a ballot picks the
// interval), then walks the run 32 positions at a time, 32 loads in
// flight while the previous 32 values are added in order, and the
// positions of the chunk after next already fetched.  It writes the row
// once: no atomics, no memset, and rows that no id touches are written
// as zero.
//
// Long runs: popular items, and the small tables (7 weekdays, a few
// departments), repeat hundreds to thousands of times in a step's ids.
// Each column's sum is a chain of dependent f32 adds, so a run of L ids
// costs at least L add latencies whatever the design, and one warp alone
// cannot keep enough of its loads in flight.  So a warp that finds its
// row's run longer than kLongRun positions lists the row and leaves it to
// a second kernel, where a block takes the row: its eight warps fetch
// the next stage of the run's values into shared memory, 384 loads in
// flight, while one warp a 32 columns adds the current stage in order.
// A long run never holds up the other rows' warps.
//
// What bounds it on this card: the bytes.  At the item table of the
// training step (81,920 bf16 rows of 128 into 3,706 x 128 f32) it reads
// 21 MB of gradients and ids and writes 1.9 MB, 6.9 us at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kLongRun = 128;     // longer runs go to long_runs_kernel
constexpr int kLongThreads = 256;
constexpr int kLongWarps = kLongThreads / 32;
constexpr int kLongBlocks = 1024;

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int kMode>
__device__ __forceinline__ float rounded(float x) {
  if (kMode == 0) {
    const float hi = bf16_round(x);
    return hi + bf16_round(x - hi);
  }
  if (kMode == 1) return bf16_round(x);
  return x;
}

// first p in [0, n) with sorted[p] >= key, or n; every lane gets it
__device__ __forceinline__ int lower_bound(const int* __restrict__ sorted,
                                           int n, int key, int lane) {
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const int stride = (hi - lo + 31) >> 5;
    const long long p = lo + (long long)lane * stride;
    const bool less = p < hi && __ldg(sorted + p) < key;
    const int c = __popc(__ballot_sync(kAll, less));  // a prefix of lanes
    const long long top = lo + (long long)c * stride;
    hi = top < hi ? (int)top : hi;
    lo = c == 0 ? lo : lo + (c - 1) * stride + 1;
  }
  const int p = lo + lane;
  const bool less = p < hi && __ldg(sorted + p) < key;
  return lo + __popc(__ballot_sync(kAll, less));
}

// A chunk is 32 consecutive positions of the sorted ids.  Its raw fetch
// (this lane's sorted id and flattened position, loaded with no test on
// either) is issued a chunk before it is needed, and only then turned
// into its meta: how many of the 32 belong to `row` (a prefix), and for
// this lane's position the row of g it reads (row 0 for positions past
// the run: a valid address, loaded and never added).
struct Raw {
  int id;
  long long f;
};

__device__ __forceinline__ Raw fetch_chunk(const int* __restrict__ sorted,
                                           const long long* __restrict__ perm,
                                           int n, int p, int lane) {
  const int q = p + lane;
  Raw r{-1, 0};
  if (q < n) {
    r.id = __ldg(sorted + q);
    r.f = __ldg(perm + q);
  }
  return r;
}

__device__ __forceinline__ void chunk_meta(const Raw& r, int row, int rows,
                                           int slots, int& cnt, int& e) {
  const bool mine = r.id == row;
  cnt = __popc(__ballot_sync(kAll, mine));
  e = mine ? (int)(slots == 1 ? r.f : (r.f % rows) * slots + r.f / rows)
           : 0;
}

// acc[c] += rounded(v[j][c]) for j < m, in order of j.  The roundings,
// independent of one another, come first and with no branch among them;
// then the adds, each kept or dropped by a select (not an add of 0.f:
// -0.f + 0.f is +0.f), so the chain of dependent adds is all that waits.
template <int kMode, int G, int CPL>
__device__ __forceinline__ void add_in_order(const float (&v)[G][CPL], int m,
                                             float (&acc)[CPL]) {
  float r[G][CPL];
#pragma unroll
  for (int j = 0; j < G; ++j)
#pragma unroll
    for (int c = 0; c < CPL; ++c) r[j][c] = rounded<kMode>(v[j][c]);
#pragma unroll
  for (int j = 0; j < G; ++j)
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[c] = j < m ? acc[c] + r[j][c] : acc[c];
}

// the raw values of chunk positions j0 .. j0 + G - 1 in this lane's CPL
// columns: G * CPL loads with no branch between them, so all are in flight
// together
template <typename T, int CPL, int G>
__device__ __forceinline__ void load_group(const T* __restrict__ g, int D,
                                           const int (&col)[CPL], int e,
                                           int j0, float (&v)[G][CPL]) {
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const T* src = g + (long long)__shfl_sync(kAll, e, j0 + j) * D;
#pragma unroll
    for (int c = 0; c < CPL; ++c) v[j][c] = load(src + col[c]);
  }
}

// One warp per (table row, 32 * CPL columns); lane l owns columns l, l +
// 32, ... (CPL of them).  A run is walked in chunks of 32 sorted positions
// and each chunk in groups of G = 32 / CPL rows: the next group's loads,
// and the fetch of the chunk after next, are issued before the current
// group is added, in order, so nothing waits on a load issued just before.
template <typename T, int kMode, int CPL>
__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(const int* __restrict__ sorted,
                    const long long* __restrict__ perm,
                    const T* __restrict__ g, int n, int rows, int slots,
                    int D, int num_rows, int ngroups, int* __restrict__ longs,
                    float* __restrict__ out) {
  constexpr int G = 32 / CPL;
  const int lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= (long long)num_rows * ngroups) return;  // warp-uniform
  const int row = (int)(w / ngroups);
  const int col0 = (int)(w % ngroups) * 32 * CPL + lane;
  int col[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c)  // dead columns read column 0, unwritten
    col[c] = col0 + 32 * c < D ? col0 + 32 * c : 0;
  float acc[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) acc[c] = 0.f;

  int p = lower_bound(sorted, n, row, lane);
  const Raw raw0 = fetch_chunk(sorted, perm, n, p, lane);
  if (p + kLongRun < n && __ldg(sorted + p + kLongRun) == row) {
    // a long run: the whole row goes to long_runs_kernel (the order of
    // the list does not matter, each row is summed on its own)
    if (lane == 0 && w % ngroups == 0) longs[1 + atomicAdd(longs, 1)] = row;
    return;
  }
  // chunk c's meta (cnt, e), chunk c + 1's (cnt1, e1), chunk c + 2's raw
  int cnt, e, cnt1, e1;
  chunk_meta(raw0, row, rows, slots, cnt, e);
  Raw raw1 = fetch_chunk(sorted, perm, n, p + 32, lane);
  Raw raw2 = fetch_chunk(sorted, perm, n, p + 64, lane);
  chunk_meta(raw1, row, rows, slots, cnt1, e1);
  if (cnt > 0) {  // warp-uniform, as are all the counts below
    float cur[G][CPL], nxt[G][CPL];
    load_group<T, CPL, G>(g, D, col, e, 0, cur);
    int j0 = 0;  // the current group's first position in its chunk
    while (true) {
      // start the next group's loads (the next chunk's first group needs
      // its meta, made from a fetch a chunk old), then add this group in
      // order while they are on their way
      const bool same_chunk = j0 + G < cnt;
      const bool next_chunk = !same_chunk && cnt1 > 0;  // then cnt == 32
      int cnt2 = 0, e2 = 0;
      if (same_chunk) {
        load_group<T, CPL, G>(g, D, col, e, j0 + G, nxt);
      } else if (next_chunk) {
        load_group<T, CPL, G>(g, D, col, e1, 0, nxt);
        chunk_meta(raw2, row, rows, slots, cnt2, e2);
        raw2 = fetch_chunk(sorted, perm, n, p + 96, lane);
      }
      add_in_order<kMode, G, CPL>(cur, cnt - j0, acc);
      if (same_chunk) {
        j0 += G;
      } else if (next_chunk) {
        p += 32;
        j0 = 0;
        cnt = cnt1;
        e = e1;
        cnt1 = cnt2;
        e1 = e2;
      } else {
        break;
      }
#pragma unroll
      for (int j = 0; j < G; ++j)
#pragma unroll
        for (int c = 0; c < CPL; ++c) cur[j][c] = nxt[j][c];
    }
  }
#pragma unroll
  for (int c = 0; c < CPL; ++c)
    if (col0 + 32 * c < D) out[(long long)row * D + col0 + 32 * c] = acc[c];
}

// The rows of long runs (listed by scatter_rows_kernel), a block each, GP
// groups of 32 columns a pass.  The run goes by stages of R positions
// through two buffers of shared memory: while warp c adds column group c
// of stage s in order, all eight warps have the values of stage s + 1 (48
// loads a warp) and the positions of stage s + 2 in flight; one barrier a
// stage.
template <int GP>
struct LongStage {
  static constexpr int R = 384 / GP;          // positions a stage
  static constexpr int PER = R / kLongWarps;  // of them a warp fetches
  static constexpr int kBytes = 2 * R * GP * 32 * (int)sizeof(float);
};

template <typename T, int kMode, int GP>
__global__ void __launch_bounds__(kLongThreads)
long_runs_kernel(const int* __restrict__ sorted,
                 const long long* __restrict__ perm,
                 const T* __restrict__ g, int n, int rows, int slots, int D,
                 const int* __restrict__ longs, float* __restrict__ out) {
  constexpr int R = LongStage<GP>::R, PER = LongStage<GP>::PER;
  constexpr int W = GP * 32;                 // staged columns
  constexpr int EPT = (R + kLongThreads - 1) / kLongThreads;
  extern __shared__ float buf[];             // [2][R][W]
  __shared__ int E[2][R];                    // g rows of a stage
  __shared__ int s_lo, s_hi;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ng = (D + 31) / 32;
  // the g rows of positions base .. base + R - 1 (up to hi) into E[b]
  auto fetch_rows = [&](int base, int hi, int (&e)[EPT]) {
#pragma unroll
    for (int k = 0; k < EPT; ++k) {
      const int r = threadIdx.x + k * kLongThreads;
      e[k] = 0;
      if (r < R && base + r < hi) {
        const long long f = __ldg(perm + base + r);
        e[k] = (int)(slots == 1 ? f : (f % rows) * slots + f / rows);
      }
    }
  };
  auto store_rows = [&](int b, const int (&e)[EPT]) {
#pragma unroll
    for (int k = 0; k < EPT; ++k) {
      const int r = threadIdx.x + k * kLongThreads;
      if (r < R) E[b][r] = e[k];
    }
  };
  for (int i = blockIdx.x; i < longs[0]; i += gridDim.x) {
    const int row = longs[1 + i];
    if (warp == 0) {
      const int lo = lower_bound(sorted, n, row, lane);
      const int hi = lower_bound(sorted, n, row + 1, lane);
      if (lane == 0) {
        s_lo = lo;
        s_hi = hi;
      }
    }
    __syncthreads();
    const int lo = s_lo, hi = s_hi;
    const int nst = (hi - lo + R - 1) / R;   // stages
    for (int g0 = 0; g0 < ng; g0 += GP) {
      int col[GP];
#pragma unroll
      for (int c = 0; c < GP; ++c) {  // dead columns read column 0
        const int cc = (g0 + c) * 32 + lane;
        col[c] = cc < D ? cc : 0;
      }
      // this warp's values of a stage whose g rows are in E[b]: rows
      // past the run read its last row and are never added
      float v[PER][GP];
      auto fetch_values = [&](int b, int m) {
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          const int r = warp + j * kLongWarps;
          const T* src = g + (long long)E[b][r < m ? r : m - 1] * D;
#pragma unroll
          for (int c = 0; c < GP; ++c) v[j][c] = load(src + col[c]);
        }
      };
      auto store_values = [&](int b) {
#pragma unroll
        for (int j = 0; j < PER; ++j)
#pragma unroll
          for (int c = 0; c < GP; ++c)
            buf[(b * R + warp + j * kLongWarps) * W + c * 32 + lane] =
                v[j][c];
      };
      int e[EPT];
      fetch_rows(lo, hi, e);
      store_rows(0, e);
      __syncthreads();
      fetch_values(0, hi - lo < R ? hi - lo : R);
      fetch_rows(lo + R, hi, e);
      store_values(0);
      store_rows(1, e);
      __syncthreads();
      float acc = 0.f;
      for (int st = 0; st < nst; ++st) {
        const int base = lo + st * R;
        const int m = hi - base < R ? hi - base : R;
        const int b = st & 1;
        if (st + 1 < nst) {  // block-uniform
          fetch_values(b ^ 1, hi - base - R < R ? hi - base - R : R);
          fetch_rows(base + 2 * R, hi, e);
        }
        if (warp < GP) {
          const float* x = buf + (size_t)b * R * W + warp * 32 + lane;
          float a1[1] = {acc};
          for (int r0 = 0; r0 < m; r0 += 8) {
            float y[8][1];
#pragma unroll
            for (int j = 0; j < 8; ++j) y[j][0] = x[(r0 + j) * W];
            add_in_order<kMode, 8, 1>(y, m - r0, a1);
          }
          acc = a1[0];
        }
        if (st + 1 < nst) {
          store_values(b ^ 1);
          store_rows(b, e);   // E[b] was read by the fetch of stage st
        }
        __syncthreads();
      }
      const int cc = (g0 + warp) * 32 + lane;
      if (warp < GP && cc < D) out[(long long)row * D + cc] = acc;
    }
  }
}

template <typename T, int kMode, int CPL>
cudaError_t launch_mode(const int* sorted, const long long* perm, const T* g,
                        int n, int rows, int slots, int D, int num_rows,
                        int* longs, float* out, cudaStream_t s) {
  const int ngroups = (D + 32 * CPL - 1) / (32 * CPL);
  const long long warps = (long long)num_rows * ngroups;
  const unsigned grid = (unsigned)((warps + kWarps - 1) / kWarps);
  // at most n / (kLongRun + 1) rows have runs longer than kLongRun
  const int max_long = n / (kLongRun + 1);
  const unsigned lgrid = (unsigned)(max_long < 1 ? 1
                                    : max_long < kLongBlocks ? max_long
                                                             : kLongBlocks);
  constexpr int kStage = LongStage<CPL>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      (const void*)long_runs_kernel<T, kMode, CPL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kStage);
  if (attr != cudaSuccess) return attr;
  cudaError_t err = cudaMemsetAsync(longs, 0, sizeof(int), s);
  if (err != cudaSuccess) return err;
  scatter_rows_kernel<T, kMode, CPL><<<grid, kThreads, 0, s>>>(
      sorted, perm, g, n, rows, slots, D, num_rows, ngroups, longs, out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  long_runs_kernel<T, kMode, CPL><<<lgrid, kLongThreads, kStage, s>>>(
      sorted, perm, g, n, rows, slots, D, longs, out);
  return cudaGetLastError();
}

template <typename T, int CPL>
cudaError_t launch_cpl(const int* sorted, const long long* perm,
                       const void* g, int n, int rows, int slots, int D,
                       int num_rows, int mode, int* longs, float* out,
                       cudaStream_t s) {
  const T* gp = (const T*)g;
  if (mode == 0)
    return launch_mode<T, 0, CPL>(sorted, perm, gp, n, rows, slots, D,
                                  num_rows, longs, out, s);
  if (mode == 1)
    return launch_mode<T, 1, CPL>(sorted, perm, gp, n, rows, slots, D,
                                  num_rows, longs, out, s);
  return launch_mode<T, 2, CPL>(sorted, perm, gp, n, rows, slots, D,
                                num_rows, longs, out, s);
}

// columns a lane: one for rows of up to 32 values (long runs of the small
// tables then get a warp a 32 columns), up to four for wider rows
template <typename T>
cudaError_t launch(const int* sorted, const long long* perm, const void* g,
                   int n, int rows, int slots, int D, int num_rows, int mode,
                   int* longs, float* out, cudaStream_t s) {
  if (D <= 32)
    return launch_cpl<T, 1>(sorted, perm, g, n, rows, slots, D, num_rows,
                            mode, longs, out, s);
  if (D <= 64)
    return launch_cpl<T, 2>(sorted, perm, g, n, rows, slots, D, num_rows,
                            mode, longs, out, s);
  return launch_cpl<T, 4>(sorted, perm, g, n, rows, slots, D, num_rows, mode,
                          longs, out, s);
}

}  // namespace

extern "C" {

// sorted: the flattened ids as int32, stably sorted; perm: int64, the
// flattened position of each sorted id (torch.sort(..., stable=True));
// n ids.  The flattened position f reads g row f when slots == 1, else
// (ids [rows, slots], flattened slot-major) g row (f % rows) * slots +
// f / rows.  g: [n, D] of dtype 0 = float32, 1 = bfloat16; mode: 0 split,
// 1 bf16, 2 f32; longs: int32 scratch of 1 + n / 129 entries (the rows of
// long runs); out: f32 [num_rows, D], every element written.  Returns a
// cudaError_t (0 on success); errors during the run surface at the
// caller's next synchronisation.
int ncf_scatter_add(const int* sorted, const long long* perm, const void* g,
                    int dtype, int n, int rows, int slots, int D,
                    int num_rows, int mode, int* longs, float* out,
                    void* stream) {
  if (n < 0 || rows < 0 || slots <= 0 || (long long)rows * slots != n ||
      D <= 0 || num_rows <= 0 || (dtype != 0 && dtype != 1) || mode < 0 ||
      mode > 2 || (long long)num_rows * D >
                      (long long)kWarps * 32 * 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(dtype == 0
                   ? launch<float>(sorted, perm, g, n, rows, slots, D,
                                   num_rows, mode, longs, out, s)
                   : launch<__nv_bfloat16>(sorted, perm, g, n, rows, slots,
                                           D, num_rows, mode, longs, out, s));
}

const char* ncf_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
