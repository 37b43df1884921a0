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
// slots] are flattened slot-major, as the reference flattens them: the
// flattened position f reads ids and g at row (f % rows) * slots + f /
// rows.  So the result does not depend on the run, the launch or the card,
// and equals the plain version bit for bit.  The TPU kernel reached the
// same property by summing one-hot matmuls over a sequential grid of id
// chunks; Hopper has no sequential grid, f32 atomics add in an order that
// changes from run to run, and the tensor cores add in their own order.
//
// Design: group the positions by row, then add each row's run in order.
// One call of ncf_scatter_add launches every kernel on the caller's
// stream; the wrapper allocates at most one int32 scratch.  Three routes:
//
// 1. Small tables (up to kSmallRows rows, n up to kSmallN: the temporal
//    and vocabulary-level tables), one kernel, scatter_small_kernel: a
//    block a (row, 32 columns) lists its row's positions in flattened
//    order in shared memory by an ordered compaction (a ballot a slab of
//    32, the earlier slabs' counts scanned), a stable counting sort with
//    one bucket, then sums the list as add_run does.
// 2. Tables up to kCountRowLimit rows (the user and item tables): a
//    stable counting sort of the flattened positions by id, then the
//    adds.  group_hist_kernel: a block a chunk of kChunk positions counts
//    each row's positions (shared atomics; ids out of range dropped).
//    group_colscan_kernel: a thread a row turns the chunk counts into the
//    row's positions before each chunk and scans the rows into their
//    starts (the CSR of runs), each block adding the sums the earlier
//    blocks publish; it lists the rows of long runs.
//    group_place_kernel: each warp of a chunk counts its part a row
//    (16-bit shared counts), the warps' counts are scanned, and each
//    position goes to start + earlier chunks + earlier warps + the equal
//    ids of the lower lanes (__match_any_sync), so equal ids keep their
//    flattened order.  What it writes is the row of g each sorted
//    position reads.
// 3. Larger tables (the exchange's shard rows, millions) and a grouping
//    the caller already made (the sparse combine's): the caller passes
//    the sorted rows and flattened positions (torch.sort), and
//    group_csr_kernel writes each row's start and end where its run
//    begins and ends (a row no id names keeps garbage there, which the
//    adds reject: row_of at that start is not the row).
//
// The adds of routes 2 and 3 (scatter_rows_kernel): runs of up to
// kLongRun positions take a warp a row and up to 128 of its columns (1, 2
// or 4 consecutive a lane, read as one word), 32 positions' loads in
// flight before the first add.  Longer runs take a block per (row, 32
// columns) at the head of the grid, as do all of route 1's rows
// (add_run): one consumer warp adds, a lane a column, from a ring of
// kSlots stages of kStage positions in shared memory, loading the next
// stage 16 bytes at a time before adding this one; each producer warp
// fills its own slot, loading its next stage's values before it rounds
// and stores the current one; named barriers signal full and free.
// Every output element is written once (rows no id names as zeros): no
// atomics on the result and no memset.
//
// Roundings are branch-free and every add of a partial stage or batch is
// kept or dropped by a select (an add of 0.f would turn -0.f into +0.f).
//
// Bounds and what holds it (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py
// --scatter-ab, the training step's seven launches).  Bytes: at the item
// table (81,920 bf16 rows of 128 into 3,706 x 128 f32) 21 MB read and
// 1.9 MB written, 6.9 us at 3.35 TB/s; it takes 27 us of device time,
// the adds 12 (bytes in flight, and two dependent loads before each
// warp's first add) and the grouping 15 (its three kernels' fixed costs:
// each global load round trip and each kernel boundary is a microsecond
// or more at these sizes).  A long run is bounded by its chain of
// dependent f32 adds instead, one a position: the weekday table's 2,413
// positions a row take at least ~4.9 us at 4 cycles an add and 1.98 GHz,
// and the weekday launch takes 29 us: the compaction before the chain,
// and a barrier and the shared loads of each stage within it, come on
// top of the adds.  The host sets the pace of a call: 22-82 us a call,
// one ctypes call and up to four launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;        // every kernel's block
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;
// the counting route: positions a grouping block takes (at least), blocks
// at most before the chunks grow, the largest chunk (its counts are 16-bit)
constexpr int kChunk = 2048;
constexpr int kMaxChunks = 256;
constexpr int kMaxChunk = 65280;
constexpr int kCountRowLimit = 11264;   // group_place_kernel's shared memory
constexpr int kBatch = 8;               // 32-position slabs loaded at once
constexpr int kLongRun = 128;           // longer runs take the long path
constexpr int kStage = 32;              // positions a ring stage
static_assert(kStage <= 32, "a producer holds a stage's rows, one a lane");
constexpr int kSlots = kWarps - 1;      // ring slots: warps 1.. fill one each
constexpr int kLongBlocks = 132;        // long-run blocks at most
constexpr int kSmallRows = 64;          // the small tables' route: rows,
constexpr int kSmallN = 32768;          // and positions at most

__host__ __device__ __forceinline__ int chunk_size(int n) {
  if (n <= kChunk * kMaxChunks) return kChunk;
  const int c = (n + kMaxChunks - 1) / kMaxChunks;
  return (c + kThreads - 1) / kThreads * kThreads;
}

__host__ __device__ __forceinline__ int num_chunks(int n) {
  return n == 0 ? 1 : (n + chunk_size(n) - 1) / chunk_size(n);
}

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

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// ------------------------------------------------------------- grouping

// A lane's flattened position f as (f % rows, f / rows), stepped 32 at a
// time without a division: its row of ids and g is r * slots + s (1-D ids
// have slots 1 and rows n, so r = f).  One division where the walk starts.
struct Walk {
  int r, s;
  __device__ __forceinline__ Walk(int f, int rows)
      : r(rows ? f % rows : 0), s(rows ? f / rows : 0) {}
  __device__ __forceinline__ int row(int slots) const { return r * slots + s; }
  __device__ __forceinline__ void step(int rows) {
    r += 32;
    while (r >= rows) {
      r -= rows;
      ++s;
    }
  }
};

// kBatch slabs of 32 flattened positions from f0 < lim (the walk at f0 +
// lane, stepped past them): each lane's row of g (e) and its id as a row,
// or -1 out of range.  Every load is issued, past lim at element 0 (there
// is one: f0 < lim <= n), before any value is used, so the kBatch loads
// wait as one.
template <typename I>
__device__ __forceinline__ void load_keys(const I* __restrict__ ids, int f0,
                                          int lim, int rows, int slots,
                                          int R, int lane, Walk& walk,
                                          int (&key)[kBatch],
                                          int (&e)[kBatch]) {
  I raw[kBatch];
#pragma unroll
  for (int k = 0; k < kBatch; ++k) {
    e[k] = f0 + k * 32 + lane < lim ? walk.row(slots) : 0;
    walk.step(rows);
    raw[k] = __ldg(ids + e[k]);
  }
#pragma unroll
  for (int k = 0; k < kBatch; ++k) {
    const long long id = (long long)raw[k];
    key[k] = f0 + k * 32 + lane < lim && id >= 0 && id < R ? (int)id : -1;
  }
}

// chunk c's count of each row: hist[c * R + r] (the order of the counts'
// adds does not matter).  Block 0 zeroes colscan's flags and counter.
template <typename I>
__global__ void __launch_bounds__(kThreads)
group_hist_kernel(const I* __restrict__ ids, int n, int rows, int slots,
                  int R, int* __restrict__ hist, int* __restrict__ zero) {
  extern __shared__ int h[];  // [R]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // colscan's flags and counter: R / kThreads + 2 ints
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < R / kThreads + 2; i += kThreads) zero[i] = 0;
  for (int r = threadIdx.x; r < R; r += kThreads) h[r] = 0;
  __syncthreads();
  const int per = chunk_size(n) / kWarps;
  const int lo = blockIdx.x * chunk_size(n) + warp * per;
  const int hi = min(lo + per, n);
  Walk walk(lo + lane, rows);
  for (int f0 = lo; f0 < hi; f0 += 32 * kBatch) {  // warp-uniform
    int key[kBatch], e[kBatch];
    load_keys(ids, f0, hi, rows, slots, R, lane, walk, key, e);
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (key[k] >= 0) atomicAdd(&h[key[k]], 1);
  }
  __syncthreads();
  int* out = hist + (long long)blockIdx.x * R;
  for (int r = threadIdx.x; r < R; r += kThreads) out[r] = h[r];
}

// exclusive prefix of x over the block, and the block's total
__device__ __forceinline__ int block_exclusive_scan(int x, int& total) {
  __shared__ int s_w[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kAll, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) s_w[warp] = inc;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int v = s_w[w];
    before += w < warp ? v : 0;
    all += v;
  }
  __syncthreads();
  total = all;
  return before + inc - x;
}

// A thread a row r <= R (row R has no positions): hist[c * R + r] becomes
// the row's positions in the chunks before c, and start[r] the row's
// start among the sorted positions: the block's rows before r plus the
// sums of the blocks before this one, which each block publishes (flag 1
// in the top bit: sums stay below 2^31) and reads back from the earlier
// blocks (these started before it, so they publish without waiting).
// The rows of long runs are listed (counter of them, in no order; the
// last block copies the count to longs[0]).  flags[] and counter start at
// 0 (group_hist_kernel).
__global__ void __launch_bounds__(kThreads)
group_colscan_kernel(int* __restrict__ hist, int nchunks, int R,
                     int* __restrict__ start, int* __restrict__ flags,
                     int* __restrict__ counter, int* __restrict__ longs) {
  __shared__ int s_off;
  const int r = blockIdx.x * kThreads + threadIdx.x;
  int run = 0;
  if (r < R) {
    for (int c = 0; c < nchunks; c += 64) {  // up to 64 loads in flight
      int v[64];
#pragma unroll
      for (int k = 0; k < 64; ++k)
        v[k] = c + k < nchunks ? hist[(long long)(c + k) * R + r] : 0;
#pragma unroll
      for (int k = 0; k < 64; ++k) {
        if (c + k < nchunks) hist[(long long)(c + k) * R + r] = run;
        run += v[k];
      }
    }
    if (run > kLongRun) longs[1 + atomicAdd(counter, 1)] = r;
  }
  int total;
  const int before = block_exclusive_scan(run, total);
  if (threadIdx.x == 0) {
    __threadfence();  // the rows listed above, before the sum
    atomicExch(flags + blockIdx.x, (int)(0x80000000u | (unsigned)total));
    s_off = 0;
  }
  __syncthreads();
  int off = 0;
  for (int b = threadIdx.x; b < (int)blockIdx.x; b += kThreads) {
    int f;
    do {
      f = ((volatile int*)flags)[b];
    } while (f == 0);
    off += f & 0x7fffffff;
  }
  if (off) atomicAdd(&s_off, off);
  __syncthreads();
  if (r <= R) start[r] = s_off + before;
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0)
    longs[0] = atomicAdd(counter, 0);  // every block has listed its rows
}

// Places chunk blockIdx.x's positions: each at its row's start (from
// group_colscan_kernel) + the row's positions in the earlier
// chunks (hist) + in the earlier warps of this chunk + the equal ids of
// the lower lanes of its warp, so equal ids keep their flattened order.
// The ids and these gathers are issued at the start (the ids kept in
// registers for both passes where a warp's part is kBatch slabs).  The
// counts a (warp, row) are 16-bit, two to a 32-bit word (R rounded up to
// even), added by shared atomics; the rank among the lower lanes is a
// popcount of the __match_any_sync group.
template <typename I>
__global__ void __launch_bounds__(kThreads)
group_place_kernel(const I* __restrict__ ids, int n, int rows, int slots,
                   int R, const int* __restrict__ hist,
                   const int* __restrict__ start, int* __restrict__ pos_e) {
  extern __shared__ int4 smem4[];
  const int Rp = (R + 1) & ~1;
  unsigned short* cnt = (unsigned short*)smem4;      // [kWarps][Rp]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = chunk_size(n) / kWarps;
  const int lo = blockIdx.x * chunk_size(n) + warp * per;
  const int hi = min(lo + per, n);
  const bool once = per <= 32 * kBatch;  // the ids stay in registers
  const int* hc = hist + (long long)blockIdx.x * R;
  int key[kBatch], e[kBatch], at[kBatch];
  auto gather = [&]() {  // each position's first place in this chunk
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int r = key[k] >= 0 ? key[k] : 0;
      at[k] = __ldg(start + r) + __ldg(hc + r);
    }
  };
#pragma unroll
  for (int k = 0; k < kBatch; ++k) key[k] = -1;
  Walk walk(lo + lane, rows);
  if (lo < hi) load_keys(ids, lo, hi, rows, slots, R, lane, walk, key, e);
  if (once) gather();
  // kWarps * Rp 16-bit counts are 16 * Rp bytes: Rp int4 stores
  for (int i = threadIdx.x; i < Rp; i += kThreads)
    smem4[i] = make_int4(0, 0, 0, 0);
  __syncthreads();

  // 1. each warp counts its part of the chunk, a count a row
  unsigned short* mine = cnt + warp * Rp;
  unsigned* words = (unsigned*)mine;  // warp * Rp is even
  for (int f0 = lo; f0 < hi; f0 += 32 * kBatch) {  // warp-uniform
    if (f0 != lo) load_keys(ids, f0, hi, rows, slots, R, lane, walk, key, e);
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (key[k] >= 0)
        atomicAdd(words + (key[k] >> 1), 1u << ((key[k] & 1) * 16));
  }
  __syncthreads();

  // 2. each warp's positions of a row before its own in this chunk, two
  // rows a 32-bit word (a half's sum stays below 2^16: no carry)
  unsigned* pairs = (unsigned*)cnt;
  const int Rw = Rp / 2;
  for (int r = threadIdx.x; r < Rw; r += kThreads) {
    unsigned sum_w = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const unsigned t = pairs[w * Rw + r];
      pairs[w * Rw + r] = sum_w;
      sum_w += t;
    }
  }
  __syncthreads();

  // 3. place, the same positions in the same order
  const unsigned below = (1u << lane) - 1u;
  walk = Walk(lo + lane, rows);
  for (int f0 = lo; f0 < hi; f0 += 32 * kBatch) {  // warp-uniform
    if (!once) {
      load_keys(ids, f0, hi, rows, slots, R, lane, walk, key, e);
      gather();
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const unsigned peers = __match_any_sync(kAll, key[k]);
      const int r = key[k] >= 0 ? key[k] : 0;
      const int dest = at[k] + mine[r] + __popc(peers & below);
      __syncwarp();
      if (key[k] >= 0) {
        if (lane == __ffs(peers) - 1) mine[r] += (unsigned short)__popc(peers);
        pos_e[dest] = e[k];
      }
      __syncwarp();
    }
  }
}

// The caller's grouping (keys sorted ascending, stably: perm the
// flattened position of each): each sorted position's row of g and row
// (out of range: -1 or R), and each row's start and end, written where
// its run begins and ends.  Position 0 also zeroes the count of long runs.
template <typename K>
__global__ void __launch_bounds__(kThreads)
group_csr_kernel(const K* __restrict__ keys,
                 const long long* __restrict__ perm, int n, int rows,
                 int slots, int R, int* __restrict__ start,
                 int* __restrict__ end, int* __restrict__ longs,
                 int* __restrict__ pos_e, int* __restrict__ row_of) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= n) return;
  auto row = [&](int q) {
    const long long k = (long long)__ldg(keys + q);
    return k < 0 ? -1 : k >= R ? R : (int)k;
  };
  const int k = row(p);
  if (k >= 0 && k < R) {
    if (p == 0 || row(p - 1) != k) start[k] = p;
    if (p == n - 1 || row(p + 1) != k) end[k] = p + 1;
  }
  row_of[p] = k;
  const long long f = __ldg(perm + p);
  pos_e[p] = slots == 1 ? (int)f : (int)((f % rows) * slots + f / rows);
  if (p == 0) longs[0] = 0;
}

// the rows of runs longer than kLongRun, listed by the position that
// begins each
__global__ void __launch_bounds__(kThreads)
group_longs_kernel(const int* __restrict__ row_of, int n, int R,
                   int* __restrict__ longs) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= n) return;
  const int k = row_of[p];
  if (k < 0 || k >= R || (p > 0 && row_of[p - 1] == k)) return;
  if (p + kLongRun < n && row_of[p + kLongRun] == k)
    longs[1 + atomicAdd(longs, 1)] = k;
}

// ----------------------------------------------------------------- adds

// CPL consecutive columns of one row of g, loaded as one word (8 or 16
// bytes for four, 4 or 8 for two) and read back as f32 (a bf16 value's
// bits shifted up: exact)
template <typename T, int CPL>
struct Cols;
template <>
struct Cols<float, 1> {
  float v;
  __device__ __forceinline__ void load(const float* p) { v = __ldg(p); }
  __device__ __forceinline__ float get(int) const { return v; }
};
template <>
struct Cols<float, 2> {
  float2 v;
  __device__ __forceinline__ void load(const float* p) {
    v = __ldg((const float2*)p);
  }
  __device__ __forceinline__ float get(int c) const { return c ? v.y : v.x; }
};
template <>
struct Cols<float, 4> {
  float4 v;
  __device__ __forceinline__ void load(const float* p) {
    v = __ldg((const float4*)p);
  }
  __device__ __forceinline__ float get(int c) const {
    return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
  }
};
__device__ __forceinline__ float bf16_bits(unsigned w, int hi) {
  return __uint_as_float(hi ? w & 0xffff0000u : w << 16);
}
template <>
struct Cols<__nv_bfloat16, 1> {
  unsigned short v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    v = __ldg((const unsigned short*)p);
  }
  __device__ __forceinline__ float get(int) const {
    return bf16_bits(v, 0);
  }
};
template <>
struct Cols<__nv_bfloat16, 2> {
  unsigned v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    v = __ldg((const unsigned*)p);
  }
  __device__ __forceinline__ float get(int c) const {
    return bf16_bits(v, c);
  }
};
template <>
struct Cols<__nv_bfloat16, 4> {
  uint2 v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    v = __ldg((const uint2*)p);
  }
  __device__ __forceinline__ float get(int c) const {
    return bf16_bits(c < 2 ? v.x : v.y, c & 1);
  }
};

// lane's g row of sorted position p + lane, or row 0 (valid, never
// added) past the run's end s1; pos in global (read-only) or shared memory
template <bool kShared = false>
__device__ __forceinline__ int run_row(const int* __restrict__ pos, int p,
                                       int s1, int lane) {
  if (p + lane >= s1) return 0;
  return kShared ? pos[p + lane] : __ldg(pos + p + lane);
}

// The ring of stages in shared memory: slot s, lane (column) l, its
// kStage positions contiguous (read and written 16 bytes at a time; rows
// of kRingRow floats keep a quarter-warp's 16-byte accesses on distinct
// banks)
constexpr int kRingRow = kStage + 4;
typedef float (*Ring)[32][kRingRow];

// One run (positions s0 .. s1 - 1 of pos, each a row of g) summed in order
// into 32 columns from col0 by the whole block, written to out (a row of
// the table).  Warp 0 adds (lane c column col0 + c), stage by stage from
// the ring; producer warp p fills slot p with stages p, p + kSlots, ...:
// it issues the loads of its next stage, then rounds the current one,
// waits for its slot to be free, stores it and signals it full.  The
// consumer issues the next stage's shared loads before this stage's chain
// of adds, which is all that then waits.  Barrier 1 + s: slot s is full;
// 1 + kSlots + s: slot s is free again (each between the consumer and
// that slot's producer: 64 threads).
template <typename T, int kMode, bool kShared>
__device__ __forceinline__ void add_run(const int* __restrict__ pos, int s0,
                                        int s1, const T* __restrict__ g,
                                        int D, int col0, Ring ring,
                                        float* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = col0 + lane;
  const int len = s1 - s0, nst = (len + kStage - 1) / kStage;
  if (warp == 0) {
    // two stages in registers, in turn: the next one's shared loads are
    // issued before this one's chain of adds, which is all that waits
    float acc = 0.f;
    float4 v[kStage / 4], w[kStage / 4];
    auto fetch = [&](int st, float4 (&x)[kStage / 4]) {
      const int slot = st % kSlots;
      bar_sync(1 + slot, 64);
#pragma unroll
      for (int q = 0; q < kStage / 4; ++q)
        x[q] = *(const float4*)&ring[slot][lane][4 * q];
    };
    auto chain = [&](int st, const float4 (&x)[kStage / 4]) {
      const int m = len - st * kStage;
      if (m >= kStage) {  // a full stage: the chain of adds alone
#pragma unroll
        for (int q = 0; q < kStage / 4; ++q) {
          acc += x[q].x;
          acc += x[q].y;
          acc += x[q].z;
          acc += x[q].w;
        }
      } else {
#pragma unroll
        for (int q = 0; q < kStage / 4; ++q) {
          acc = 4 * q < m ? acc + x[q].x : acc;
          acc = 4 * q + 1 < m ? acc + x[q].y : acc;
          acc = 4 * q + 2 < m ? acc + x[q].z : acc;
          acc = 4 * q + 3 < m ? acc + x[q].w : acc;
        }
      }
      if (st + kSlots < nst) bar_arrive(1 + kSlots + st % kSlots, 64);
    };
    if (nst > 0) fetch(0, v);
    for (int st = 0; st < nst; st += 2) {
      if (st + 1 < nst) fetch(st + 1, w);
      chain(st, v);
      if (st + 1 < nst) {
        if (st + 2 < nst) fetch(st + 2, v);
        chain(st + 1, w);
      }
    }
    if (col < D) out[col] = acc;
  } else if (warp <= kSlots) {
    const int p = warp - 1;
    const T* gc = g + (col < D ? col : 0);  // dead columns read column 0
    float v[kStage], w[kStage];
    auto fetch = [&](int st, float (&x)[kStage]) {
      const int e = run_row<kShared>(pos, s0 + st * kStage, s1, lane);
#pragma unroll
      for (int j = 0; j < kStage; ++j)
        x[j] = load(gc + (long long)__shfl_sync(kAll, e, j) * D);
    };
    if (p < nst) fetch(p, v);
    for (int st = p; st < nst; st += kSlots) {
      if (st + kSlots < nst) fetch(st + kSlots, w);
#pragma unroll
      for (int j = 0; j < kStage; ++j) v[j] = rounded<kMode>(v[j]);
      if (st >= kSlots) bar_sync(1 + kSlots + p, 64);
#pragma unroll
      for (int q = 0; q < kStage / 4; ++q)  // this lane's row of the slot
        *(float4*)&ring[p][lane][4 * q] =
            make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
      bar_arrive(1 + p, 64);
#pragma unroll
      for (int j = 0; j < kStage; ++j) v[j] = w[j];
    }
  }
}

// Where each row's run lies among the sorted positions: from start[row]
// to end[row] (the counting route's CSR: end = start + 1), where validate
// (the caller's grouping) a row that no id names holds garbage, which
// row_of at its start shows
struct Runs {
  const int *start, *end, *longs, *pos_e, *row_of;
  int validate, long_blocks;
  __device__ __forceinline__ void of(int row, int n, int& s0, int& s1) const {
    s0 = __ldg(start + row);
    s1 = __ldg(end + row);
    if (validate && !(s0 >= 0 && s0 < n && __ldg(row_of + s0) == row))
      s1 = s0;  // no id names this row
  }
};

// Long runs of the CSR routes: the block takes (row, 32 columns) items
// from the list of long rows.
template <typename T, int kMode>
__device__ __forceinline__ void long_rows(const Runs& q, int n,
                                          const T* __restrict__ g, int D,
                                          Ring ring,
                                          float* __restrict__ out) {
  const int ncg = (D + 31) / 32;
  const long long items = (long long)__ldg(q.longs) * ncg;
  for (long long it = blockIdx.x; it < items; it += q.long_blocks) {
    const int row = __ldg(q.longs + 1 + it / ncg);
    int s0, s1;
    q.of(row, n, s0, s1);
    add_run<T, kMode, false>(q.pos_e, s0, s1, g, D, (int)(it % ncg) * 32,
                             ring, out + (long long)row * D);
    __syncthreads();
  }
}

// The small tables' route (up to kSmallRows rows, n up to kSmallN): one
// kernel, a block a (row, 32 columns).  The block first lists its row's
// positions in flattened order in shared memory, an ordered compaction:
// each warp a contiguous part of up to kSlabs slabs of 32, its ids loaded
// 32 slabs at a time, a ballot a slab; each slab's place is its warp's
// start plus a scan of the slabs' counts (lane j holds slab j mod 32's
// ballot and place), each position's the popcount of the lower lanes.
// Then the block sums the list as add_run does.  This one pass
// over the ids is the whole grouping.
template <typename I, typename T, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
scatter_small_kernel(const I* __restrict__ ids, int n, int rows, int slots,
                     const T* __restrict__ g, int D,
                     float* __restrict__ out) {
  constexpr int kSlabs = kSmallN / kThreads;  // a warp's slabs at most
  constexpr int kRegs = kSlabs / 32;
  extern __shared__ int list[];  // [n]: the row's g rows, in order
  __shared__ __align__(16) float ring[kSlots][32][kRingRow];
  __shared__ unsigned s_ballot[kWarps][kSlabs];
  __shared__ int s_cnt[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ncg = (D + 31) / 32;
  const int row = blockIdx.x / ncg, col0 = (blockIdx.x % ncg) * 32;
  const int per = (n + kThreads - 1) / kThreads * 32;
  const int lo = min(warp * per, n), hi = min(lo + per, n);
  Walk walk(lo + lane, rows);
  for (int j0 = 0; lo + 32 * j0 < hi; j0 += 32) {  // warp-uniform
    I raw[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      raw[k] = __ldg(ids + (lo + 32 * (j0 + k) + lane < hi ? walk.row(slots)
                                                           : 0));
      walk.step(rows);
    }
    unsigned mine = 0;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const unsigned b = __ballot_sync(
          kAll, lo + 32 * (j0 + k) + lane < hi && raw[k] == (I)row);
      mine = lane == k ? b : mine;
    }
    s_ballot[warp][j0 + lane] = mine;  // lane k: slab j0 + k's ballot
  }
  __syncwarp();
  // each slab's count, scanned: lane l holds slabs l, l + 32, ...
  const int nslab = (hi - lo + 31) / 32;
  unsigned bal[kRegs];
  int at[kRegs], total = 0;
#pragma unroll
  for (int i = 0; i < kRegs; ++i) {
    bal[i] = 32 * i + lane < nslab ? s_ballot[warp][32 * i + lane] : 0u;
    const int c = __popc(bal[i]);
    int inc = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kAll, inc, o);
      if (lane >= o) inc += y;
    }
    at[i] = total + inc - c;  // the slab's place in the warp's list
    total += __shfl_sync(kAll, inc, 31);
  }
  if (lane == 0) s_cnt[warp] = total;
  __syncthreads();
  int base = 0, len = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    base += w < warp ? s_cnt[w] : 0;
    len += s_cnt[w];
  }
  const unsigned below = (1u << lane) - 1u;
  walk = Walk(lo + lane, rows);
#pragma unroll
  for (int i = 0; i < kRegs; ++i) {
    for (int jj = 0; jj < 32 && 32 * i + jj < nslab; ++jj) {
      const unsigned b = __shfl_sync(kAll, bal[i], jj);
      const int p = base + __shfl_sync(kAll, at[i], jj);
      if ((b >> lane) & 1u) list[p + __popc(b & below)] = walk.row(slots);
      walk.step(rows);
    }
  }
  __syncthreads();
  add_run<T, kMode, true>(list, 0, len, g, D, col0, ring,
                          out + (long long)row * D);
}

// acc[c] += rounded(v[j][c]) for the first m of B positions (lane j holds
// position j's g row e), in order: B loads in flight before the first
// add; the roundings, independent of one another, come first and with no
// branch among them; each add is kept or dropped by a select (not an add
// of 0.f: -0.f + 0.f is +0.f)
template <typename T, int kMode, int CPL, int B>
__device__ __forceinline__ void add_batch(const T* __restrict__ gc, int D,
                                          int e, int m, float (&acc)[CPL]) {
  Cols<T, CPL> x[B];
#pragma unroll
  for (int j = 0; j < B; ++j)
    x[j].load(gc + (long long)__shfl_sync(kAll, e, j) * D);
#pragma unroll
  for (int j = 0; j < B; ++j) {
    float r[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) r[c] = rounded<kMode>(x[j].get(c));
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[c] = j < m ? acc[c] + r[c] : acc[c];
  }
}

// Blocks [0, long_blocks): long runs.  After them a warp a (row, 32 * CPL
// columns); lane l owns the CPL consecutive columns from CPL * l, read as
// one word.  The warp takes PB positions of its run at a time (lane j
// holds the g row of position j), all PB loads in flight before the first
// add, the next PB positions' g rows fetched meanwhile.  validate:
// start/end come from group_csr_kernel, where a row that no id names
// holds garbage.
template <typename T, int kMode, int CPL>
__global__ void __launch_bounds__(kThreads, 2)
scatter_rows_kernel(const Runs q, const T* __restrict__ g, int n, int D,
                    int R, int ngroups, float* __restrict__ out) {
  __shared__ __align__(16) float ring[kSlots][32][kRingRow];
  if ((int)blockIdx.x < q.long_blocks) {
    long_rows<T, kMode>(q, n, g, D, ring, out);
    return;
  }
  // positions a batch: 64 registers of raw values at most
  constexpr int PB = sizeof(T) * CPL > 8 ? 16 : 32;
  const int lane = threadIdx.x & 31;
  const long long w =
      (long long)(blockIdx.x - q.long_blocks) * kWarps + (threadIdx.x >> 5);
  if (w >= (long long)R * ngroups) return;  // warp-uniform
  const int row = (int)(w / ngroups);
  const int col = (int)(w % ngroups) * 32 * CPL + CPL * lane;
  int s0, s1;
  q.of(row, n, s0, s1);
  if (s1 - s0 > kLongRun) return;  // a long run: long_rows writes the row
  const T* gc = g + (col < D ? col : 0);  // dead columns read column 0
  float acc[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) acc[c] = 0.f;
  int e = run_row(q.pos_e, s0, s1, lane);
  if (s1 == s0) {
    // no loads: g may hold no row at all
  } else if (s1 - s0 <= 8) {  // most rows of the user and item tables
    add_batch<T, kMode, CPL, 8>(gc, D, e, s1 - s0, acc);
  } else {
    for (int p = s0; p < s1; p += PB) {  // warp-uniform
      const int m = min(PB, s1 - p);
      const int now = e;
      e = run_row(q.pos_e, p + PB, s1, lane);
      add_batch<T, kMode, CPL, PB>(gc, D, now, m, acc);
    }
  }
  if (col < D) {
    float* o = out + (long long)row * D + col;
#pragma unroll
    for (int c = 0; c < CPL; ++c) o[c] = acc[c];
  }
}

// ------------------------------------------------------------- launches

template <typename T, int kMode, int CPL>
cudaError_t launch_rows(const Runs& q, const void* g, int n, int D, int R,
                        float* out, cudaStream_t s) {
  const int ngroups = (D + 32 * CPL - 1) / (32 * CPL);
  const long long warps = (long long)R * ngroups;
  const long long grid = q.long_blocks + (warps + kWarps - 1) / kWarps;
  scatter_rows_kernel<T, kMode, CPL><<<(unsigned)grid, kThreads, 0, s>>>(
      q, (const T*)g, n, D, R, ngroups, out);
  return cudaGetLastError();
}

template <typename T, int CPL>
cudaError_t launch_mode(const Runs& q, const void* g, int n, int D, int R,
                        int mode, float* out, cudaStream_t s) {
  if (mode == 0) return launch_rows<T, 0, CPL>(q, g, n, D, R, out, s);
  if (mode == 1) return launch_rows<T, 1, CPL>(q, g, n, D, R, out, s);
  return launch_rows<T, 2, CPL>(q, g, n, D, R, out, s);
}

// columns a lane, read as one word: four where the rows are wider than 64
// values, two where wider than 32, where D and g's address allow
template <typename T>
cudaError_t launch_adds(const Runs& q, const void* g, int n, int D, int R,
                        int mode, float* out, cudaStream_t s) {
  const unsigned long long a = (unsigned long long)g;
  if (D > 64 && D % 4 == 0 && a % (4 * sizeof(T)) == 0)
    return launch_mode<T, 4>(q, g, n, D, R, mode, out, s);
  if (D > 32 && D % 2 == 0 && a % (2 * sizeof(T)) == 0)
    return launch_mode<T, 2>(q, g, n, D, R, mode, out, s);
  return launch_mode<T, 1>(q, g, n, D, R, mode, out, s);
}

template <typename I, typename T, int kMode>
cudaError_t launch_small_mode(const I* ids, int n, int rows, int slots,
                              const void* g, int D, int R, float* out,
                              cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      (const void*)scatter_small_kernel<I, T, kMode>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, 4 * kSmallN);
  if (attr != cudaSuccess) return attr;
  const int grid = R * ((D + 31) / 32);
  scatter_small_kernel<I, T, kMode><<<grid, kThreads, 4 * n, s>>>(
      ids, n, rows, slots, (const T*)g, D, out);
  return cudaGetLastError();
}

template <typename I, typename T>
cudaError_t launch_small(const I* ids, int n, int rows, int slots,
                         const void* g, int D, int R, int mode, float* out,
                         cudaStream_t s) {
  if (mode == 0)
    return launch_small_mode<I, T, 0>(ids, n, rows, slots, g, D, R, out, s);
  if (mode == 1)
    return launch_small_mode<I, T, 1>(ids, n, rows, slots, g, D, R, out, s);
  return launch_small_mode<I, T, 2>(ids, n, rows, slots, g, D, R, out, s);
}

bool small_route(int n, int R) { return R <= kSmallRows && n <= kSmallN; }

template <typename I>
cudaError_t launch_count(const I* ids, int n, int rows, int slots, int R,
                         int* hist, int* start, int* flags, int* longs,
                         int* pos_e, cudaStream_t s) {
  const int nchunks = num_chunks(n);
  // kWarps 16-bit counts a row (rows rounded up to even)
  const int place_smem = 16 * ((R + 1) & ~1);
  static const cudaError_t attr = cudaFuncSetAttribute(
      (const void*)group_place_kernel<I>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, 16 * (kCountRowLimit + 1));
  if (attr != cudaSuccess) return attr;
  group_hist_kernel<I><<<nchunks, kThreads, 4 * R, s>>>(ids, n, rows, slots,
                                                        R, hist, flags);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  group_colscan_kernel<<<R / kThreads + 1, kThreads, 0, s>>>(
      hist, nchunks, R, start, flags, flags + R / kThreads + 1, longs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  group_place_kernel<I><<<nchunks, kThreads, place_smem, s>>>(
      ids, n, rows, slots, R, hist, start, pos_e);
  return cudaGetLastError();
}

template <typename K>
cudaError_t launch_sorted(const K* keys, const long long* perm, int n,
                          int rows, int slots, int R, int* start, int* end,
                          int* longs, int* pos_e, int* row_of, bool lists,
                          cudaStream_t s) {
  if (n == 0) return cudaSuccess;
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  group_csr_kernel<K><<<grid, kThreads, 0, s>>>(keys, perm, n, rows, slots,
                                                R, start, end, longs, pos_e,
                                                row_of);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !lists) return err;
  group_longs_kernel<<<grid, kThreads, 0, s>>>(row_of, n, R, longs);
  return cudaGetLastError();
}

long long max_long_rows(int n, int R) {
  const long long m = n / (kLongRun + 1);
  return m < R ? m : R;
}

// int32 scratch entries a call needs (ops/scatter.py::scratch_ints): the
// counting route's chunk counts, CSR, colscan's flags and counter, the
// list of long rows and each sorted position's g row; the caller's
// grouping's starts, ends, list, g rows and rows
long long scratch_need(int n, int R, bool counting) {
  if (counting && small_route(n, R)) return 0;
  const long long lists = 1 + max_long_rows(n, R) + n;
  if (counting)
    return (long long)num_chunks(n) * R + (R + 1) + (R / kThreads + 2) +
           lists;
  return 2LL * R + lists + n;
}

}  // namespace

extern "C" {

// ids: [rows, slots] (flattened slot-major) or [n] (slots 1), int32 or
// int64 (id_bytes 4 or 8).  keys == NULL: the counting route (num_rows up
// to kCountRowLimit, n up to kMaxChunks * kMaxChunk).  Else the caller's
// grouping: keys (key_bytes 4 or 8), the flattened ids sorted ascending,
// stably, and perm (int64) the flattened position of each (a position f
// reads g row f when slots == 1, else (f % rows) * slots + f / rows); ids
// is then not read.  g: [n, D] of dtype 0 = float32, 1 = bfloat16; mode: 0
// split, 1 bf16, 2 f32; scratch: int32, at least scratch_need entries;
// out: f32 [num_rows, D], every element written.  Returns a cudaError_t (0
// on success); errors during the run surface at the caller's next
// synchronisation.
int ncf_scatter_add(const void* ids, int id_bytes, int rows, int slots,
                    const void* keys, int key_bytes, const long long* perm,
                    const void* g, int dtype, int D, int num_rows, int mode,
                    int* scratch, long long scratch_ints, float* out,
                    void* stream) {
  const long long n64 = (long long)rows * slots;
  const bool counting = keys == nullptr;
  if (rows < 0 || slots <= 0 || n64 >= 0x7fffffffLL || D <= 0 ||
      num_rows <= 0 || num_rows >= 0x7fffffff || (dtype != 0 && dtype != 1) ||
      mode < 0 || mode > 2 ||
      (counting && (num_rows > kCountRowLimit ||
                    n64 > (long long)kMaxChunks * kMaxChunk ||
                    (id_bytes != 4 && id_bytes != 8))) ||
      (!counting && ((key_bytes != 4 && key_bytes != 8) || !perm)) ||
      scratch_ints < scratch_need((int)n64, num_rows, counting))
    return (int)cudaErrorInvalidValue;
  const int n = (int)n64, R = num_rows;
  cudaStream_t s = (cudaStream_t)stream;
  if (counting && small_route(n, R)) {
    if (id_bytes == 4)
      return (int)(dtype == 0
                       ? launch_small<int, float>((const int*)ids, n, rows,
                                                  slots, g, D, R, mode, out, s)
                       : launch_small<int, __nv_bfloat16>(
                             (const int*)ids, n, rows, slots, g, D, R, mode,
                             out, s));
    return (int)(dtype == 0
                     ? launch_small<long long, float>(
                           (const long long*)ids, n, rows, slots, g, D, R,
                           mode, out, s)
                     : launch_small<long long, __nv_bfloat16>(
                           (const long long*)ids, n, rows, slots, g, D, R,
                           mode, out, s));
  }
  const long long max_long = max_long_rows(n, R);
  Runs q{};
  cudaError_t err;
  if (counting) {
    int* hist = scratch;
    int* start = hist + (long long)num_chunks(n) * R;  // R + 1: the CSR
    int* flags = start + R + 1;                        // R / kThreads + 2
    int* longs = flags + R / kThreads + 2;
    int* pos_e = longs + 1 + max_long;
    q.start = start;
    q.end = start + 1;
    q.longs = longs;
    q.pos_e = pos_e;
    err = id_bytes == 4
              ? launch_count((const int*)ids, n, rows, slots, R, hist, start,
                             flags, longs, pos_e, s)
              : launch_count((const long long*)ids, n, rows, slots, R, hist,
                             start, flags, longs, pos_e, s);
  } else {
    int* start = scratch;
    int* end = start + R;
    int* longs = end + R;
    int* pos_e = longs + 1 + max_long;
    q.start = start;
    q.end = end;
    q.longs = longs;
    q.pos_e = pos_e;
    q.row_of = pos_e + n;
    q.validate = 1;
    err = key_bytes == 4
              ? launch_sorted((const int*)keys, perm, n, rows, slots, R,
                              start, end, longs, pos_e, pos_e + n,
                              max_long > 0, s)
              : launch_sorted((const long long*)keys, perm, n, rows, slots,
                              R, start, end, longs, pos_e, pos_e + n,
                              max_long > 0, s);
  }
  if (err != cudaSuccess) return (int)err;
  const long long lb = max_long * ((D + 31) / 32);
  q.long_blocks = (int)(lb < kLongBlocks ? lb : kLongBlocks);
  return (int)(dtype == 0
                   ? launch_adds<float>(q, g, n, D, R, mode, out, s)
                   : launch_adds<__nv_bfloat16>(q, g, n, D, R, mode, out, s));
}

const char* ncf_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
