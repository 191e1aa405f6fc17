// SpTRSV level kernels for Hopper (sm_90a): the level-scheduled solve over
// ELL slabs in the permuted packed layout, one launch per segment; and, at
// the end of the file, the scatter layout's step (one wavefront in original
// row order, then its row scatter).
//
// Replaces the TPU kernels `level_kernel` / `level_solve_blocks` and
// `level_kernel_batched` / `level_solve_blocks_batched` of the JAX package
// (src/repro/kernels/sptrsv_level/lowering_tpu.py).  Per wavefront (step)
// with write offset o, ELL width K and padded row count Rp:
//
//     x[o + r, j] = (bhat[o + r, j] - sum_k vals[k, r] * x[cols[k, r], j]) / diag[r]
//
// for r < Rp and every RHS column j < m.  A segment of the step table is a
// plain wavefront, or a coarsened chain of `depth` sub-steps whose slabs
// follow each other in the flat buffers, sub-step t at write offset
// sub_offs[sub_off + t]; sub-step t reads what sub-steps < t wrote.
//
// Design:
//   * one launch per segment.  A plain segment spreads its rows over as
//     many blocks as it needs.  A chain runs on one block of up to 1,024
//     threads that walks its sub-steps in order with __syncthreads()
//     between them: the block's own global writes are visible to it after
//     the barrier, so a chain needs no grid barrier.  Chains are thin by
//     construction (lung2: R_pad = 128 on every chain), and the threads
//     stride over a sub-step's R_pad x m items, so any R_pad and m run.
//     Where a sub-step has more items than 1,024 threads (R_pad x m =
//     4,096 at m = 32), one SM's loads bound it, so the chain runs on a
//     thread-block cluster of up to 8 blocks, one per SM, with a cluster
//     barrier (release / acquire) between sub-steps and x read from L2.
//     Only the x gathers depend on the sub-steps before: a narrow chain's
//     thread loads its next item's row length, first kPrefetch slots,
//     bhat and diag before the barrier, so after it only the gathers,
//     the sums and the store remain;
//   * row lengths: a row's real entries come first in its K slots (the
//     host checks it when it packs them), and `row_len`, indexed like
//     diag, holds their count.  A row's loop stops after its length plus
//     one slot: the pads (val 0) of a row share one column, so that one
//     slot adds the plain version's 0 * x[c] once, and a non-finite x[c]
//     gives its NaN too;
//   * narrow steps (K <= kWideK): one thread per (row, RHS column); the m
//     columns of a row sit on neighbouring threads, so each gathered x row
//     is read coalesced; four slots of a row in flight at a time;
//   * wide steps (K > kWideK; the lung2 transpose has 40 steps whose
//     longest row holds 1,795 to 1,975 slots, most other rows short): W
//     warps per row and group of up to 32 RHS columns.  Each warp's lanes
//     form entry groups of cw column lanes (cw = 1 at m = 1, 8 from m =
//     8), and the row's W * 32 / cw groups take its slots in turn, four at
//     a time, each lane keeping up to four column sums; a warp adds its
//     groups' sums with __shfl_xor_sync, the W warps through shared
//     memory, then one divide by diag.  The host picks W (a power of two
//     up to 32) so that a row of K slots needs at most two rounds of four
//     per group: the step waits for its longest row.  On a chain, one warp
//     per row;
//   * the kernel reads bhat and writes x in place at the step's offset
//     (the TPU kernel returned the slab and XLA stored it); a step reads
//     only positions < o, which earlier steps wrote.  A read at a position
//     >= o can only be a pad, and it may race with this step's own writes,
//     so it is skipped: where the plain version adds 0 * (old value), the
//     kernel adds nothing.  The two differ only when that old value is
//     non-finite (see ROADMAP C-ref 2);
//   * sums in the value dtype; nvcc contracts them to FMA, and the warp
//     variant adds in another order, so bits may differ from the plain
//     torch version by rounding.
//
// Bound: each wavefront moves a few KB (nnz ~ 4.3 per row), so a launch is
// bound by launch latency and by the dependent load chain cols -> x, not
// by bytes or FLOPs; a chain by its sub-steps' load chains back to back.
// A lung2 solve (493 wavefronts) takes 493 launches uncoarsened, 58
// forward and 339 transpose coarsened; its byte bound is a few
// microseconds.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;        // a plain segment's blocks
constexpr int kChainThreads = 1024;  // most threads of a chain's one block
constexpr int kWideK = 32;           // wider steps run warps per row
constexpr int kAcc = 4;              // column sums of a lane (wide steps)
constexpr int kUnroll = 4;           // slots of a row in flight
constexpr int kMaxCluster = 8;       // most blocks of a chain's cluster
constexpr int kPrefetch = 4;         // slots a chain thread loads a sub-step ahead
constexpr int kWideThreads = 1024;   // most threads of a wide step's block
constexpr int kGeo = 7;              // table columns

// Column lanes of an entry group on a wide step, and the column groups
// (a warp each) of one row.
__host__ __device__ inline int col_lanes(int m) {
  return m >= 8 ? 8 : m >= 4 ? 4 : m >= 2 ? 2 : 1;
}
__host__ __device__ inline int col_groups(int m) {
  const int c = col_lanes(m) * kAcc;
  return (m + c - 1) / c;
}

// Warps per row of a wide plain step: enough entry groups that K slots
// take at most two rounds of kUnroll each (a power of two, at most 32).
inline int warps_per_row(int K, int m) {
  const int groups = 32 / col_lanes(m);
  int W = 1;
  while (W < 32 && W * groups * 2 * kUnroll < K) W *= 2;
  return W;
}

template <typename T>
struct Walk {
  T* x;              // (n_x, m), written in place
  const T* bhat;     // (n_b, m)
  long long ldx, ldb;
  int m;
};

// One step: a plain segment, or one sub-step of a chain.
template <typename T>
struct Step {
  long long o;
  const int* cols;   // (K, Rp)
  const T* vals;     // (K, Rp)
  const T* diag;     // (Rp,)
  const int* len;    // (Rp,) row lengths
  int K, Rp;
};

// x[p] for a step: through L2 where other SMs of a cluster wrote it.
template <bool kL2, typename T>
__device__ __forceinline__ T load_x(const T* p) {
  if constexpr (kL2) return __ldcg(p);
  return *p;
}

// Thread per (row r, column j).
template <typename T, bool kL2>
__device__ __forceinline__ void thread_row(const Walk<T>& w, const Step<T>& s,
                                           int r, int j) {
  const int n = __ldg(s.len + r);
  const int kend = n < s.K ? n + 1 : n;
  T acc = __ldg(w.bhat + (s.o + r) * w.ldb + j);
  for (int k0 = 0; k0 < kend; k0 += kUnroll) {
    long long c[kUnroll];
    T v[kUnroll], xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long e = static_cast<long long>(k0 + u) * s.Rp + r;
      const bool in = k0 + u < kend;
      c[u] = in ? __ldg(s.cols + e) : s.o;
      v[u] = in ? __ldg(s.vals + e) : T(0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      xv[u] = c[u] < s.o ? load_x<kL2>(w.x + c[u] * w.ldx + j) : T(0);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (c[u] < s.o) acc -= v[u] * xv[u];
  }
  w.x[(s.o + r) * w.ldx + j] = acc / __ldg(s.diag + r);
}

// A lane's sums of row r over slots k = g0, g0 + gs, ... (kUnroll at a
// time) for columns j0 + cl + a * cw, a < NA; then added over the warp's
// entry groups, so every lane of a group holds its columns' warp sums.
template <typename T, int NA, bool kL2>
__device__ __forceinline__ void row_sums(const Walk<T>& w, const Step<T>& s,
                                         int r, int j0, int cl, int cw,
                                         int g0, int gs, T (&acc)[NA]) {
  const int n = __ldg(s.len + r);
  const int kend = n < s.K ? n + 1 : n;
#pragma unroll
  for (int a = 0; a < NA; ++a) acc[a] = T(0);
  for (int k0 = g0; k0 < kend; k0 += kUnroll * gs) {
    long long c[kUnroll];
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + u * gs;
      const long long e = static_cast<long long>(k) * s.Rp + r;
      c[u] = k < kend ? __ldg(s.cols + e) : s.o;
      v[u] = k < kend ? __ldg(s.vals + e) : T(0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (c[u] < s.o) {
        const T* xc = w.x + c[u] * w.ldx + j0 + cl;
#pragma unroll
        for (int a = 0; a < NA; ++a)
          if (j0 + cl + a * cw < w.m) acc[a] += v[u] * load_x<kL2>(xc + a * cw);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < NA; ++a)
    for (int d = cw; d < 32; d *= 2) acc[a] += __shfl_xor_sync(0xffffffffu, acc[a], d);
}

// x[o + r, j0 + cl + a * cw] from the row's sums.
template <typename T, int NA>
__device__ __forceinline__ void finish_row(const Walk<T>& w, const Step<T>& s,
                                           int r, int j0, int cl, int cw,
                                           const T (&acc)[NA]) {
  const T dv = __ldg(s.diag + r);
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    const int j = j0 + cl + a * cw;
    if (j < w.m)
      w.x[(s.o + r) * w.ldx + j] = (__ldg(w.bhat + (s.o + r) * w.ldb + j) - acc[a]) / dv;
  }
}

// Warp per (row r, columns from j0); every lane of the warp calls it.
template <typename T, int NA, bool kL2>
__device__ __forceinline__ void warp_row(const Walk<T>& w, const Step<T>& s,
                                         int r, int j0, int lane) {
  const int cw = col_lanes(w.m);
  const int g = lane / cw;
  T acc[NA];
  row_sums<T, NA, kL2>(w, s, r, j0, lane - g * cw, cw, g, 32 / cw, acc);
  if (g == 0) finish_row<T, NA>(w, s, r, j0, lane, cw, acc);
}

// Item i of a step: a (row, column) thread, or a (row, column group) warp.
template <typename T, bool kBatched, bool kWide>
__device__ __forceinline__ long long items_of(const Walk<T>& w, const Step<T>& s) {
  if constexpr (kWide) return static_cast<long long>(s.Rp) * (kBatched ? col_groups(w.m) : 1);
  return static_cast<long long>(s.Rp) * (kBatched ? w.m : 1);
}

template <typename T, bool kBatched, bool kWide, bool kL2>
__device__ __forceinline__ void run_item(const Walk<T>& w, const Step<T>& s,
                                         long long i, int lane) {
  if constexpr (kWide) {
    const int G = kBatched ? col_groups(w.m) : 1;
    const int r = static_cast<int>(i / G);
    const int gi = static_cast<int>(i - static_cast<long long>(r) * G);
    warp_row<T, kBatched ? kAcc : 1, kL2>(w, s, r, gi * col_lanes(w.m) * kAcc, lane);
  } else {
    const int mm = kBatched ? w.m : 1;
    const int r = static_cast<int>(i / mm);
    thread_row<T, kL2>(w, s, r, static_cast<int>(i - static_cast<long long>(r) * mm));
  }
}

// A narrow plain segment: an item per thread.
template <typename T, bool kBatched>
__global__ void __launch_bounds__(kThreads)
level_kernel(const Walk<T> w, const Step<T> s) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  const int mm = kBatched ? w.m : 1;
  if (i >= static_cast<long long>(s.Rp) * mm) return;
  const int r = static_cast<int>(i / mm);
  thread_row<T, false>(w, s, r, static_cast<int>(i - static_cast<long long>(r) * mm));
}

// A wide plain segment: W warps per (row, column group) item, blockDim.x
// / (32 W) items per block; the W warps' sums meet in shared memory.
template <typename T, bool kBatched>
__global__ void __launch_bounds__(kWideThreads)
wide_kernel(const Walk<T> w, const Step<T> s, int W) {
  constexpr int NA = kBatched ? kAcc : 1;
  __shared__ T part[kWideThreads / 32][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rw = warp / W, wr = warp - rw * W;
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x / (32 * W)) + rw;
  const bool live = i < items_of<T, kBatched, true>(w, s);
  const int G = kBatched ? col_groups(w.m) : 1;
  const int r = live ? static_cast<int>(i / G) : 0;
  const int j0 = live ? static_cast<int>(i - static_cast<long long>(r) * G) * col_lanes(w.m) * kAcc : 0;
  const int cw = col_lanes(w.m), ng = 32 / cw;
  const int g = lane / cw, cl = lane - g * cw;
  T acc[NA];
  if (live) {
    row_sums<T, NA, false>(w, s, r, j0, cl, cw, wr * ng + g, W * ng, acc);
  } else {
#pragma unroll
    for (int a = 0; a < NA; ++a) acc[a] = T(0);
  }
  if (W == 1) {
    if (live && g == 0) finish_row<T, NA>(w, s, r, j0, cl, cw, acc);
    return;
  }
  if (g == 0) {
#pragma unroll
    for (int a = 0; a < NA; ++a) part[warp][cl + a * cw] = acc[a];
  }
  __syncthreads();
  if (live && wr == 0 && g == 0) {
#pragma unroll
    for (int a = 0; a < NA; ++a)
      for (int q = 1; q < W; ++q) acc[a] += part[warp + q][cl + a * cw];
    finish_row<T, NA>(w, s, r, j0, cl, cw, acc);
  }
}

// The barrier between a chain's sub-steps on a cluster: every block's
// writes before it are visible to every block of the cluster after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// What a narrow chain's thread loads for its item (row r, column j) of
// sub-step t before the barrier that ends sub-step t - 1: none of it
// depends on x.
template <typename T>
struct Ahead {
  long long o;
  T b, d;
  int n;
  int c[kPrefetch];
  T v[kPrefetch];
};

template <typename T>
__device__ __forceinline__ void fetch_ahead(const Walk<T>& w, const Step<T>& s0,
                                            const long long* sub_offs, int t,
                                            int r, int j, Ahead<T>& a) {
  const long long slab = static_cast<long long>(s0.K) * s0.Rp;
  const long long dr = static_cast<long long>(t) * s0.Rp + r;
  a.o = __ldg(sub_offs + t);
  a.n = __ldg(s0.len + dr);
  a.d = __ldg(s0.diag + dr);
  a.b = __ldg(w.bhat + (a.o + r) * w.ldb + j);
#pragma unroll
  for (int p = 0; p < kPrefetch; ++p) {
    const long long e = t * slab + static_cast<long long>(p) * s0.Rp + r;
    a.c[p] = p < s0.K ? __ldg(s0.cols + e) : 0;
    a.v[p] = p < s0.K ? __ldg(s0.vals + e) : T(0);
  }
}

// Sub-step t of a narrow chain for the item fetched into `a`: the slots
// past kPrefetch (rows longer than that) are loaded here.
template <typename T, bool kL2>
__device__ __forceinline__ void chain_row(const Walk<T>& w, const Step<T>& s0,
                                          int t, int r, int j, const Ahead<T>& a) {
  const int kend = a.n < s0.K ? a.n + 1 : a.n;
  T acc = a.b, xv[kPrefetch];
#pragma unroll
  for (int p = 0; p < kPrefetch; ++p)
    xv[p] = p < kend && a.c[p] < a.o ? load_x<kL2>(w.x + a.c[p] * w.ldx + j) : T(0);
#pragma unroll
  for (int p = 0; p < kPrefetch; ++p)
    if (p < kend && a.c[p] < a.o) acc -= a.v[p] * xv[p];
  const long long slab = static_cast<long long>(s0.K) * s0.Rp;
  for (int k = kPrefetch; k < kend; ++k) {
    const long long e = t * slab + static_cast<long long>(k) * s0.Rp + r;
    const long long c = __ldg(s0.cols + e);
    if (c < a.o) acc -= __ldg(s0.vals + e) * load_x<kL2>(w.x + c * w.ldx + j);
  }
  w.x[(a.o + r) * w.ldx + j] = acc / a.d;
}

// A chain on one block, or on one cluster of gridDim.x blocks: its
// sub-steps in order, a barrier after each.  `s0` is sub-step 0; sub-step
// t writes at sub_offs[t] from slabs t further on.
template <typename T, bool kBatched, bool kWide, bool kCluster>
__global__ void __launch_bounds__(kChainThreads)
chain_kernel(const Walk<T> w, const Step<T> s0, const long long* __restrict__ sub_offs,
             int depth) {
  const long long slab = static_cast<long long>(s0.K) * s0.Rp;
  const long long items = items_of<T, kBatched, kWide>(w, s0);
  const long long nthreads = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long gt = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  const long long stride = kWide ? nthreads >> 5 : nthreads;
  const long long first = kWide ? gt >> 5 : gt;
  // a narrow chain's first item per thread is fetched a sub-step ahead
  const bool ahead = !kWide && first < items;
  const int mm = kBatched ? w.m : 1;
  const int r0 = ahead ? static_cast<int>(first / mm) : 0;
  const int j0 = ahead ? static_cast<int>(first - static_cast<long long>(r0) * mm) : 0;
  Ahead<T> a;
  if (ahead) fetch_ahead(w, s0, sub_offs, 0, r0, j0, a);
  for (int t = 0; t < depth; ++t) {
    Step<T> s = s0;
    s.o = __ldg(sub_offs + t);
    s.cols += t * slab;
    s.vals += t * slab;
    s.diag += static_cast<long long>(t) * s0.Rp;
    s.len += static_cast<long long>(t) * s0.Rp;
    if (ahead) chain_row<T, kCluster>(w, s0, t, r0, j0, a);
    for (long long i = kWide ? first : first + stride; i < items; i += stride)
      run_item<T, kBatched, kWide, kCluster>(w, s, i, threadIdx.x & 31);
    if (ahead && t + 1 < depth) fetch_ahead(w, s0, sub_offs, t + 1, r0, j0, a);
    if constexpr (kCluster)
      cluster_sync();
    else
      __syncthreads();
  }
}

template <typename T, bool kBatched, bool kWide>
cudaError_t launch(const Walk<T>& w, const Step<T>& s, long long depth,
                   const long long* sub_offs, cudaStream_t stream) {
  const long long items = static_cast<long long>(s.Rp) *
      (kWide ? (kBatched ? col_groups(w.m) : 1) : (kBatched ? w.m : 1));
  const long long threads = kWide ? 32 * items : items;
  if (threads == 0) return cudaSuccess;
  if (sub_offs == nullptr && kWide) {
    const int W = warps_per_row(s.K, w.m);
    const int per_block = W * 32 >= kThreads ? W * 32 : kThreads;
    const long long per = per_block / (32 * W);      // items per block
    wide_kernel<T, kBatched><<<static_cast<unsigned>((items + per - 1) / per),
                               per_block, 0, stream>>>(w, s, W);
  } else if (sub_offs == nullptr) {
    const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
    level_kernel<T, kBatched><<<blocks, kThreads, 0, stream>>>(w, s);
  } else {
    int C = 1;        // blocks of the chain's cluster
    while (C < kMaxCluster && C * static_cast<long long>(kChainThreads) < threads) C *= 2;
    if (C == 1) {
      chain_kernel<T, kBatched, kWide, false><<<1, static_cast<unsigned>((threads + 31) / 32 * 32),
                                                0, stream>>>(w, s, sub_offs,
                                                             static_cast<int>(depth));
    } else {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(C);
      cfg.blockDim = dim3(kChainThreads);
      cfg.stream = stream;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = C;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      const cudaError_t err = cudaLaunchKernelEx(
          &cfg, chain_kernel<T, kBatched, kWide, true>, w, s, sub_offs,
          static_cast<int>(depth));
      if (err != cudaSuccess) return err;
    }
  }
  return cudaGetLastError();
}

// `tab` is a host array of (o, K, Rp, val_off, diag_off, depth, sub_off)
// per segment, sub_off -1 on a plain segment; val_off indexes both cols
// and vals, diag_off both diag and row_len; sub_offs is on the card.
template <typename T, bool kBatched>
int level_walk(const Walk<T>& w, const int* cols, const T* vals, const T* diag,
               const int* row_len, const long long* sub_offs,
               const long long* tab, int nseg, cudaStream_t stream) {
  for (int i = 0; i < nseg; ++i) {
    const long long* g = tab + kGeo * static_cast<long long>(i);
    const Step<T> s{g[0], cols + g[3], vals + g[3], diag + g[4], row_len + g[4],
                    static_cast<int>(g[1]), static_cast<int>(g[2])};
    const long long* so = g[6] < 0 ? nullptr : sub_offs + g[6];
    const cudaError_t err = s.K > kWideK
        ? launch<T, kBatched, true>(w, s, g[5], so, stream)
        : launch<T, kBatched, false>(w, s, g[5], so, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <typename T>
int level_walk_any(T* x, const T* bhat, const int* cols, const T* vals,
                   const T* diag, const int* row_len, const long long* sub_offs,
                   const long long* tab, int nseg, int batched, int m,
                   long long ldx, long long ldb, cudaStream_t stream) {
  if (batched)
    return level_walk<T, true>(Walk<T>{x, bhat, ldx, ldb, m}, cols, vals, diag,
                               row_len, sub_offs, tab, nseg, stream);
  return level_walk<T, false>(Walk<T>{x, bhat, ldx, ldb, 1}, cols, vals, diag,
                              row_len, sub_offs, tab, nseg, stream);
}

// ---------------------------------------------------------------------------
// The scatter layout's level step (layout="scatter"; ops.make_solver): the
// TPU kernel's own function on one wavefront's (K, Rp) slab in original row
// order,
//
//     xl[r, j] = (b[rows[r], j] - sum_k vals[k, r] * x[cols[k, r], j]) / diag[r]
//
// then the row scatter x[rows[r], j] = xl[r, j] and x[n, j] = 0: pad lanes
// carry the row id n (the scratch slot), gather b[n] = 0 and store 0 there,
// which is the JAX wrapper's x.at[rows].set(xl) followed by x.at[n].set(0).
// A step is two kernels on one stream: the level kernel writes xl to a
// scratch slab, so no thread reads an x row that another thread of the
// step writes (a pad slot's column 0 may be a row of the step), and the
// scatter kernel stores it.  The host walks the steps in order, a
// coarsened chain's sub-steps one by one.  A thread per (row, RHS column),
// the m columns of a row on neighbouring threads; sums in the value dtype,
// over every slot of the row as the TPU kernel reads them (pads add
// 0 * x[0]).
//
// Bound: like the walk, launch latency and the dependent load chain cols
// -> x; scatter is not a performance path (the permuted walk is), so the
// kernel is the simple one.
template <typename T>
__global__ void __launch_bounds__(kThreads)
scatter_level_kernel(const T* x, const T* __restrict__ b, const int* __restrict__ rows,
                     const int* __restrict__ cols, const T* __restrict__ vals,
                     const T* __restrict__ diag, T* __restrict__ xl, int K, int Rp,
                     int m, long long ldx, long long ldb) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= static_cast<long long>(Rp) * m) return;
  const int r = static_cast<int>(i / m);
  const int j = static_cast<int>(i - static_cast<long long>(r) * m);
  T acc = b[static_cast<long long>(__ldg(rows + r)) * ldb + j];
  for (int k = 0; k < K; ++k) {
    const long long e = static_cast<long long>(k) * Rp + r;
    acc -= __ldg(vals + e) * x[static_cast<long long>(__ldg(cols + e)) * ldx + j];
  }
  xl[i] = acc / __ldg(diag + r);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(T* __restrict__ x, const T* __restrict__ xl,
                    const int* __restrict__ rows, int n, int Rp, int m, long long ldx) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= static_cast<long long>(Rp) * m) return;
  const int r = static_cast<int>(i / m);
  const int j = static_cast<int>(i - static_cast<long long>(r) * m);
  const int row = __ldg(rows + r);
  x[static_cast<long long>(row) * ldx + j] = row == n ? T(0) : xl[i];
}

// `tab` is a host array of (K, Rp, val_off, diag_off) per step; val_off
// indexes cols and vals, diag_off rows and diag; xl holds Rp x m values of
// the widest step.
template <typename T>
int level_scatter(T* x, const T* b, const int* rows, const int* cols, const T* vals,
                  const T* diag, T* xl, const long long* tab, int nstep, int n, int m,
                  long long ldx, long long ldb, cudaStream_t stream) {
  constexpr int kScatterGeo = 4;
  for (int i = 0; i < nstep; ++i) {
    const long long* g = tab + kScatterGeo * static_cast<long long>(i);
    const int K = static_cast<int>(g[0]), Rp = static_cast<int>(g[1]);
    const long long items = static_cast<long long>(Rp) * m;
    if (items == 0) continue;
    const unsigned blocks = static_cast<unsigned>((items + kThreads - 1) / kThreads);
    scatter_level_kernel<T><<<blocks, kThreads, 0, stream>>>(
        x, b, rows + g[3], cols + g[2], vals + g[2], diag + g[3], xl, K, Rp, m, ldx, ldb);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    scatter_rows_kernel<T><<<blocks, kThreads, 0, stream>>>(x, xl, rows + g[3], n, Rp, m, ldx);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

extern "C" int sptrsv_level_scatter_f32(float* x, const float* b, const int* rows,
                                        const int* cols, const float* vals,
                                        const float* diag, float* xl,
                                        const long long* tab, int nstep, int n, int m,
                                        long long ldx, long long ldb,
                                        cudaStream_t stream) {
  return level_scatter<float>(x, b, rows, cols, vals, diag, xl, tab, nstep, n, m,
                              ldx, ldb, stream);
}

extern "C" int sptrsv_level_scatter_f64(double* x, const double* b, const int* rows,
                                        const int* cols, const double* vals,
                                        const double* diag, double* xl,
                                        const long long* tab, int nstep, int n, int m,
                                        long long ldx, long long ldb,
                                        cudaStream_t stream) {
  return level_scatter<double>(x, b, rows, cols, vals, diag, xl, tab, nstep, n, m,
                               ldx, ldb, stream);
}

extern "C" int sptrsv_level_walk_f32(float* x, const float* bhat,
                                     const int* cols, const float* vals,
                                     const float* diag, const int* row_len,
                                     const long long* sub_offs,
                                     const long long* tab, int nseg,
                                     int batched, int m, long long ldx,
                                     long long ldb, cudaStream_t stream) {
  return level_walk_any<float>(x, bhat, cols, vals, diag, row_len, sub_offs,
                               tab, nseg, batched, m, ldx, ldb, stream);
}

extern "C" int sptrsv_level_walk_f64(double* x, const double* bhat,
                                     const int* cols, const double* vals,
                                     const double* diag, const int* row_len,
                                     const long long* sub_offs,
                                     const long long* tab, int nseg,
                                     int batched, int m, long long ldx,
                                     long long ldb, cudaStream_t stream) {
  return level_walk_any<double>(x, bhat, cols, vals, diag, row_len, sub_offs,
                                tab, nseg, batched, m, ldx, ldb, stream);
}
