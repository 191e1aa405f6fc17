// SpTRSV fused kernels for Hopper (sm_90a): the whole solve in one launch.
//
// Replace the TPU kernels `fused_kernel` / `fused_solve` and
// `fused_kernel_batched` / `fused_solve_batched` of the JAX package
// (src/repro/kernels/sptrsv_fused/lowering_tpu.py).  On the TPU a
// sequential grid walks level-ordered chunks of C rows with x in VMEM.
// Both kernels compute, in level-order positions p of the fused layout,
//
//     x[p, j] = (bl[p, j] - sum_k vals[k, p] * x[cols[k, p], j]) / diag[p]
//
// with x in global memory (L2 resident: 356,352 rows x 8 B = 2.9 MB at f64
// for lung2), as a true single dispatch, as on the TPU.  A GPU grid gives
// no order between blocks, so each kernel orders the rows itself.
//
// Single RHS (sptrsv_fused_walk_*): a synchronisation-free walk (Li,
// arXiv:1710.04985) with a ready flag per row instead of a barrier per
// span.  The flag of row p is x[p] itself: the wrapper fills x with a
// pending NaN (Bits<T>::kPending) that no written value has, since the
// walk writes every NaN as the canonical one.  A row's value is thus
// written and published by one relaxed store at device scope, and a reader
// polls x[c] with a relaxed load and gets the value in the same read: one
// L2 round trip per dependent hop, no fence and no flag array (a separate
// flag costs the writer a release fence after its x store, and the reader
// a flag read, an acquire fence and then the x read).
//
// The host's table (kernels/sptrsv_fused/table.py) cuts the rows into
// groups of up to 32 rows of one chunk, in ticket order: the groups of
// real rows in position order, then those of pad rows.  A persistent
// grid, sized by occupancy and launched plainly, takes groups one per warp
// from a ticket counter (atomicAdd).  The lanes of a group of r rows split
// into r sets of 32 / pow2ceil(r) lanes, one per row (a row of more than 32
// ELL entries is a group alone, on the whole warp), and share out the
// row's terms: its first row_len[p] ELL slots (real entries come first,
// checked at build) and 0 * x[c] for each of its pad columns pad_cols[., p],
// which keep the plain version's NaN where x[c] is not finite.  A lane
// waits for every x[c] of a round of terms together (__nanosleep backoff
// between polls), the row's lanes add their sums with __shfl_xor_sync, and
// the first writes x[p].  x is read and written at device scope, so from
// L2: L1 is not coherent across SMs.
//
// Why it cannot deadlock without cooperative residency: the table only
// lets a row wait on a real row below its chunk, so of a group with an
// earlier ticket, and a warp holds a ticket only while it runs; the
// holder of the least unfinished ticket waits on nothing unfinished.  The
// lanes of a warp never wait on each other (a group lies in one chunk).
// A wait gives up after kSpinTimeoutNs of the global timer (__nanosleep
// bounds no time from below, so a poll count would not), sets the error
// word, and every warp then leaves; the wrapper, when asked to
// (check_waits), reads the word back and raises.
// The wrapper fills x and zeroes the ticket and the error word per call.
//
// Many RHS (sptrsv_fused_*, x of shape (n_pad, m)): a persistent grid that
// fills every SM.  The host sizes it as
// cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SM count and launches
// it with cudaLaunchCooperativeKernel, which guarantees that every block is
// resident (a spinning barrier in a plain launch can deadlock); a refused
// cooperative launch returns its error, and there is no fallback.  It walks
// the layout's wavefront spans (off, r_pad) in order.  Within a span the
// r_pad x m items, column fastest, are spread over every thread of the
// grid: at m = 32 one warp takes one row, its lanes read that row's 32 RHS
// values coalesced and the row's cols / vals entries are one broadcast.
// Spans are separated by the hand-written generation-counting grid barrier
// of grid_barrier.cuh, on one arrival counter in global scratch that the
// wrapper zeroes for every launch.  Rows of one span are independent; a
// read at a position >= off can only be an ELL pad (val 0), which is
// skipped, as in the level kernel (ROADMAP C-ref 2).
//
// The bug to expect: x is read through L2 (`__ldcg`, ld.global.cg, after a
// barrier; relaxed loads at device scope in the walk), never through L1.
// L1 is not coherent across SMs, and a line of x read earlier may still
// hold positions that another SM wrote since; read through L1 it would be
// stale.
//
// Bound: bytes at best (each factor entry and b read once, x written once),
// but rows depend on each other.  The walk pays, per dependent hop of the
// longest chain (493 on lung2, one per level), the poll that reads x[c]
// from L2, the row's arithmetic and the store, and reads each row's real
// entries only (the layout-wide ELL width of the lung2 transpose, 1,975,
// pads almost every slot).  The grid kernel pays span count x (grid barrier
// + dependent load latency), divides each wide level's work by the SM
// count, and issues kUnroll of a row's entries at a time to shorten its
// load chain; it still reads every ELL slot (ROADMAP B4).
#include <cuda_runtime.h>

#include "grid_barrier.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kUnroll = 4;  // ELL entries of a row in flight (batched kernel)

// The single-RHS walk.
constexpr int kWalkThreads = 256;
constexpr int kWalkBlocksPerSm = 1;  // at most; fewer if occupancy says so
constexpr int kNarrowUnroll = 4;     // a lane's terms per round, r > 1 rows
                                     // (UNROLL of sptrsv_fused/table.py)
constexpr int kWideUnroll = 16;      // the same for a row alone on a warp
constexpr unsigned kMinSleepNs = 16, kMaxSleepNs = 32;
constexpr unsigned kCheckPolls = 32;
constexpr unsigned long long kSpinTimeoutNs = 1000000000ull;  // 1 s
constexpr unsigned kFull = 0xffffffffu;

// x[p] before row p is written: a NaN that no written value has, since the
// walk writes every NaN as kNaN.  The wrapper fills x with kPending.
template <typename T>
struct Bits;
template <>
struct Bits<float> {
  using U = unsigned;
  static constexpr U kPending = 0x7fc0deadu, kNaN = 0x7fffffffu;
  static __device__ __forceinline__ U of(float v) { return __float_as_uint(v); }
  static __device__ __forceinline__ float as(U b) { return __uint_as_float(b); }
  static __device__ __forceinline__ U load(const float* p) {
    U v;
    asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p));
    return v;
  }
  static __device__ __forceinline__ void store(float* p, U v) {
    asm volatile("st.relaxed.gpu.global.b32 [%0], %1;\n" :: "l"(p), "r"(v) : "memory");
  }
};
template <>
struct Bits<double> {
  using U = unsigned long long;
  static constexpr U kPending = 0x7ff8deadbeefcafeull, kNaN = 0x7fffffffffffffffull;
  static __device__ __forceinline__ U of(double v) {
    return static_cast<U>(__double_as_longlong(v));
  }
  static __device__ __forceinline__ double as(U b) {
    return __longlong_as_double(static_cast<long long>(b));
  }
  static __device__ __forceinline__ U load(const double* p) {
    U v;
    asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];\n" : "=l"(v) : "l"(p));
    return v;
  }
  static __device__ __forceinline__ void store(double* p, U v) {
    asm volatile("st.relaxed.gpu.global.b64 [%0], %1;\n" :: "l"(p), "l"(v) : "memory");
  }
};

__device__ __forceinline__ int ld_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

template <typename T>
struct WalkArgs {
  T* x;                   // (n_pad,), filled with Bits<T>::kPending
  const T* bl;            // (n_pad,)
  const int* cols;        // (K, n_pad)
  const T* vals;          // (K, n_pad)
  const T* diag;          // (n_pad,)
  const int* groups;      // (ngroups, 2): (p0, rows) in ticket order
  const int* row_len;     // (n_pad,)
  const int* pad_cols;    // (2, n_pad), -1 past the last
  int* ticket;            // zeroed
  int* err;               // zeroed; set when a wait runs out
  long long n_pad;
  int ngroups;
};

// xv[u] = x[c[u]] for every u with c[u] >= 0, once it is written; false if
// the wait ran out or another wait did.
template <typename T, int U>
__device__ __forceinline__ bool wait_x(const T* x, const long long (&c)[U],
                                       T (&xv)[U], int* err) {
  using B = Bits<T>;
  bool pending[U];
  bool any = false;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const typename B::U b = c[u] >= 0 ? B::load(x + c[u]) : B::of(T(0));
    pending[u] = b == B::kPending;
    xv[u] = B::as(b);
    any |= pending[u];
  }
  if (!any) return true;
  unsigned long long t0 = 0;
  unsigned ns = kMinSleepNs;
  for (unsigned polls = 1;; ++polls) {
    __nanosleep(ns);
    if (ns < kMaxSleepNs) ns *= 2;
    any = false;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (pending[u]) {
        const typename B::U b = B::load(x + c[u]);
        pending[u] = b == B::kPending;
        xv[u] = B::as(b);
      }
      any |= pending[u];
    }
    if (!any) return true;
    // every kCheckPolls polls: has another wait run out, or has this one?
    // (each check is a read of its own, so not on every poll)
    if (polls % kCheckPolls == 0) {
      if (ld_relaxed(err) != 0) return false;
      const unsigned long long now = global_ns();
      if (t0 == 0) {
        t0 = now;
      } else if (now - t0 > kSpinTimeoutNs) {
        atomicExch(err, 1);
        return false;
      }
    }
  }
}

// Lane j of the L lanes of row p: the sum of its terms t = j, j + L, ...
// (t < n: ELL slot t; n <= t < nt: the pad column pc[t - n], value 0),
// U at a time: their indices load together, then their x values.
template <typename T, int U>
__device__ __forceinline__ bool row_sum(const WalkArgs<T>& a, long long p,
                                        int n, int nt, int pc0, int pc1,
                                        int j, int L, T& acc) {
  for (int t0 = j; t0 < nt; t0 += U * L) {
    long long c[U];
    T v[U], xv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u * L;
      if (t < n) {
        const long long e = static_cast<long long>(t) * a.n_pad + p;
        c[u] = __ldg(a.cols + e);
        v[u] = __ldg(a.vals + e);
      } else {
        c[u] = t >= nt ? -1 : t == n ? pc0 : pc1;
        v[u] = T(0);
      }
    }
    if (!wait_x<T, U>(a.x, c, xv, a.err)) return false;
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (c[u] >= 0) acc += v[u] * xv[u];
  }
  return true;
}

template <typename T>
__global__ void __launch_bounds__(kWalkThreads, kWalkBlocksPerSm)
fused_walk_kernel(WalkArgs<T> a) {
  using B = Bits<T>;
  const int lane = threadIdx.x & 31;
  for (;;) {
    int g = 0;
    if (lane == 0) g = atomicAdd(a.ticket, 1);
    g = __shfl_sync(kFull, g, 0);
    if (g >= a.ngroups || ld_relaxed(a.err) != 0) return;
    const int p0 = __ldg(a.groups + 2 * g);
    const int R = __ldg(a.groups + 2 * g + 1);
    const int lg = R > 1 ? 32 - __clz(R - 1) : 0;  // log2 of R rounded up
    const int L = 32 >> lg;                        // lanes per row
    const int r = lane >> (5 - lg);
    const int j = lane & (L - 1);
    const bool live = r < R;
    const long long p = static_cast<long long>(p0) + r;
    T acc = T(0), b = T(0), d = T(1);
    bool ok = true;
    int nt = 0;  // the row's terms
    if (live) {
      const int n = __ldg(a.row_len + p);
      const int pc0 = __ldg(a.pad_cols + p);
      const int pc1 = __ldg(a.pad_cols + a.n_pad + p);
      nt = n + (pc0 >= 0) + (pc1 >= 0);
      if (j == 0) {
        b = __ldg(a.bl + p);
        d = __ldg(a.diag + p);
      }
      ok = R == 1 ? row_sum<T, kWideUnroll>(a, p, n, nt, pc0, pc1, j, L, acc)
                  : row_sum<T, kNarrowUnroll>(a, p, n, nt, pc0, pc1, j, L, acc);
    }
    if (!__all_sync(kFull, ok)) return;
    // lanes j >= nt hold no term: add over the lanes the widest row used
    const int used = __reduce_max_sync(kFull, static_cast<unsigned>(nt));
    for (int s = 1; s < L && s < used; s *= 2)
      acc += __shfl_xor_sync(kFull, acc, s);
    if (live && j == 0) {
      const T y = (b - acc) / d;
      B::store(a.x + p, y != y ? B::kNaN : B::of(y));  // y != y: a NaN
    }
  }
}

// Blocks of the walk's grid: up to kWalkBlocksPerSm per SM, as many as fit.
template <typename T>
int walk_blocks(int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_walk_kernel<T>, kWalkThreads, 0);
  *blocks = (per_sm < kWalkBlocksPerSm ? per_sm : kWalkBlocksPerSm) * sms;
  return static_cast<int>(err);
}

template <typename T>
int walk_entry(T* x, const T* bl, const int* cols, const T* vals, const T* diag,
               const int* groups, int ngroups, const int* row_len,
               const int* pad_cols, long long n_pad, int* scratch,
               cudaStream_t stream) {
  int blocks = 0;
  int err = walk_blocks<T>(&blocks);
  if (err != 0) return err;
  if (blocks < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  WalkArgs<T> a{x, bl, cols, vals, diag, groups, row_len, pad_cols,
                scratch, scratch + 1, n_pad, ngroups};
  fused_walk_kernel<T><<<blocks, kWalkThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_grid_kernel(T* __restrict__ x, const T* __restrict__ bl,
                  const int* __restrict__ cols, const T* __restrict__ vals,
                  const T* __restrict__ diag, const int* __restrict__ spans,
                  int nspans, int K, long long n_pad, int m, long long ldx,
                  long long ldb, unsigned* bar) {
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (int s = 0; s < nspans; ++s) {
    const long long off = __ldg(spans + 2 * s);
    const long long total = static_cast<long long>(__ldg(spans + 2 * s + 1)) * m;
    for (long long t = first; t < total; t += stride) {
      const long long p = off + t / m;
      const int j = static_cast<int>(t % m);
      const T d = __ldg(diag + p);
      T acc = __ldg(bl + p * ldb + j);
      // kUnroll entries at a time: their index and value loads issue
      // together, then their x loads, so a row waits about 2 K / kUnroll
      // load latencies instead of 2 K; the sum keeps the order of k
      for (int k0 = 0; k0 < K; k0 += kUnroll) {
        long long c[kUnroll];
        T a[kUnroll], xv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const long long e = static_cast<long long>(k0 + u) * n_pad + p;
          c[u] = k0 + u < K ? __ldg(cols + e) : off;
          a[u] = k0 + u < K ? __ldg(vals + e) : T(0);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          xv[u] = c[u] < off ? __ldcg(x + c[u] * ldx + j) : T(0);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (c[u] < off) acc -= a[u] * xv[u];
      }
      x[p * ldx + j] = acc / d;
    }
    if (s + 1 < nspans) grid_barrier(bar, (s + 1u) * gridDim.x);
  }
}

// Blocks of the batched grid: as many as can be resident at once.
template <typename T>
int grid_blocks(int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_grid_kernel<T>, kThreads, 0);
  *blocks = per_sm * sms;
  return static_cast<int>(err);
}

template <typename T>
int fused_launch(T* x, const T* bl, const int* cols, const T* vals,
                 const T* diag, const int* spans, int nspans, int K,
                 long long n_pad, int m, long long ldx, long long ldb,
                 unsigned* bar, cudaStream_t stream) {
  int blocks = 0;
  int err = grid_blocks<T>(&blocks);
  if (err != 0) return err;
  if (blocks < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  if (static_cast<long long>(nspans) * blocks > 0xffffffffLL)  // the count's range
    return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&x, &bl, &cols, &vals, &diag, &spans, &nspans, &K,
                  &n_pad, &m, &ldx, &ldb, &bar};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(fused_grid_kernel<T>), dim3(blocks),
      dim3(kThreads), args, 0, stream));
}

}  // namespace

// The single-RHS walk: x filled with the pending NaN of its type
// (0x7fc0dead, 0x7ff8deadbeefcafe); scratch two zeroed ints, the ticket
// counter and the error word.
extern "C" int sptrsv_fused_walk_f32(float* x, const float* bl, const int* cols,
                                     const float* vals, const float* diag,
                                     const int* groups, int ngroups,
                                     const int* row_len, const int* pad_cols,
                                     long long n_pad, int* scratch,
                                     cudaStream_t stream) {
  return walk_entry<float>(x, bl, cols, vals, diag, groups, ngroups, row_len,
                           pad_cols, n_pad, scratch, stream);
}

extern "C" int sptrsv_fused_walk_f64(double* x, const double* bl, const int* cols,
                                     const double* vals, const double* diag,
                                     const int* groups, int ngroups,
                                     const int* row_len, const int* pad_cols,
                                     long long n_pad, int* scratch,
                                     cudaStream_t stream) {
  return walk_entry<double>(x, bl, cols, vals, diag, groups, ngroups, row_len,
                            pad_cols, n_pad, scratch, stream);
}

// The batched solve, x and bl of shape (n_pad, m).
extern "C" int sptrsv_fused_f32(float* x, const float* bl, const int* cols,
                                const float* vals, const float* diag,
                                const int* spans, int nspans, int K,
                                long long n_pad, int m, long long ldx,
                                long long ldb, unsigned* bar,
                                cudaStream_t stream) {
  return fused_launch<float>(x, bl, cols, vals, diag, spans, nspans, K, n_pad,
                             m, ldx, ldb, bar, stream);
}

extern "C" int sptrsv_fused_f64(double* x, const double* bl, const int* cols,
                                const double* vals, const double* diag,
                                const int* spans, int nspans, int K,
                                long long n_pad, int m, long long ldx,
                                long long ldb, unsigned* bar,
                                cudaStream_t stream) {
  return fused_launch<double>(x, bl, cols, vals, diag, spans, nspans, K,
                              n_pad, m, ldx, ldb, bar, stream);
}

// The block counts of the two grids on the current device.
extern "C" int sptrsv_fused_grid_f32(int* blocks) { return grid_blocks<float>(blocks); }
extern "C" int sptrsv_fused_grid_f64(int* blocks) { return grid_blocks<double>(blocks); }
extern "C" int sptrsv_fused_walk_grid_f32(int* blocks) { return walk_blocks<float>(blocks); }
extern "C" int sptrsv_fused_walk_grid_f64(int* blocks) { return walk_blocks<double>(blocks); }
