// Kernels of the fluid network simulator, for Hopper (sm_90a).
//
// Nine kernels.  Eight are each the CUDA twin of one Pallas kernel of
// the JAX package (in `repro/kernels/`) and of one plain PyTorch
// function in `kernels/ref.py`; the ninth, segment_sum, is the twin of
// the reference's `link_load.py::segment_load` and `segment_load_chunk`,
// which XLA computes there (see its section):
//
//   plane_split            <- plb_select.py _plane_split_kernel
//   pair_fractions         <- jsq_route.py  _pair_score_kernel
//   bottleneck             <- link_load.py  _bottleneck_kernel
//   bucket_load_bottleneck <- link_load.py  _load_bottleneck_kernel
//   queue_update           <- queue_ecn.py  _queue_update_kernel
//   nic_update             <- queue_ecn.py  _nic_update_kernel
//   jsq_route              <- jsq_route.py  _jsq_kernel
//   plb_select             <- plb_select.py _plb_kernel
//   segment_sum            <- link_load.py  segment_load (XLA, no Pallas)
//
// All but jsq_route do a handful of flops per element, so bytes bound
// them on the card: each reads its inputs once and writes its outputs
// once (jsq_route does a hash and a compare per packet and port, so
// operations bound it).  Most designs are the simple ones: one thread
// per flow (nic_update: the plane axis P <= 8 lives in registers) or
// per packet (plb_select), in grid-stride loops.  Seven are shaped by
// what held them back:
//
//   pair_fractions  the bytes of a 2M-element giga call bound it, but
//                   its exp, IEEE divisions and per-row chains make the
//                   math nearly as long as the traffic, and a design
//                   where every element walked its row's max and sum
//                   spent 16x the chain work.  Rows of S <= 32 spines
//                   now live in groups of lanes of one warp, and one
//                   lane a row walks each chain once.
//   bottleneck,     a slot's links are 8,192 elements an array at giga
//   queue_update    scale: launch latency, not bytes, bounds one call.
//                   One bottleneck launch takes up to four (cap, load,
//                   out) entries and one queue_update launch a slot's
//                   up and down links, passed by value.
//   plane_split     one thread a flow with P read at run time took four
//                   times its bytes bound.  The planes are now a
//                   template parameter, so its plane loops unroll with
//                   no guards; still one row a thread.
//   bucket_load_    one thread a bucket waited on a dozen dependent
//   bottleneck      memory round trips with a few warps an SM to hide
//                   them.  A group of lanes of one warp now takes a
//                   bucket: coalesced plan loads, every gather of the
//                   row in flight at once, one lane walks the sum.
//   jsq_route       one thread a packet walked all ports in one
//                   dependent chain on a few blocks.  A group of lanes
//                   of one warp now takes a packet and reduces its
//                   lanes' best ports by shuffles.
//   plb_select      one thread a packet read the plane vectors inside
//                   guarded plane loops after its packet loads.  Each
//                   thread now loads them once beside its packet, with
//                   P a template parameter: the launch floor is left.
//
// Unlike the Pallas bodies, which cast to float32, the seven slot-engine
// kernels compute in their input type, so the float64 parity mode runs
// through the kernels themselves; the per-packet jsq_route and
// plb_select compute in float32 and uint32, as their Pallas bodies do.
// Built with --fmad=false: a fused multiply-add rounds once where the
// plain version rounds twice, and a last-ulp difference in a queue
// integrator forks a trajectory at an ECN threshold.  Sums over the
// plane, spine and bucket axes run left to right, as in the plain
// versions, so kernels without exp agree with them bit for bit.
//
// Plain C interface (loaded with ctypes): every entry point takes raw
// pointers and the CUDA stream, launches on that stream, allocates
// nothing, and returns cudaGetLastError() so the caller sees a refused
// launch.  Booleans travel as uint8.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPlanes = 8;
constexpr int64_t kMaxBlocks = 1 << 20;

enum SplitMode { kSpx = 0, kDcqcn = 1, kAgg = 2, kSwlb = 3 };

template <typename T>
__device__ __forceinline__ T min_(T a, T b) { return b < a ? b : a; }

template <typename T>
__device__ __forceinline__ T max_(T a, T b) { return b > a ? b : a; }

template <typename T>
__device__ __forceinline__ T clip_(T x, T lo, T hi) {
  return min_(max_(x, lo), hi);
}

inline unsigned grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<unsigned>(blocks);
}

#define GRID_STRIDE(i, n)                                              \
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;    \
       i < (n); i += (int64_t)gridDim.x * blockDim.x)

// ---- plane_split: rows of P planes, P known at compile time ----------
// rate/elig/out (F, P), demand (F,).  thresh = min_rate + 1e-9 and
// fallback = 1.0 / P arrive computed in double, as the Python scalars
// of the plain version are.  Bytes bound it (a giga call, F = 102,400
// and P = 2 in float64, moves 4.3 MB: 1.28 us at the HBM rate), but
// the first kernel, one thread a flow with P a run-time argument, every
// plane loop guarded by p < P, took about four times that.  Here the
// planes the registry uses (P = 1, 2, 4) are a template parameter, so
// the plane loops unroll without guards and the row strides are
// constants; other P in 1-8 take the instance with P read at run time.
// Rows are read element by element, one row a thread.  The math and its
// order are the plain version's.  Timed side by side at giga on the
// H100 (benchmarks/torch_plane_split_designs.py; PERF.md, section 6):
// compile-time P made the gain; whole-row vector loads gained nothing
// resolvable and several rows a thread were slower.

// one flow's split over planes p < P of N (P == N when the planes are
// known at compile time, and the guards fold away)
template <typename T, int MODE, int N>
__device__ __forceinline__ void split_row(const T (&rr)[N],
                                          const uint8_t (&eb)[N], T d,
                                          int P, T thresh, T fallback,
                                          T (&o)[N]) {
  bool ee[N];
#pragma unroll
  for (int p = 0; p < N; ++p) ee[p] = p < P && eb[p] != 0;
  if (MODE == kDcqcn) {
    const T w = T(1) / T(P);
#pragma unroll
    for (int p = 0; p < N; ++p)
      if (p < P) o[p] = min_(d * w, rr[p]);
  } else if (MODE == kSwlb || MODE == kAgg) {
    int n_up = 0;
    T shared = rr[0];
#pragma unroll
    for (int p = 0; p < N; ++p) {
      if (p < P) {
        n_up += ee[p] ? 1 : 0;
        shared = min_(shared, rr[p]);
      }
    }
    const T n = T(n_up > 1 ? n_up : 1);
    const T v = MODE == kSwlb ? d / n : d * shared / n;
#pragma unroll
    for (int p = 0; p < N; ++p)
      if (p < P) o[p] = ee[p] ? v : T(0);
  } else {  // spx: rate filter (E2E precedence) then allowance weights
    bool ok[N];
    bool any_ok = false;
#pragma unroll
    for (int p = 0; p < N; ++p) {
      ok[p] = ee[p] && rr[p] > thresh;
      any_ok = any_ok || ok[p];
    }
    T s = T(0);
#pragma unroll
    for (int p = 0; p < N; ++p) {
      if (p < P) {
        ok[p] = any_ok ? ok[p] : ee[p];
        const T w = ok[p] ? rr[p] : T(0);
        s = p == 0 ? w : s + w;
      }
    }
    const T denom = max_(s, T(1e-12));
#pragma unroll
    for (int p = 0; p < N; ++p) {
      if (p < P) {
        const T alive = ok[p] ? rr[p] : T(0);
        const T w = s > T(0) ? alive / denom : fallback;
        o[p] = min_(d * w, alive);
      }
    }
  }
}

// NP = 1, 2, 4: the planes at compile time; NP = 0: P at run time
// (<= kMaxPlanes).  One row a thread: a giga call's 400 blocks are all
// on the card at once, so the longest thread's chain of loads,
// divisions and stores sets the time.
template <typename T, int MODE, int NP>
__global__ void plane_split_kernel(const T* __restrict__ rate,
                                   const uint8_t* __restrict__ elig,
                                   const T* __restrict__ demand,
                                   T* __restrict__ out, int64_t F,
                                   int P_rt, T thresh, T fallback) {
  constexpr int N = NP > 0 ? NP : kMaxPlanes;
  const int P = NP > 0 ? NP : P_rt;
  GRID_STRIDE(f, F) {
    T rr[N], o[N];
    uint8_t eb[N];
#pragma unroll
    for (int p = 0; p < N; ++p) {
      rr[p] = p < P ? rate[f * P + p] : T(0);
      eb[p] = p < P ? elig[f * P + p] : 0;
    }
    split_row<T, MODE, N>(rr, eb, demand[f], P, thresh, fallback, o);
#pragma unroll
    for (int p = 0; p < N; ++p)
      if (p < P) out[f * P + p] = o[p];
  }
}

// ---- pair_fractions --------------------------------------------------
// q/cap/w/out (R, S), a row being one (plane, src leaf, dst leaf): per
// element a logit, per row its max, exp(logit - max), the left-to-right
// row sum, and the normalised fraction.  Three inputs read and one
// output written bound it: at giga scale (R = 131,072, S = 16) 67 MB in
// float64, 0.020 ms at the HBM rate.  But its math (an exp, IEEE
// divisions, the row chains) takes nearly as long on this card, and the
// two add up more than they overlap, so the design cuts instructions.

// x / y, or x * inv where inv != 0 is y's exact reciprocal (y a power
// of two): the same correctly rounded value, without a division.
template <typename T>
__device__ __forceinline__ T div_(T x, T y, T inv) {
  return inv != T(0) ? x * inv : x / y;
}

// inv_qmax / inv_temperature: see div_ (0 = divide)
template <typename T>
__device__ __forceinline__ T pair_logit(T q, T cap, T w, T hi, T qmax,
                                        T nbins, T temperature, T inv_qmax,
                                        T inv_temperature) {
  const T qbin =
      floor(clip_(div_(q, qmax, inv_qmax), T(0), hi) * nbins) + T(1);
  const T score = qbin / max_(w, T(1e-9));
  return cap > T(1e-9) ? div_(-score, temperature, inv_temperature)
                       : T(-1e30);
}

// S <= 32 (every registry fabric: S = 2, 8, 16).  A row is a group of
// G lanes (S rounded up to a power of two), one element a lane, so a
// warp's loads and stores cover 32 / G consecutive rows, coalesced.  A
// warp takes tiles of kPairUnroll such row groups: all of a tile's
// loads are issued before its math, so each thread has kPairUnroll
// loads of each input in flight.
//
// The row max and the left-to-right row sum are serial chains over S
// values.  Taken by every lane of a row (through shared memory behind
// block barriers, or by S shuffles a lane) they cost S steps an element
// and, with the exp and the IEEE divisions, make the math as long as
// the memory traffic.  Here each warp stages its tile in its own slice
// of shared memory and one lane a row walks each chain once: the
// tile's logits go in, each row lane writes its row's max into the
// row's padding slot, every lane takes exp(logit - max) of its element,
// and the row lanes add the row left to right, the order of the plain
// version.  Rows are padded to G + 1 values, so the row lanes' column
// reads hit distinct banks; only __syncwarp orders the warp's steps.
// Divisions by a power-of-two qmax or temperature (the engine's 8 and
// 0.25) become the exactly equal multiplications by the reciprocal.
constexpr int kPairUnroll = 4;

template <typename T, int G>
__global__ void __launch_bounds__(kThreads) pair_fractions_warp_kernel(
    const T* __restrict__ q, const T* __restrict__ cap,
    const T* __restrict__ w, T* __restrict__ out, int64_t R, int S, T hi,
    T qmax, T nbins, T temperature, T inv_qmax, T inv_temperature) {
  constexpr int kRowsPerPass = 32 / G;
  constexpr int kTileRows = kPairUnroll * kRowsPerPass;
  constexpr int kStride = G + 1;                 // slot G: the row's max/sum
  __shared__ T tiles[kThreads / 32][kTileRows * kStride];
  const int lane = threadIdx.x & 31;
  const int s = lane % G;
  const int sub = lane / G;
  T* tile = tiles[threadIdx.x / 32];
  const int64_t warp = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) / 32;
  const int64_t step = (int64_t)gridDim.x * blockDim.x / 32 * kTileRows;
  // the loop bound is uniform across the warp, so every lane reaches
  // every __syncwarp
  for (int64_t first = warp * kTileRows; first < R; first += step) {
    const int64_t base = first * S;              // the tile's first element
    const int64_t rows = R - first;              // live rows from `first`
    int row[kPairUnroll];
    bool live[kPairUnroll];
    T vq[kPairUnroll], vc[kPairUnroll], vw[kPairUnroll];
#pragma unroll
    for (int u = 0; u < kPairUnroll; ++u) {
      row[u] = u * kRowsPerPass + sub;
      live[u] = s < S && row[u] < rows;
    }
#pragma unroll
    for (int u = 0; u < kPairUnroll; ++u) {
      const int64_t i = base + row[u] * S + s;
      vq[u] = live[u] ? __ldg(q + i) : T(0);
      vc[u] = live[u] ? __ldg(cap + i) : T(0);
      vw[u] = live[u] ? __ldg(w + i) : T(0);
    }
    T l[kPairUnroll], e[kPairUnroll];
#pragma unroll
    for (int u = 0; u < kPairUnroll; ++u) {
      l[u] = live[u] ? pair_logit(vq[u], vc[u], vw[u], hi, qmax, nbins,
                                  temperature, inv_qmax, inv_temperature)
                     : T(-1e30);
      tile[row[u] * kStride + s] = l[u];
    }
    __syncwarp();
    for (int r = lane; r < kTileRows; r += 32) {
      const T* v = tile + r * kStride;
      T m = v[0];
#pragma unroll
      for (int k = 1; k < G; ++k)
        if (k < S) m = max_(m, v[k]);
      tile[r * kStride + G] = m;
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < kPairUnroll; ++u)
      e[u] = exp(l[u] - tile[row[u] * kStride + G]);
    __syncwarp();                                // every max read
#pragma unroll
    for (int u = 0; u < kPairUnroll; ++u) tile[row[u] * kStride + s] = e[u];
    __syncwarp();
    for (int r = lane; r < kTileRows; r += 32) {
      const T* v = tile + r * kStride;
      T sum = v[0];
#pragma unroll
      for (int k = 1; k < G; ++k)
        if (k < S) sum = sum + v[k];
      tile[r * kStride + G] = sum;
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < kPairUnroll; ++u) {
      const T sum = tile[row[u] * kStride + G];
      if (live[u])
        out[base + row[u] * S + s] =
            sum > T(0) ? e[u] / max_(sum, T(1e-30)) : T(0);
    }
    __syncwarp();                                // every sum read
  }
}

// S > 32, the generic path (no registry fabric reaches it; the tests
// do): one thread per (row, spine) element, `rows` whole rows per
// block, rows * S threads.  Each thread computes one logit from
// coalesced loads, takes its row's max and then the left-to-right sum
// of exp(logit - max) from shared memory (every thread of a row reads
// the same values in the same order), and writes its normalised
// fraction.
template <typename T>
__global__ void pair_fractions_kernel(const T* __restrict__ q,
                                      const T* __restrict__ cap,
                                      const T* __restrict__ w,
                                      T* __restrict__ out, int64_t R,
                                      int S, int rows, T hi, T qmax,
                                      T nbins, T temperature, T inv_qmax,
                                      T inv_temperature) {
  extern __shared__ unsigned char smem[];
  T* buf = reinterpret_cast<T*>(smem);
  const int s = threadIdx.x % S;
  const int row_base = threadIdx.x - s;          // this row's first slot
  // the loop bound is uniform across the block, so every thread reaches
  // every barrier
  for (int64_t first = (int64_t)blockIdx.x * rows; first < R;
       first += (int64_t)gridDim.x * rows) {
    const int64_t row = first + threadIdx.x / S;
    const bool live = row < R;
    const int64_t i = row * S + s;
    const T l = live ? pair_logit(q[i], cap[i], w[i], hi, qmax, nbins,
                                  temperature, inv_qmax, inv_temperature)
                     : T(-1e30);
    buf[threadIdx.x] = l;
    __syncthreads();
    T m = buf[row_base];
    for (int k = 1; k < S; ++k) m = max_(m, buf[row_base + k]);
    const T e = exp(l - m);
    __syncthreads();                             // logits all read
    buf[threadIdx.x] = e;
    __syncthreads();
    T sum = buf[row_base];
    for (int k = 1; k < S; ++k) sum = sum + buf[row_base + k];
    if (live) out[i] = sum > T(0) ? e / max_(sum, T(1e-30)) : T(0);
    __syncthreads();                             // sums all read
  }
}

// ---- bottleneck: elementwise min(1, cap / max(load, eps)) ------------
// One launch covers up to kMaxGroup (cap, load, out) entries: a slot
// scales its up, down and access links in one launch instead of four
// (six on a fat tree: stage-A up and down, stage-B up and down, and the
// two access directions).
// The entries travel by value in the kernel's arguments (no device-side
// table, no host-to-device copy, so a CUDA graph can capture the
// launch); the grid covers the entries' summed length, and each thread
// finds its entry from the prefix offsets with compile-time indices
// only (a run-time index into the arguments would copy them to local
// memory).  Bytes bound the work, but at giga scale a slot's four
// entries are 786 KB, 0.24 us at the HBM rate, well below one launch's
// latency.
constexpr int kMaxGroup = 6;

template <typename T>
struct BottleneckGroup {
  const T* cap[kMaxGroup];
  const T* load[kMaxGroup];
  T* out[kMaxGroup];
  int64_t start[kMaxGroup];     // entry k covers [start[k], start[k + 1])
  int64_t total;
  int count;
};

template <typename T>
__global__ void bottleneck_kernel(const BottleneckGroup<T> g, T eps) {
  GRID_STRIDE(i, g.total) {
    const T* c = g.cap[0];
    const T* l = g.load[0];
    T* o = g.out[0];
    int64_t base = 0;
#pragma unroll
    for (int k = 1; k < kMaxGroup; ++k) {
      if (k < g.count && i >= g.start[k]) {
        c = g.cap[k];
        l = g.load[k];
        o = g.out[k];
        base = g.start[k];
      }
    }
    const int64_t j = i - base;
    o[j] = min_(c[j] / max_(l[j], eps), T(1));
  }
}

// ---- queue_update: elementwise fluid queue integrator + util ---------
// One launch covers up to kMaxQueueGroup (q, load, cap, q_new, util)
// entries: a slot integrates its up and its down links in one launch
// instead of two (four on a fat tree: both directions of stage A and of
// stage B).  Bytes bound the work, but at giga scale one entry is
// 8,192 links (five arrays: 328 KB in float64, 0.1 us at the HBM rate),
// far below one launch's latency, so the launch is the cost, as it was
// for bottleneck.  The entries travel by value in the kernel's
// arguments, as BottleneckGroup's do, and each thread picks its entry
// with compile-time indices only.  Two entries in one launch take about
// what one took alone (PERF.md, section 6).
constexpr int kMaxQueueGroup = 4;

template <typename T>
struct QueueGroup {
  const T* q[kMaxQueueGroup];
  const T* load[kMaxQueueGroup];
  const T* cap[kMaxQueueGroup];
  T* q_new[kMaxQueueGroup];
  T* util[kMaxQueueGroup];
  int64_t start[kMaxQueueGroup];
  int64_t total;
  int count;
};

template <typename T>
__global__ void queue_update_kernel(const QueueGroup<T> g, T q_cap,
                                    T eps) {
  GRID_STRIDE(i, g.total) {
    const T* q = g.q[0];
    const T* ld = g.load[0];
    const T* cp = g.cap[0];
    T* qn = g.q_new[0];
    T* ut = g.util[0];
    int64_t base = 0;
#pragma unroll
    for (int k = 1; k < kMaxQueueGroup; ++k) {
      if (k < g.count && i >= g.start[k]) {
        q = g.q[k];
        ld = g.load[k];
        cp = g.cap[k];
        qn = g.q_new[k];
        ut = g.util[k];
        base = g.start[k];
      }
    }
    const int64_t j = i - base;
    const T c = cp[j];
    const T l = ld[j];
    const T denom = max_(c, eps);
    const T qv = clip_(q[j] + (l - c) / denom, T(0), q_cap);
    qn[j] = c <= eps ? T(0) : qv;
    ut[j] = l / denom;
  }
}

// ---- nic_update: one thread per flow, RTT/ECN + one CC step ---------
// qmean/rate/alpha and the four outputs (F, P); esr (F, 1).  Constants
// arrive as the plain version's Python scalars: `four_thresh` is
// 4 * ecn_thresh and `one_minus_*` are 1 - md and 1 - alpha_g.
template <typename T>
struct NicConsts {
  T base_rtt, slot_us, half, ecn_thresh, four_thresh, target_rtt,
      min_rate, md, one_minus_md, ai, rtt_gain, dcqcn_ai, alpha_g,
      one_minus_alpha_g;
};

enum NicMode { kNicSpx = 0, kNicDcqcn = 1, kNicAgg = 2 };

template <typename T, int MODE>
__global__ void nic_update_kernel(const T* __restrict__ qmean,
                                  const T* __restrict__ rate,
                                  const T* __restrict__ alpha,
                                  const uint8_t* __restrict__ esr,
                                  T* __restrict__ rtt_out,
                                  T* __restrict__ ecn_out,
                                  T* __restrict__ rate_out,
                                  T* __restrict__ alpha_out, int64_t F,
                                  int P, NicConsts<T> c) {
  GRID_STRIDE(f, F) {
    const int64_t base = f * P;
    T rtt[kMaxPlanes], ecn[kMaxPlanes];
    T max_ecn = T(0), max_rtt = T(0);
#pragma unroll
    for (int p = 0; p < kMaxPlanes; ++p) {
      if (p < P) {
        const T qm = qmean[base + p];
        rtt[p] = c.base_rtt + qm * c.slot_us * c.half;
        ecn[p] = qm > c.ecn_thresh ? min_(qm / c.four_thresh, T(1)) : T(0);
        rtt_out[base + p] = rtt[p];
        ecn_out[base + p] = ecn[p];
        max_ecn = p == 0 ? ecn[p] : max_(max_ecn, ecn[p]);
        max_rtt = p == 0 ? rtt[p] : max_(max_rtt, rtt[p]);
      }
    }
    const bool marked = max_ecn > T(0);
    if (MODE == kNicDcqcn) {
#pragma unroll
      for (int p = 0; p < kMaxPlanes; ++p) {
        if (p < P) {
          const T r = rate[base + p];
          const T a = c.one_minus_alpha_g * alpha[base + p] +
                      c.alpha_g * (marked ? T(1) : T(0));
          const T cut = r * (T(1) - a / T(2));
          const T grow = min_(r + c.dcqcn_ai, T(1));
          rate_out[base + p] = clip_(marked ? cut : grow, c.min_rate, T(1));
          alpha_out[base + p] = a;
        }
      }
    } else if (MODE == kNicAgg) {
      const T rtt_err = (max_rtt - c.target_rtt) / c.target_rtt;
      const bool esr_cut = esr[f] != 0 && marked;
#pragma unroll
      for (int p = 0; p < kMaxPlanes; ++p) {
        if (p < P) {
          const T r = rate[base + p];
          const T cut = r * c.md;
          const T trim = r * (T(1) - c.rtt_gain * clip_(rtt_err, T(0), T(2)));
          const T grow = min_(r + c.ai, T(1));
          T v = marked ? cut : (rtt_err > T(0.25) ? trim : grow);
          if (esr_cut) v = v * T(0.85);
          rate_out[base + p] = clip_(v, c.min_rate, T(1));
          alpha_out[base + p] = alpha[base + p];
        }
      }
    } else {  // spx: per-plane AIMD, ECN-proportional cut, RTT trim
#pragma unroll
      for (int p = 0; p < kMaxPlanes; ++p) {
        if (p < P) {
          const T r = rate[base + p];
          const T rtt_err = (rtt[p] - c.target_rtt) / c.target_rtt;
          const T cut =
              r * (c.md + c.one_minus_md * clip_(T(1) - ecn[p], T(0), T(1)));
          const T trim = r * (T(1) - c.rtt_gain * clip_(rtt_err, T(0), T(2)));
          const T grow = min_(r + c.ai, T(1));
          const T v = ecn[p] > T(0) ? cut : (rtt_err > T(0.25) ? trim : grow);
          rate_out[base + p] = clip_(v, c.min_rate, T(1));
          alpha_out[base + p] = alpha[base + p];
        }
      }
    }
  }
}

// ---- bucket_load_bottleneck: a group of lanes a link bucket ---------
// rate (B, F, P); plan (B, P, R, C) int32 flow indices into the lane's
// own F rows, F = pad (reads +0.0); cap/load/frac (B, P, R): a batch of
// B points of one structure (B = 1 for one point), its B * P * R
// buckets in one grid.  Each bucket's C rates are summed strictly left
// to right from column 0, pads adding +0.0 as in the plain version (flow
// order: bit-equal to the ordered plain sum and to the NumPy engine's
// np.add.at), then the bottleneck scale is written with a true division.
// A giga plan (P = 2, R = 8,192, C = 47) moves 5.1 MB, 1.5 us at the HBM
// rate.  The first kernel, one thread a bucket in 128 blocks of 128,
// was held back by latency: each thread read its plan row at the row's
// 188-byte stride and waited on about a dozen dependent round trips,
// with some 4 warps an SM to hide them.  Here a group of kBucketLanes
// lanes of one warp takes kBucketRows buckets at a time: its lanes read
// a row's indices on neighbouring words (two requests for a giga row),
// issue every gather of a pass of kBucketCols columns before any add,
// and stage the values in the warp's slice of shared memory; after
// __syncwarp one lane a bucket walks them in column order.  The grid
// covers every bucket at once (giga: 512 blocks of 32 buckets, all
// resident on 132 SMs), with a grid-stride loop past kMaxBlocks.  Timed
// side by side at giga on the H100 (benchmarks/
// torch_bucket_codec_designs.py; PERF.md, section 6), the lanes and
// buckets a group and the order of the buckets moved the time by less
// than a launch costs while the grid stayed one wave, and a walk by
// shuffles was slower; what is left is the launch and some 410,000
// scattered 8-byte gathers, each a 32-byte sector.
constexpr int kBucketLanes = 16;      // lanes of a group
constexpr int kBucketRows = 2;        // buckets a group takes at once
constexpr int kBucketCols = 64;       // columns a pass gathers

template <typename T>
__global__ void __launch_bounds__(kThreads) bucket_load_bottleneck_kernel(
    const T* __restrict__ rate, const int32_t* __restrict__ plan,
    const T* __restrict__ cap, T* __restrict__ load, T* __restrict__ frac,
    int64_t B, int64_t F, int P, int64_t R, int C, T eps) {
  constexpr int G = kBucketLanes;
  constexpr int U = kBucketCols / G;          // columns a lane a pass
  constexpr int kGroups = 32 / G;             // groups a warp
  constexpr int kTile = kGroups * kBucketRows;  // buckets a warp at once
  constexpr int kStride = kBucketCols + 1;    // a staged row, padded
  static_assert(32 % G == 0 && kBucketCols % G == 0 && kBucketRows <= G,
                "bucket tiling");
  __shared__ T stage[kThreads / 32][kTile * kStride];
  const int lane = threadIdx.x & 31;
  const int g = lane % G;
  const int sub = lane / G;
  T* tile = stage[threadIdx.x / 32];
  const int64_t n = B * P * R;
  const int64_t warp = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) / 32;
  const int64_t step = (int64_t)gridDim.x * blockDim.x / 32 * kTile;
  // the loop bounds are uniform across the warp, so every lane reaches
  // every __syncwarp
  for (int64_t first = warp * kTile; first < n; first += step) {
    int64_t b[kBucketRows];                   // the group's buckets
    const T* lane_rate[kBucketRows];          // the bucket's lane's rates,
    int p[kBucketRows];                       // offset by its plane
    bool live[kBucketRows];
#pragma unroll
    for (int k = 0; k < kBucketRows; ++k) {
      b[k] = first + k * kGroups + sub;
      live[k] = b[k] < n;
      const int64_t row = live[k] ? b[k] / R : 0;    // lane * P + plane
      p[k] = static_cast<int>(row % P);
      lane_rate[k] = rate + (row / P) * F * P + p[k];
    }
    // lane g < kBucketRows walks the group's bucket g
    const int w = g < kBucketRows ? g : 0;
    const int64_t mine = first + w * kGroups + sub;
    const T* walk = tile + (w * kGroups + sub) * kStride;
    T acc = T(0);
    for (int c0 = 0; c0 < C; c0 += kBucketCols) {
      int32_t idx[kBucketRows][U];
      T v[kBucketRows][U];
#pragma unroll
      for (int k = 0; k < kBucketRows; ++k)
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int c = c0 + u * G + g;
          idx[k][u] = live[k] && c < C ? __ldg(plan + b[k] * C + c)
                                       : static_cast<int32_t>(F);
        }
#pragma unroll
      for (int k = 0; k < kBucketRows; ++k)
#pragma unroll
        for (int u = 0; u < U; ++u)
          v[k][u] = idx[k][u] < F
                        ? __ldg(lane_rate[k] + (int64_t)idx[k][u] * P)
                        : T(0);
      // the pass's walk: stage the values, then one lane a bucket adds
      // them in column order
#pragma unroll
      for (int k = 0; k < kBucketRows; ++k)
#pragma unroll
        for (int u = 0; u < U; ++u)
          tile[(k * kGroups + sub) * kStride + u * G + g] = v[k][u];
      __syncwarp();
      if (g < kBucketRows) {
        const int m = min(kBucketCols, C - c0);
        int c = 0;
        if (c0 == 0) {
          acc = walk[0];
          c = 1;
        }
        for (; c < m; ++c) acc = acc + walk[c];
      }
      __syncwarp();                           // the stage is free again
      // end of the pass's walk
    }
    if (g < kBucketRows && mine < n) {
      load[mine] = acc;
      frac[mine] = min_(cap[mine] / max_(acc, eps), T(1));
    }
  }
}

// ---- segment_sum: flow-ordered bucket sums over a CSR plan ----------
// The sparse aggregation of the fluid engine: the counterpart of the
// reference's `link_load.py::segment_load` (`jax.ops.segment_sum`) and
// `segment_load_chunk` (`acc.at[k].add`), which XLA computes there.
// CUDA's index_add_ and scatter_add_ apply duplicate updates with
// atomics in whatever order the threads reach them, so a bucket's sum
// would change from run to run and differ from the NumPy engine's
// np.add.at by an ulp, and an ulp in a queue integrator forks a
// trajectory at an ECN threshold.  Here the host's plan (`offsets`,
// K + 1 positions into `entries`; `entries`, flat indices into `vals`)
// lists each bucket's entries in flow order, and one thread takes a
// bucket and adds them one at a time in that order, starting from 0 or,
// with `accumulate`, from the bucket's current value in `out`: a chunk
// of the flow axis continues the chain of the chunks before it, so a
// fold over chunks is the one chain of the whole sum (a chunk never
// forms a partial sum of its own and adds it once: that rounds
// otherwise).  The loads run ahead of the adds: kSegAhead entries'
// indices, then their values, are in flight before the first of them is
// added.  One launch covers up to kMaxSegGroup (vals, plan, out)
// entries (a slot's two host sums and its pair or link sums), passed by
// value as bottleneck's are; the grid covers the entries' summed bucket
// count.  A bucket's chain is as long as its entries, so a skewed plan
// leaves its long buckets to single threads.
constexpr int kMaxSegGroup = 6;
constexpr int kSegAhead = 8;

template <typename T>
struct SegmentGroup {
  const T* vals[kMaxSegGroup];
  const int32_t* offsets[kMaxSegGroup];
  const int32_t* entries[kMaxSegGroup];
  T* out[kMaxSegGroup];
  int64_t start[kMaxSegGroup];  // entry k's buckets: [start[k], start[k + 1])
  int64_t total;
  int count;
  int accumulate;
};

template <typename T>
__global__ void segment_sum_kernel(const SegmentGroup<T> g) {
  GRID_STRIDE(i, g.total) {
    const T* v = g.vals[0];
    const int32_t* off = g.offsets[0];
    const int32_t* ent = g.entries[0];
    T* o = g.out[0];
    int64_t base = 0;
#pragma unroll
    for (int k = 1; k < kMaxSegGroup; ++k) {
      if (k < g.count && i >= g.start[k]) {
        v = g.vals[k];
        off = g.offsets[k];
        ent = g.entries[k];
        o = g.out[k];
        base = g.start[k];
      }
    }
    const int64_t b = i - base;
    int32_t e = __ldg(off + b);
    const int32_t end = __ldg(off + b + 1);
    T s = g.accumulate ? o[b] : T(0);
    for (; e + kSegAhead <= end; e += kSegAhead) {
      int32_t idx[kSegAhead];
      T x[kSegAhead];
#pragma unroll
      for (int j = 0; j < kSegAhead; ++j) idx[j] = __ldg(ent + e + j);
#pragma unroll
      for (int j = 0; j < kSegAhead; ++j) x[j] = __ldg(v + idx[j]);
#pragma unroll
      for (int j = 0; j < kSegAhead; ++j) s = s + x[j];
    }
    for (; e < end; ++e) s = s + __ldg(v + __ldg(ent + e));
    o[b] = s;
  }
}

// ---- per-packet decisions (float32, uint32 hash) ---------------------
// The hashed tie-break of both kernels: the low 16 bits of
// mix ^ (mix >> 16), mix = h * 2654435761 + lane * step (uint32 wrap),
// scaled to [0, 1).
__device__ __forceinline__ float hash_tie(uint32_t h, uint32_t lane,
                                          uint32_t step) {
  uint32_t mix = h * 2654435761u + lane * step;
  mix ^= mix >> 16;
  return static_cast<float>(mix & 0xFFFFu) / 65536.0f;
}

// jsq_route: queues/up/w (ports,) float32, hash (N,), port (N,) int32.
// Each block first scores every port into shared memory (quantized
// queue over weight, +1e30 where down), then a group of kJsqLanes lanes
// of one warp takes a packet: lane g walks the ports j = g (mod
// kJsqLanes) and keeps its first port of least score + 0.5 x tie, and
// the group reduces the (value, port) pairs by shuffles, the lower port
// winning an equal value, so the result is the first port of least
// value, as argmin's.  Operations bound it: ports hash-and-compare steps
// per packet against 4 + 4 bytes moved.  The first kernel, one thread a
// packet, walked all ports in one dependent chain on 16 blocks for 4,096
// packets; groups of lanes cut the chain to ports / kJsqLanes steps and
// fill the card with blocks.
constexpr int kJsqLanes = 16;
static_assert(kJsqLanes >= 1 && kJsqLanes <= 32 && 32 % kJsqLanes == 0,
              "a group divides a warp");

__global__ void jsq_route_kernel(const float* __restrict__ queues,
                                 const float* __restrict__ up,
                                 const float* __restrict__ w,
                                 const uint32_t* __restrict__ hash,
                                 int32_t* __restrict__ port, int64_t N,
                                 int ports, float qmax, float nbins,
                                 float hi) {
  constexpr int kPerBlock = kThreads / kJsqLanes;   // packets a pass
  extern __shared__ float score[];
  const int sub = threadIdx.x / kJsqLanes, g = threadIdx.x % kJsqLanes;
  const int64_t step = (int64_t)gridDim.x * kPerBlock;
  int64_t base = blockIdx.x * (int64_t)kPerBlock;
  // the first pass's hash is in flight while the scores are staged
  uint32_t h = base + sub < N ? hash[base + sub] : 0u;
  for (int j = threadIdx.x; j < ports; j += blockDim.x) {
    const float qbin = floorf(clip_(queues[j] / qmax, 0.0f, hi) * nbins);
    const float s = (qbin + 1.0f) / max_(w[j], static_cast<float>(1e-6));
    score[j] = up[j] > 0.0f ? s : static_cast<float>(1e30);
  }
  __syncthreads();
  // every lane of a block takes the same number of passes, so the
  // shuffles see whole warps
  for (; base < N; base += step) {
    const int64_t n = base + sub;
    int best = ports;
    float best_v = INFINITY;
    for (int j = g; j < ports; j += kJsqLanes) {
      const float v = score[j] + hash_tie(h, j, 40503u) * 0.5f;
      if (v < best_v) {
        best = j;
        best_v = v;
      }
    }
#pragma unroll
    for (int off = kJsqLanes / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best_v, off);
      const int oj = __shfl_xor_sync(0xffffffffu, best, off);
      if (ov < best_v || (ov == best_v && oj < best)) {
        best = oj;
        best_v = ov;
      }
    }
    if (n < N && g == 0) port[n] = best;
    h = n + step < N ? hash[n + step] : 0u;
  }
}

// ---- plb_select: one thread a packet, P known at compile time -------
// rate/elig/queue (P,) float32, tx (N,) float32, hash (N,), plane (N,)
// int32: the rate filter (allowance >= the packet's rate, falling back
// to every eligible plane), then the first plane of least
// queue + 1e-3 x tie (1e30 where filtered out).  4,096 packets move 48
// KB, 15 ns at the HBM rate: the launch and one round trip to memory
// bound it.  The first kernel, with P read at run time, loaded the
// plane vectors inside guarded plane loops, after its packet loads and
// twice for `elig`.  Here each thread loads the plane vectors once,
// beside its first packet's loads, and the planes the registry uses
// (P = 1, 2, 4) are a template parameter, so the plane loops unroll
// with no guards (other P in 1-8 read P at run time).  Timed side by
// side on the H100 (benchmarks/torch_plb_select_designs.py; PERF.md,
// section 6), this took the launch floor; blocks of 32 to 256 threads
// and 2 or 4 packets a thread in 8- or 16-byte accesses moved it by
// less than the spread between runs.

// one packet's plane over planes p < P of NP (P == NP when the planes
// are known at compile time, and the guards fold away)
template <int NP>
__device__ __forceinline__ int32_t plb_plane(const float (&rate)[NP],
                                             const bool (&elig)[NP],
                                             const float (&queue)[NP],
                                             int P, float t, uint32_t h) {
  bool ok[NP];
  bool any_ok = false;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    ok[p] = p < P && elig[p] && rate[p] >= t;
    any_ok = any_ok || ok[p];
  }
  int32_t best = 0;
  float best_v = 0.0f;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    if (p < P) {
      const bool sel = any_ok ? ok[p] : elig[p];
      const float v =
          sel ? queue[p] + static_cast<float>(1e-3) * hash_tie(h, p, 97u)
              : static_cast<float>(1e30);
      if (p == 0 || v < best_v) {
        best = p;
        best_v = v;
      }
    }
  }
  return best;
}

// one thread a packet; the planes at compile time (NP = 1, 2, 4) or
// at run time (NP = 0, P <= kMaxPlanes)
template <int NP>
__global__ void plb_select_kernel(const float* __restrict__ rate,
                                  const float* __restrict__ elig,
                                  const float* __restrict__ queue,
                                  const float* __restrict__ tx,
                                  const uint32_t* __restrict__ hash,
                                  int32_t* __restrict__ plane, int64_t N,
                                  int P_rt) {
  constexpr int M = NP > 0 ? NP : kMaxPlanes;
  const int P = NP > 0 ? NP : P_rt;
  float r[M], q[M];
  bool e[M];
#pragma unroll
  for (int p = 0; p < M; ++p) {
    const bool in = NP > 0 || p < P;
    r[p] = in ? __ldg(rate + p) : 0.0f;
    q[p] = in ? __ldg(queue + p) : 0.0f;
    e[p] = in && __ldg(elig + p) > 0.0f;
  }
  GRID_STRIDE(n, N) {
    plane[n] = plb_plane<M>(r, e, q, P, __ldg(tx + n), __ldg(hash + n));
  }
}

template <typename T, int MODE>
void launch_split_planes(const T* r, const uint8_t* e, const T* d, T* o,
                         int64_t F, int P, T thresh, T fallback,
                         cudaStream_t s) {
  const unsigned g = grid_for(F);
  switch (P) {
    case 1:
      plane_split_kernel<T, MODE, 1><<<g, kThreads, 0, s>>>(
          r, e, d, o, F, P, thresh, fallback);
      break;
    case 2:
      plane_split_kernel<T, MODE, 2><<<g, kThreads, 0, s>>>(
          r, e, d, o, F, P, thresh, fallback);
      break;
    case 4:
      plane_split_kernel<T, MODE, 4><<<g, kThreads, 0, s>>>(
          r, e, d, o, F, P, thresh, fallback);
      break;
    default:
      plane_split_kernel<T, MODE, 0><<<g, kThreads, 0, s>>>(
          r, e, d, o, F, P, thresh, fallback);
  }
}

template <typename T>
int launch_plane_split(const void* rate, const void* elig,
                       const void* demand, void* out, int64_t F, int P,
                       int mode, double thresh, double fallback,
                       void* stream) {
  if (P < 1 || P > kMaxPlanes) return cudaErrorInvalidValue;
  if (F == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* r = static_cast<const T*>(rate);
  const uint8_t* e = static_cast<const uint8_t*>(elig);
  const T* d = static_cast<const T*>(demand);
  T* o = static_cast<T*>(out);
  switch (mode) {
    case kSpx:
      launch_split_planes<T, kSpx>(r, e, d, o, F, P, T(thresh),
                                   T(fallback), s);
      break;
    case kDcqcn:
      launch_split_planes<T, kDcqcn>(r, e, d, o, F, P, T(thresh),
                                     T(fallback), s);
      break;
    case kAgg:
      launch_split_planes<T, kAgg>(r, e, d, o, F, P, T(thresh),
                                   T(fallback), s);
      break;
    case kSwlb:
      launch_split_planes<T, kSwlb>(r, e, d, o, F, P, T(thresh),
                                    T(fallback), s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T, int G>
int launch_pair_fractions_warp(const T* q, const T* cap, const T* w,
                               T* out, int64_t R, int S, T hi, T qmax,
                               T nbins, T temperature, T inv_qmax,
                               T inv_temperature, cudaStream_t s) {
  constexpr int64_t kBlockRows =
      (kThreads / 32) * kPairUnroll * (32 / G);   // one tile per warp
  int64_t blocks = (R + kBlockRows - 1) / kBlockRows;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  pair_fractions_warp_kernel<T, G>
      <<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
          q, cap, w, out, R, S, hi, qmax, nbins, temperature, inv_qmax,
          inv_temperature);
  return cudaGetLastError();
}

// 1 / x when x is a power of two whose reciprocal is a normal T (then
// multiplying by it rounds exactly as dividing by x does), else 0.
template <typename T>
T exact_reciprocal(T x) {
  int e = 0;
  const T m = std::frexp(x, &e);
  const T inv = T(1) / x;
  return (m == T(0.5) || m == T(-0.5)) && std::isnormal(inv) ? inv : T(0);
}

template <typename T>
int launch_pair_fractions(const void* q_, const void* cap_, const void* w_,
                          void* out_, int64_t R, int S, double hi_,
                          double qmax_, double nbins_, double temperature_,
                          void* stream) {
  if (S < 1 || S > 1024) return cudaErrorInvalidValue;
  if (R == 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* q = static_cast<const T*>(q_);
  const T* cap = static_cast<const T*>(cap_);
  const T* w = static_cast<const T*>(w_);
  T* out = static_cast<T*>(out_);
  const T hi = T(hi_), qmax = T(qmax_), nbins = T(nbins_),
          temperature = T(temperature_);
  const T inv_qmax = exact_reciprocal(qmax),
          inv_temperature = exact_reciprocal(temperature);
#define PAIR_WARP(G)                                                    \
  return launch_pair_fractions_warp<T, G>(q, cap, w, out, R, S, hi, qmax, \
                                          nbins, temperature, inv_qmax,  \
                                          inv_temperature, st)
  if (S == 1) PAIR_WARP(1);
  if (S == 2) PAIR_WARP(2);
  if (S <= 4) PAIR_WARP(4);
  if (S <= 8) PAIR_WARP(8);
  if (S <= 16) PAIR_WARP(16);
  if (S <= 32) PAIR_WARP(32);
#undef PAIR_WARP
  const int rows = S >= kThreads ? 1 : kThreads / S;
  const int threads = rows * S;
  int64_t blocks = (R + rows - 1) / rows;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  pair_fractions_kernel<T><<<static_cast<unsigned>(blocks), threads,
                             threads * sizeof(T), st>>>(
      q, cap, w, out, R, S, rows, hi, qmax, nbins, temperature, inv_qmax,
      inv_temperature);
  return cudaGetLastError();
}

template <typename T>
int launch_bottleneck(const void* const* cap, const void* const* load,
                      void* const* out, const int64_t* n, int count,
                      double eps, void* stream) {
  if (count < 1 || count > kMaxGroup) return cudaErrorInvalidValue;
  BottleneckGroup<T> g{};
  int64_t total = 0;
  for (int k = 0; k < count; ++k) {
    if (n[k] < 0) return cudaErrorInvalidValue;
    g.cap[k] = static_cast<const T*>(cap[k]);
    g.load[k] = static_cast<const T*>(load[k]);
    g.out[k] = static_cast<T*>(out[k]);
    g.start[k] = total;
    total += n[k];
  }
  g.total = total;
  g.count = count;
  if (total == 0) return cudaSuccess;
  bottleneck_kernel<T><<<grid_for(total), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(g, T(eps));
  return cudaGetLastError();
}

template <typename T>
int launch_bucket_load_bottleneck(const void* rate, const void* plan,
                                  const void* cap, void* load, void* frac,
                                  int64_t B, int64_t F, int P, int64_t R,
                                  int C, double eps, void* stream) {
  if (B < 0 || P < 1 || C < 1) return cudaErrorInvalidValue;
  if (B == 0 || R == 0) return cudaSuccess;
  // kThreads / kBucketLanes * kBucketRows buckets a block: a giga plan's
  // 16,384 buckets make 512 blocks, all resident at once on 132 SMs
  constexpr int64_t kPerBlock = kThreads / kBucketLanes * kBucketRows;
  int64_t blocks = (B * P * R + kPerBlock - 1) / kPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  bucket_load_bottleneck_kernel<T><<<static_cast<unsigned>(blocks),
                                     kThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(rate), static_cast<const int32_t*>(plan),
      static_cast<const T*>(cap), static_cast<T*>(load),
      static_cast<T*>(frac), B, F, P, R, C, T(eps));
  return cudaGetLastError();
}

template <typename T>
int launch_segment_sum(const void* const* vals, const void* const* offsets,
                       const void* const* entries, void* const* out,
                       const int64_t* n, int count, int accumulate,
                       void* stream) {
  if (count < 1 || count > kMaxSegGroup) return cudaErrorInvalidValue;
  SegmentGroup<T> g{};
  int64_t total = 0;
  for (int k = 0; k < count; ++k) {
    if (n[k] < 0) return cudaErrorInvalidValue;
    g.vals[k] = static_cast<const T*>(vals[k]);
    g.offsets[k] = static_cast<const int32_t*>(offsets[k]);
    g.entries[k] = static_cast<const int32_t*>(entries[k]);
    g.out[k] = static_cast<T*>(out[k]);
    g.start[k] = total;
    total += n[k];
  }
  g.total = total;
  g.count = count;
  g.accumulate = accumulate != 0;
  if (total == 0) return cudaSuccess;
  segment_sum_kernel<T><<<grid_for(total), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(g);
  return cudaGetLastError();
}

template <typename T>
int launch_queue_update(const void* const* q, const void* const* load,
                        const void* const* cap, void* const* q_new,
                        void* const* util, const int64_t* n, int count,
                        double q_cap, double eps, void* stream) {
  if (count < 1 || count > kMaxQueueGroup) return cudaErrorInvalidValue;
  QueueGroup<T> g{};
  int64_t total = 0;
  for (int k = 0; k < count; ++k) {
    if (n[k] < 0) return cudaErrorInvalidValue;
    g.q[k] = static_cast<const T*>(q[k]);
    g.load[k] = static_cast<const T*>(load[k]);
    g.cap[k] = static_cast<const T*>(cap[k]);
    g.q_new[k] = static_cast<T*>(q_new[k]);
    g.util[k] = static_cast<T*>(util[k]);
    g.start[k] = total;
    total += n[k];
  }
  g.total = total;
  g.count = count;
  if (total == 0) return cudaSuccess;
  queue_update_kernel<T><<<grid_for(total), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      g, T(q_cap), T(eps));
  return cudaGetLastError();
}

template <typename T>
int launch_nic_update(const void* qmean, const void* rate,
                      const void* alpha, const void* esr, void* rtt,
                      void* ecn, void* rate_new, void* alpha_new,
                      int64_t F, int P, int mode, const double* k,
                      void* stream) {
  if (P < 1 || P > kMaxPlanes) return cudaErrorInvalidValue;
  if (F == 0) return cudaSuccess;
  const NicConsts<T> c{T(k[0]), T(k[1]), T(k[2]), T(k[3]), T(k[4]),
                       T(k[5]), T(k[6]), T(k[7]), T(k[8]), T(k[9]),
                       T(k[10]), T(k[11]), T(k[12]), T(k[13])};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned g = grid_for(F);
  const T* qm = static_cast<const T*>(qmean);
  const T* r = static_cast<const T*>(rate);
  const T* a = static_cast<const T*>(alpha);
  const uint8_t* e = static_cast<const uint8_t*>(esr);
  T* o0 = static_cast<T*>(rtt);
  T* o1 = static_cast<T*>(ecn);
  T* o2 = static_cast<T*>(rate_new);
  T* o3 = static_cast<T*>(alpha_new);
  switch (mode) {
    case kNicSpx:
      nic_update_kernel<T, kNicSpx><<<g, kThreads, 0, s>>>(
          qm, r, a, e, o0, o1, o2, o3, F, P, c);
      break;
    case kNicDcqcn:
      nic_update_kernel<T, kNicDcqcn><<<g, kThreads, 0, s>>>(
          qm, r, a, e, o0, o1, o2, o3, F, P, c);
      break;
    case kNicAgg:
      nic_update_kernel<T, kNicAgg><<<g, kThreads, 0, s>>>(
          qm, r, a, e, o0, o1, o2, o3, F, P, c);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

int launch_jsq_route(const void* queues, const void* up, const void* w,
                     const void* hash, void* port, int64_t N, int ports,
                     double qmax, double nbins, double hi, void* stream) {
  if (ports < 1 || ports > 8192) return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
  constexpr int64_t kPerBlock = kThreads / kJsqLanes;
  int64_t blocks = (N + kPerBlock - 1) / kPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  jsq_route_kernel<<<static_cast<unsigned>(blocks), kThreads,
                     ports * sizeof(float),
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(queues), static_cast<const float*>(up),
      static_cast<const float*>(w), static_cast<const uint32_t*>(hash),
      static_cast<int32_t*>(port), N, ports, static_cast<float>(qmax),
      static_cast<float>(nbins), static_cast<float>(hi));
  return cudaGetLastError();
}

int launch_plb_select(const void* rate_, const void* elig_,
                      const void* queue_, const void* tx_,
                      const void* hash_, void* plane_, int64_t N, int P,
                      void* stream) {
  if (P < 1 || P > kMaxPlanes) return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned g = grid_for(N);
  const float* rate = static_cast<const float*>(rate_);
  const float* elig = static_cast<const float*>(elig_);
  const float* queue = static_cast<const float*>(queue_);
  const float* tx = static_cast<const float*>(tx_);
  const uint32_t* hash = static_cast<const uint32_t*>(hash_);
  int32_t* plane = static_cast<int32_t*>(plane_);
  switch (P) {
    case 1:
      plb_select_kernel<1><<<g, kThreads, 0, s>>>(rate, elig, queue, tx,
                                                  hash, plane, N, P);
      break;
    case 2:
      plb_select_kernel<2><<<g, kThreads, 0, s>>>(rate, elig, queue, tx,
                                                  hash, plane, N, P);
      break;
    case 4:
      plb_select_kernel<4><<<g, kThreads, 0, s>>>(rate, elig, queue, tx,
                                                  hash, plane, N, P);
      break;
    default:
      plb_select_kernel<0><<<g, kThreads, 0, s>>>(rate, elig, queue, tx,
                                                  hash, plane, N, P);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int netsim_jsq_route_f32(const void* queues, const void* up,
                                    const void* w, const void* hash,
                                    void* port, int64_t N, int ports,
                                    double qmax, double nbins, double hi,
                                    void* stream) {
  return launch_jsq_route(queues, up, w, hash, port, N, ports, qmax, nbins,
                          hi, stream);
}

extern "C" int netsim_plb_select_f32(const void* rate, const void* elig,
                                     const void* queue, const void* tx,
                                     const void* hash, void* plane,
                                     int64_t N, int P, void* stream) {
  return launch_plb_select(rate, elig, queue, tx, hash, plane, N, P,
                           stream);
}

#define NETSIM_EXPORT(SUFFIX, T)                                          \
  extern "C" int netsim_plane_split_##SUFFIX(                             \
      const void* rate, const void* elig, const void* demand, void* out,  \
      int64_t F, int P, int mode, double thresh, double fallback,         \
      void* stream) {                                                     \
    return launch_plane_split<T>(rate, elig, demand, out, F, P, mode,     \
                                 thresh, fallback, stream);               \
  }                                                                       \
  extern "C" int netsim_pair_fractions_##SUFFIX(                          \
      const void* q, const void* cap, const void* w, void* out,           \
      int64_t R, int S, double hi, double qmax, double nbins,             \
      double temperature, void* stream) {                                 \
    return launch_pair_fractions<T>(q, cap, w, out, R, S, hi, qmax,       \
                                    nbins, temperature, stream);          \
  }                                                                       \
  extern "C" int netsim_bottleneck_##SUFFIX(                              \
      const void* const* cap, const void* const* load, void* const* out,  \
      const int64_t* n, int count, double eps, void* stream) {            \
    return launch_bottleneck<T>(cap, load, out, n, count, eps, stream);   \
  }                                                                       \
  extern "C" int netsim_bucket_load_bottleneck_##SUFFIX(                  \
      const void* rate, const void* plan, const void* cap, void* load,    \
      void* frac, int64_t B, int64_t F, int P, int64_t R, int C,          \
      double eps, void* stream) {                                         \
    return launch_bucket_load_bottleneck<T>(rate, plan, cap, load, frac,  \
                                            B, F, P, R, C, eps, stream);  \
  }                                                                       \
  extern "C" int netsim_segment_sum_##SUFFIX(                             \
      const void* const* vals, const void* const* offsets,                \
      const void* const* entries, void* const* out, const int64_t* n,     \
      int count, int accumulate, void* stream) {                          \
    return launch_segment_sum<T>(vals, offsets, entries, out, n, count,   \
                                 accumulate, stream);                     \
  }                                                                       \
  extern "C" int netsim_queue_update_##SUFFIX(                            \
      const void* const* q, const void* const* load,                      \
      const void* const* cap, void* const* q_new, void* const* util,      \
      const int64_t* n, int count, double q_cap, double eps,              \
      void* stream) {                                                     \
    return launch_queue_update<T>(q, load, cap, q_new, util, n, count,    \
                                  q_cap, eps, stream);                    \
  }                                                                       \
  extern "C" int netsim_nic_update_##SUFFIX(                              \
      const void* qmean, const void* rate, const void* alpha,             \
      const void* esr, void* rtt, void* ecn, void* rate_new,              \
      void* alpha_new, int64_t F, int P, int mode, const double* k,       \
      void* stream) {                                                     \
    return launch_nic_update<T>(qmean, rate, alpha, esr, rtt, ecn,        \
                                rate_new, alpha_new, F, P, mode, k,       \
                                stream);                                  \
  }

NETSIM_EXPORT(f32, float)
NETSIM_EXPORT(f64, double)
