// Kernels of the model side, for Hopper (sm_90a).
//
// Four kernels, each the CUDA twin of one Pallas kernel of the JAX
// package (in `repro/kernels/`) and of one plain PyTorch function in
// `kernels/ref.py`, and the backward of the first:
//
//   flash_attention     <- flash_attention.py  _flash_kernel
//   decode_attention    <- decode_attention.py _decode_kernel
//   int8_encode         <- int8_codec.py       _encode_kernel
//   int8_decode         <- int8_codec.py       _decode_kernel
//   flash_attention_bwd    replaces no TPU kernel: the gradient of the
//                          first, which the reference takes by autodiff
//                          of its pure-JAX chunked_attention; three
//                          kernels (delta, dK/dV, dQ) on mma.sync, bf16
//                          and 3xTF32 (its own section below)
//
// Both flash_attention kernels write each row's log-sum-exp beside the
// output, always: the backward reads it.
//
// flash_attention is bound by operations (4 D flops per unmasked
// query-key pair), which only the tensor cores deliver: 989 TFLOP/s in
// bf16 and 495 in TF32, against 67 in float32 on CUDA cores.  A
// llama3-8b prefill (4096 tokens, causal, 32 heads, head_dim 128) is 137
// GFLOP: 0.139 ms in bf16 on the tensor cores, 0.83 ms as three TF32
// products, 2.05 ms on CUDA cores.  Two kernels:
//
// * bf16 (flash_attention_wgmma_kernel): warp-specialised for Hopper.
//   A block owns 128 query rows of one (batch, head) and has three
//   warpgroups.  One thread of the third (the producer, which gives its
//   registers away with setmaxnreg) brings Q in once and the K and V
//   tiles of BK keys (128 at head_dim <= 128, 64 above) through a ring of
//   two stages in shared memory, by TMA with 128-byte swizzle, each stage
//   guarded by full and free mbarriers, K of tile i requested ahead of V
//   of tile i - 1.
//   The two consumer warpgroups own 64 query rows each.  S = Q K^T is a
//   wgmma chain (A = Q and B = K both K-major in shared memory); P,
//   rounded to bf16 in place, is the register A operand of O += P V,
//   whose B = V is MN-major (the descriptor's transpose bit).  Step i
//   starts S_i and O += P_{i-1} V_{i-1} together and runs the online
//   softmax of S_i on the accumulator fragment (a row lives in the 4
//   threads of a quad) while the second product is on the tensor cores.
//   P in bf16 is the usual flash-attention trade against the Pallas
//   kernel's f32 P; the sums stay f32 and the row sums add the rounded
//   P.  The causal and window masks run only on the tiles that cross the
//   diagonal, the window's edge or the ragged tail; TMA zero-fills rows
//   past the end.  Shared memory: 160 / 144 / 192 KiB at head_dim 128 /
//   192 / 256, one block per SM; blocks are ordered heavy causal tiles
//   first across all heads.  Registers: the consumers take 240 a thread
//   (at head_dim 256 the output accumulator alone is 128); ptxas keeps
//   every wgmma chain asynchronous only while no path it cannot rule out
//   writes an accumulator in flight (hence the first tile is peeled) and
//   the waits carry no time-out.
// * float32 (flash_attention_tf32_kernel): the tensor cores in split
//   "3xTF32".  One TF32 product keeps 11 bits of each operand, too few
//   for the 1e-4 tolerance; each float32 operand x is split into
//   hi = tf32(x) and lo = tf32(x - hi) (both cut by a mask: cvt.rna
//   took a third more time), and a b is summed as lo_a hi_b +
//   hi_a lo_b + hi_a hi_b (mma.sync m16n8k8, float32 accumulators),
//   about 2^-20 of each product off.  The tensor cores' float32 adds
//   cut rather than round, so a long chain of them drifts toward zero:
//   S sums chunks of 32 head_dim columns, and P V one key tile, in
//   chains of their own, joined by float32 adds (O = O x correction +
//   tile sum, one fmaf), which took the error at a llama3-8b prefill
//   from 7e-6 to 3e-6.  A
//   block of 8 warps owns 128 query rows of one (batch, head), a warp
//   16 of them, and walks the key tiles (64 keys at head_dim <= 128, 16
//   above) in a loop, which takes the place of the Pallas grid's
//   sequential k axis: Q and a ring of two K and V stages sit in shared
//   memory, filled by cp.async, tile i + 1 in flight while tile i is
//   multiplied.  Each warp splits its fragments as it reads them; S
//   stays in the accumulator fragment, where the online softmax (in
//   log2 units, exp2) reduces a row over the 4 lanes of a quad, and
//   becomes the A fragment of P V with no trip through shared memory,
//   since each k step takes its 8 columns in the order 0, 2, 4, 6, 1,
//   3, 5, 7.  Registers (up to 255 a thread) hold the block to one an
//   SM, and the kernel runs at about a third of the three products'
//   peak (PERF.md, section 6).
//
// Both skip the key tiles that no row of the block may see, unless some
// row of the block sees no key at all: that row averages v uniformly, as
// the reference does, so it needs every tile.  GQA reads kv head
// h / (Hq / Hkv); strides let one kernel read (B, H, S, D) and
// (B, S, H, D) without a copy.
//
// decode_attention, int8_encode and int8_decode are bound by bytes.
// decode splits each (batch, head) row into chunks of 256 keys, one
// block each, reads only the keys below lengths[b] (all of them for a
// row of length 0, which averages v), and writes a partial (max, sum,
// acc); a second pass per (batch, head) combines the chunks.  It reads
// q, k and v through strides and kv head h / (H / Hkv), so the model's
// (B, S, Hkv, D) ring cache is read in place (decode_attention_bshd),
// with no copy of the kv heads; the (B, H, S, D) entry is Hkv = H.  The
// encoder runs one block a row and reads the row once, from registers
// or shared memory by its length (the int8 codec section): a
// max-reduce of |x|, the scale as a true IEEE division, then rintf
// (round half to even) of x / scale + noise.
//
// Masked scores are the finite NEG_INF = -1e30, as in the reference;
// keys past the end of a tile (ragged tails) score -inf and weigh 0.
// Built with --fmad=false like the other kernels: the CUDA-core
// multiply-adds are explicit fmaf (wgmma and mma are not touched by the
// flag); the codec has no multiply-add.
//
// Plain C interface (loaded with ctypes): every entry point takes raw
// pointers and the CUDA stream, launches on that stream, allocates
// nothing (decode's partials arrive from the caller), and returns
// cudaGetLastError() so the caller sees a refused launch.  The bf16
// flash entry point encodes its three TMA descriptors on the host at
// each call (cuTensorMapEncodeTiled, fetched through
// cudaGetDriverEntryPointByVersion, so the library needs no -lcuda) and
// passes them by value: no sync, no allocation, capturable in a graph.

#include <cstdint>
#include <type_traits>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

// E consecutive elements at p (aligned to E * sizeof(T) bytes, at most
// 16) into float registers, in one vector load.
template <typename T, int E>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&out)[E]) {
  constexpr int kBytes = E * sizeof(T);
  static_assert(kBytes == 4 || kBytes == 8 || kBytes == 12 ||
                kBytes == 16 || kBytes == 24 || kBytes == 32,
                "vector width");
  alignas(16) T tmp[E];
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i)
      reinterpret_cast<uint4*>(tmp)[i] =
          __ldg(reinterpret_cast<const uint4*>(p) + i);
  } else if constexpr (kBytes % 8 == 0) {
#pragma unroll
    for (int i = 0; i < kBytes / 8; ++i)
      reinterpret_cast<uint2*>(tmp)[i] =
          __ldg(reinterpret_cast<const uint2*>(p) + i);
  } else {
#pragma unroll
    for (int i = 0; i < kBytes / 4; ++i)
      reinterpret_cast<uint32_t*>(tmp)[i] =
          __ldg(reinterpret_cast<const uint32_t*>(p) + i);
  }
#pragma unroll
  for (int i = 0; i < E; ++i) out[i] = to_float(tmp[i]);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---- flash_attention, float32 (3xTF32 on the tensor cores) ------------
// Tiles: kTfWarps warps of 16 query rows each own a block's rows; key
// tiles of tf_bk(D) keys pass through a ring of kTfStages stages.
constexpr int kTfWarps = 8;
constexpr int kTfBkNarrow = 64;       // keys a tile at head_dim <= 128
constexpr int kTfBkWide = 16;         // ... above
constexpr int kTfStages = 2;
// head_dim steps of 8 whose products one chain of S sums before they
// join S in a float32 add (the tensor cores' adds cut, so long chains
// drift toward zero); D / 8 or more: one chain
constexpr int kTfSChunk = 4;
// chains of P V (column steps of 8 of a key tile) run interleaved
constexpr int kTfColGroups = 8;

__host__ __device__ constexpr int tf_bk(int D) {
  return D <= 128 ? kTfBkNarrow : kTfBkWide;
}
// row strides in shared memory (floats): Q and K are read as float2
// (bank 8 g + 2 t for quad lane t of row g), V as floats (bank 8 t + g)
__host__ __device__ constexpr int tf_qk_stride(int D) { return D + 8; }
__host__ __device__ constexpr int tf_v_stride(int D) { return D + 4; }

template <int D>
constexpr int tf_smem_bytes() {
  return (16 * kTfWarps * tf_qk_stride(D) +
          kTfStages * tf_bk(D) * (tf_qk_stride(D) + tf_v_stride(D))) * 4;
}

struct FlashArgs {
  int64_t q_b, q_h, q_s;   // strides of q and o (elements)
  int64_t k_b, k_h, k_s;   // strides of k and v
  int Hq, group, Sq, Sk;   // group = Hq / Hkv
  int causal, window;
  float scale;
  float* lse;              // (B, Hq, Sq) log-sum-exp of each row
};

constexpr float kLn2 = 0.6931471805599453f;

// The natural log-sum-exp of a row's scaled scores from the online
// softmax's running max m and sum l, both in log2 units (l = sum of
// 2^(x - m)); a row that saw no key (m still NEG_INF) gets NEG_INF,
// its masked scores' value.
__device__ __forceinline__ float row_lse(float m, float l) {
  return m <= kNegInf ? kNegInf : m * kLn2 + logf(l);
}

// 16 bytes from global to shared memory by cp.async; zeros when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// rows [0, ROWS) x D of `src` (row stride `stride`, the first n_rows
// valid, the rest zero) into shared memory at dst, rows STRIDE floats
// apart
template <int D, int ROWS, int STRIDE>
__device__ __forceinline__ void copy_rows(uint32_t dst,
                                          const float* __restrict__ src,
                                          int64_t stride, int n_rows) {
  constexpr int kVecs = D / 4;
  constexpr int kThreads = 32 * kTfWarps;
  static_assert(ROWS * kVecs % kThreads == 0, "whole passes");
#pragma unroll
  for (int it = 0; it < ROWS * kVecs / kThreads; ++it) {
    const int idx = it * kThreads + threadIdx.x;
    const int r = idx / kVecs, c = (idx % kVecs) * 4;
    const bool ok = r < n_rows;
    cp_async16(dst + (r * STRIDE + c) * 4, src + (ok ? r : 0) * stride + c,
               ok);
  }
}

// x = hi + lo, both TF32 (float32 with the low 13 mantissa bits zero),
// each cut from the bits above it by a mask: x - hi is exact in
// float32, so the error is lo's own cut, below 2^-20 |x|.  Rounding
// both halves by cvt.rna (2^-22) took a third more time (PERF.md,
// section 6), for an error the tolerance does not need.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xFFFFE000u;
}

// d += a b on the tensor cores: a 16 x 8 (row), b 8 x 8 (col), TF32
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b to float32 accuracy: the small products first, then hi hi
// (lo lo, below 2^-20 of the product, is left out)
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// d += a b on the tensor cores: a 16 x 16 (row), b 16 x 8 (col), bf16;
// the fragments of m16n8k16 for lane (g, t): A holds (g, 2t..2t+1),
// (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..); B (2t..2t+1, g) and
// (2t + 8.., g); C as m16n8k8's
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// four 8 x 8 matrices of 16-bit elements from shared memory, lanes 8 i
// to 8 i + 7 giving the row addresses of matrix i: lane (g, t) gets
// row g, columns 2t and 2t + 1 of each (of the transpose with TRANS)
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            uint32_t addr) {
  if constexpr (TRANS)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
        "{%0, %1, %2, %3}, [%4];"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
}

// two floats rounded to bf16, lo in the low half (the lower index)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 4 bytes from global to shared memory by cp.async; zero when !valid
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N groups of this thread's copies are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The fragments of m16n8k8, for lane (g, t) = (lane / 4, lane % 4): A
// holds (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B (t, g) and
// (t + 4, g); C (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).  The
// k index of a product is a sum, so each k step of 8 takes its columns
// in the order 0, 2, 4, 6, 1, 3, 5, 7: A's (g, t) and (g, t + 4) are
// then columns 2t and 2t + 1, which S's accumulator (C) holds for P V
// and one float2 of Q (or K) holds for Q K^T.
template <int D>
__global__ void __launch_bounds__(32 * kTfWarps)
flash_attention_tf32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            float* __restrict__ o, FlashArgs a) {
  constexpr int BQ = 16 * kTfWarps, BK = tf_bk(D);
  constexpr int QS = tf_qk_stride(D), KS = tf_qk_stride(D);
  constexpr int VS = tf_v_stride(D);
  constexpr int NT = BK / 8, DT = D / 8;      // key and head_dim steps
  extern __shared__ float4 tf_smem_v4[];      // 16-byte aligned
  float* qs = reinterpret_cast<float*>(tf_smem_v4);   // [BQ][QS]
  float* ks = qs + BQ * QS;                   // [stage][BK][KS]
  float* vs = ks + kTfStages * BK * KS;       // [stage][BK][VS]

  const int qtile = gridDim.x - 1 - blockIdx.x;   // heavy causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / a.Hq, h = bh % a.Hq, hk = h / a.group;
  const int q0 = qtile * BQ;
  const int q_rows = min(BQ, a.Sq - q0);
  const float* qp = q + b * a.q_b + h * a.q_h + q0 * a.q_s;
  const float* kp = k + b * a.k_b + hk * a.k_h;
  const float* vp = v + b * a.k_b + hk * a.k_h;

  // key tiles any row of the block may see, and whether every row sees
  // at least one key (then the tiles outside can be skipped)
  const int q_last = q0 + q_rows - 1;
  int k_lo = 0, k_hi = a.Sk;
  if (a.window > 0) k_lo = max(0, q0 - a.window + 1);
  if (a.causal) k_hi = min(a.Sk, q_last + 1);
  const int last_lo = a.window > 0 ? max(0, q_last - a.window + 1) : 0;
  const int last_hi = a.causal ? min(q_last, a.Sk - 1) : a.Sk - 1;
  const bool all_live = last_lo <= last_hi;
  const int t_begin = all_live ? k_lo / BK : 0;
  const int n = (all_live ? (k_hi + BK - 1) / BK : (a.Sk + BK - 1) / BK) -
                t_begin;                      // tiles to walk (>= 1)

  auto load_kv = [&](int i) {
    const int k0 = (t_begin + i) * BK, s = i % kTfStages;
    const int rows = min(BK, a.Sk - k0);
    copy_rows<D, BK, KS>(smem_addr(ks + s * BK * KS), kp + k0 * a.k_s,
                         a.k_s, rows);
    copy_rows<D, BK, VS>(smem_addr(vs + s * BK * VS), vp + k0 * a.k_s,
                         a.k_s, rows);
  };
  copy_rows<D, BQ, QS>(smem_addr(qs), qp, a.q_s, q_rows);
  load_kv(0);
  asm volatile("cp.async.commit_group;" ::: "memory");

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int first = q0 + 16 * warp, last = first + 15;  // the warp's rows
  const int row_lo = first + g;               // and row_lo + 8
  const float scale_log2 = a.scale * kLog2e;
  const float* qw = qs + (16 * warp + g) * QS + 2 * t;

  float acc[DT][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) {                          // tile i + 1 in flight
      load_kv(i + 1);
      asm volatile("cp.async.commit_group;" ::: "memory");
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();                          // tile i visible to all
    const float* kt = ks + (i % kTfStages) * BK * KS + g * KS + 2 * t;
    const float* vt = vs + (i % kTfStages) * BK * VS + 2 * t * VS + g;

    // S = Q K^T: a step of 8 along D takes Q's float2 (2t, 2t + 1) of
    // rows g and g + 8, and K's of key 8 j + g; each chunk of kTfSChunk
    // steps sums in a chain of its own
    constexpr int kChunk = kTfSChunk < DT ? kTfSChunk : DT;
    static_assert(DT % kChunk == 0, "whole chunks");
    float sc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll 1
    for (int k8 = 0; k8 < DT; k8 += kChunk) {
      float part[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll
      for (int kk = k8; kk < k8 + kChunk; ++kk) {
        const float2 x0 = *reinterpret_cast<const float2*>(qw + 8 * kk);
        const float2 x1 =
            *reinterpret_cast<const float2*>(qw + 8 * QS + 8 * kk);
        uint32_t ah[4], al[4];
        split_tf32(x0.x, ah[0], al[0]);
        split_tf32(x1.x, ah[1], al[1]);
        split_tf32(x0.y, ah[2], al[2]);
        split_tf32(x1.y, ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float2 y =
              *reinterpret_cast<const float2*>(kt + 8 * j * KS + 8 * kk);
          uint32_t bh_[2], bl[2];
          split_tf32(y.x, bh_[0], bl[0]);
          split_tf32(y.y, bh_[1], bl[1]);
          mma_3xtf32(part[j], ah, al, bh_, bl);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] += part[j][e];
    }

    // the online softmax in log2 units; a row lives in the 4 lanes of a
    // quad, element e of sc[j] in row g + 8 (e / 2), key 8 j + 2t + e % 2
    const int k0 = (t_begin + i) * BK;
    const bool whole = k0 + BK <= a.Sk &&
        (!a.causal || k0 + BK - 1 <= first) &&
        (a.window <= 0 || last - k0 < a.window);
    float mt[2] = {-INFINITY, -INFINITY}, rs[2] = {0.f, 0.f}, corr[2];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[j][e] * scale_log2;
        if (!whole) {
          const int row = row_lo + 8 * (e / 2);
          const int col = k0 + 8 * j + 2 * t + e % 2;
          if ((a.causal && row < col) ||
              (a.window > 0 && row - col >= a.window))
            x = kNegInf;
          if (col >= a.Sk) x = -INFINITY;
        }
        sc[j][e] = x;
        mt[e / 2] = fmaxf(mt[e / 2], x);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float m_new = fmaxf(m[r], mt[r]);
      corr[r] = fast_exp2(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = fast_exp2(sc[j][e] - m[e / 2]);
        rs[e / 2] += sc[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = fmaf(l[r], corr[r], rs[r]);

    // O += P V: key step j takes P's (g, 2t), (g + 8, 2t), (g, 2t + 1),
    // (g + 8, 2t + 1) from sc[j] and V's keys 8 j + 2t and 8 j + 2t + 1
    uint32_t ph[NT][4], pl[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      split_tf32(sc[j][0], ph[j][0], pl[j][0]);
      split_tf32(sc[j][2], ph[j][1], pl[j][1]);
      split_tf32(sc[j][1], ph[j][2], pl[j][2]);
      split_tf32(sc[j][3], ph[j][3], pl[j][3]);
    }
    // each key tile's P V sums in chains of its own, added to O by one
    // fmaf: O = O x correction + (P V)_tile
    constexpr int CG = kTfColGroups < DT ? kTfColGroups : DT;
    static_assert(DT % CG == 0, "whole groups");
#pragma unroll
    for (int c0 = 0; c0 < DT; c0 += CG) {
      float part[CG][4];
#pragma unroll
      for (int c = 0; c < CG; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[c][e] = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < CG; ++c) {
          const float* vj = vt + 8 * j * VS + 8 * (c0 + c);
          uint32_t bh_[2], bl[2];
          split_tf32(vj[0], bh_[0], bl[0]);
          split_tf32(vj[VS], bh_[1], bl[1]);
          mma_3xtf32(part[c], ph[j], pl[j], bh_, bl);
        }
#pragma unroll
      for (int c = 0; c < CG; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[c0 + c][e] = fmaf(acc[c0 + c][e], corr[e / 2], part[c][e]);
    }
    __syncthreads();                          // stage i % 2 free again
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  float* op = o + b * a.q_b + h * a.q_h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    if (row >= a.Sq) continue;
    if (t == 0)
      a.lse[(static_cast<int64_t>(bh) * a.Sq) + row] = row_lse(m[r], l[r]);
#pragma unroll
    for (int c = 0; c < DT; ++c)
      *reinterpret_cast<float2*>(op + row * a.q_s + 8 * c + 2 * t) =
          make_float2(acc[c][2 * r] / l[r], acc[c][2 * r + 1] / l[r]);
  }
}

template <int D>
int launch_flash_f32(const void* q, const void* k, const void* v, void* o,
                     int B, const FlashArgs& a, void* stream) {
  constexpr int kSmem = tf_smem_bytes<D>();
  auto kernel = flash_attention_tf32_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  constexpr int BQ = 16 * kTfWarps;
  const dim3 grid((a.Sq + BQ - 1) / BQ, B * a.Hq);
  kernel<<<grid, 32 * kTfWarps, kSmem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), a);
  return cudaGetLastError();
}

// ---- flash_attention, bf16 (wgmma + TMA) -------------------------------
constexpr int kWgBQ = 128;            // query rows per block
// keys per tile: the score and probability fragments (BK / 2 and BK / 4
// registers) fit beside the D / 2 of the output accumulator while both
// products are in flight, and two stages of K and V beside Q in shared
// memory
__host__ __device__ constexpr int wg_bk(int D) {
  return D <= 128 ? 128 : 64;
}
constexpr int kWgThreads = 384;       // consumer warpgroups 0-1, producer 2
constexpr int kConsumerWarps = 8;
constexpr int kBoxCols = 64;          // bf16 columns of a 128-byte TMA box

constexpr int kStages = 2;            // K/V ring (a third gained nothing)

// shared memory: Q [D/64][128][64], K and V [stage][D/64][BK][64] (each
// [rows][64] block is TMA's 128-byte-swizzled box), then 1 + 4 kStages
// mbarriers; 1 KiB of slack to align the base to the swizzle atom
template <int D>
constexpr int wg_smem_bytes() {
  return (kWgBQ + 2 * kStages * wg_bk(D)) * D * 2 + (1 + 4 * kStages) * 8 +
         1024;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// wait for the phase of parity `parity` to complete.  A plain spin: a
// time-out that traps (clock64, __trap) made ptxas hold the consumers to
// the launch's 168 registers and spill.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// one TMA box of the 4-D map (D, S, H, B) at (c0, c1, c2, c3) into
// shared memory; completion counts its bytes on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptors for 128-byte-swizzled tiles whose rows
// are 64 bf16 (128 B) and whose 8-row atoms are 1024 B apart (the stride
// byte offset).  K-major (Q, K): the leading byte offset is unused.
// MN-major (V): the leading byte offset is the step from one 64-column
// block to the next.  The start address sits in the low bits in 16-byte
// units, so a descriptor plus bytes / 16 addresses a later part of the
// same tile.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
// keep the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it
template <int N>
__device__ __forceinline__ void wg_fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// accumulator operand lists of the wgmma wrappers below: %i in the
// instruction, "+f"(d[i]) in the constraints
#define WG_D0_31                                                            \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "       \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "       \
  "%28, %29, %30, %31"
#define WG_D32_63                                                           \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, "       \
  "%45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "       \
  "%58, %59, %60, %61, %62, %63"
#define WG_D64_95                                                           \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, "       \
  "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "       \
  "%90, %91, %92, %93, %94, %95"
#define WG_D96_127                                                          \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "    \
  "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, "      \
  "%119, %120, %121, %122, %123, %124, %125, %126, %127"
#define WG_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_F16(i) WG_F4(i), WG_F4(i + 4), WG_F4(i + 8), WG_F4(i + 12)
#define WG_F32(i) WG_F16(i), WG_F16(i + 16)

// S[64 x N] = (acc ? S : 0) + A[64 x 16] B[16 x N], A and B K-major in
// shared memory (descriptors da, db)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_D0_31
      "}, %32, %33, p, 1, 1, 0, 0;\n}"
      : WG_F32(0)
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_D0_31
      ", " WG_D32_63 "}, %64, %65, p, 1, 1, 0, 0;\n}"
      : WG_F32(0), WG_F32(32)
      : "l"(da), "l"(db), "r"(acc));
}
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int acc) {
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, acc);
  else wgmma_ss_n128(d, da, db, acc);
}
// O[64 x N] += A[64 x 16] B[16 x N], A in registers (4 bf16 pairs a
// thread), B MN-major in shared memory (the last 1: transposed B)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_D0_31
      "}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;"
      : WG_F32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_D0_31
      ", " WG_D32_63 "}, {%64, %65, %66, %67}, %68, 1, 1, 1, 1;"
      : WG_F32(0), WG_F32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {" WG_D0_31
      ", " WG_D32_63 ", " WG_D64_95
      "}, {%96, %97, %98, %99}, %100, 1, 1, 1, 1;"
      : WG_F32(0), WG_F32(32), WG_F32(64)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" WG_D0_31
      ", " WG_D32_63 ", " WG_D64_95 ", " WG_D96_127
      "}, {%128, %129, %130, %131}, %132, 1, 1, 1, 1;"
      : WG_F32(0), WG_F32(32), WG_F32(64), WG_F32(96)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}
#undef WG_F32
#undef WG_F16
#undef WG_F4
#undef WG_D0_31
#undef WG_D32_63
#undef WG_D64_95
#undef WG_D96_127

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else if constexpr (N == 192) wgmma_rs_n192(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

// The accumulator fragment of a 64 x N wgmma: thread t of the warpgroup
// holds rows 16 (t / 32) + (t % 32) / 4 (`lo`) and that + 8 (`hi`);
// element i sits in row hi when bit 1 of i is set, at column
// 8 (i / 4) + 2 (t % 4) + i % 2.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             __nv_bfloat16* __restrict__ o, FlashArgs a) {
  constexpr int BK = wg_bk(D);
  constexpr int kBlocks = D / kBoxCols;           // 64-column blocks
  constexpr uint32_t kQBytes = kWgBQ * D * 2;
  constexpr uint32_t kTileBytes = BK * D * 2;     // one K or V tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sk = sq + kQBytes;
  const uint32_t sv = sk + kStages * kTileBytes;
  // mbarriers: Q full, then per stage K full, V full, K free, V free
  const uint32_t bars = sv + kStages * kTileBytes;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 + 32 * s; };
  auto v_full = [&](int s) { return bars + 16 + 32 * s; };
  auto k_free = [&](int s) { return bars + 24 + 32 * s; };
  auto v_free = [&](int s) { return bars + 32 + 32 * s; };

  const int qtile = gridDim.y - 1 - blockIdx.y;   // heavy causal tiles first
  const int bh = blockIdx.x;
  const int b = bh / a.Hq, h = bh % a.Hq, hk = h / a.group;
  const int q0 = qtile * kWgBQ;

  // key tiles any row of the block may see, and whether every row sees
  // at least one key (then the tiles outside can be skipped)
  const int q_last = min(q0 + kWgBQ, a.Sq) - 1;
  int k_lo = 0, k_hi = a.Sk;
  if (a.window > 0) k_lo = max(0, q0 - a.window + 1);
  if (a.causal) k_hi = min(a.Sk, q_last + 1);
  const int last_lo = a.window > 0 ? max(0, q_last - a.window + 1) : 0;
  const int last_hi = a.causal ? min(q_last, a.Sk - 1) : a.Sk - 1;
  const bool all_live = last_lo <= last_hi;
  const int t_begin = all_live ? k_lo / BK : 0;
  const int n = (all_live ? (k_hi + BK - 1) / BK : (a.Sk + BK - 1) / BK) -
                t_begin;                          // tiles to walk

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_free(s), kConsumerWarps);
      mbar_init(v_free(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread makes every TMA load, K of tile i ahead
    // of V of tile i - 1, the order in which the consumers use them ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 256) {
      auto load = [&](const CUtensorMap* map, uint32_t dst, uint32_t full,
                      uint32_t empty, int i) {
        mbar_wait(empty, ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full, kTileBytes);
        for (int c = 0; c < kBlocks; ++c)
          tma_load(dst + c * BK * 128, map, full, c * kBoxCols,
                   (t_begin + i) * BK, hk, b);
      };
      mbar_expect_tx(q_full, kQBytes);
      for (int c = 0; c < kBlocks; ++c)
        tma_load(sq + c * kWgBQ * 128, &tq, q_full, c * kBoxCols, q0, h, b);
      for (int i = 0; i <= n; ++i) {
        const int s = i % kStages, sp = (i + kStages - 1) % kStages;
        if (i < n)
          load(&tk, sk + s * kTileBytes, k_full(s), k_free(s), i);
        if (i > 0)
          load(&tv, sv + sp * kTileBytes, v_full(sp), v_free(sp), i - 1);
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup.  Step i starts
    // S_i = Q K_i^T and O += P_{i-1} V_{i-1} together and runs the
    // softmax of S_i while the second product is on the tensor cores ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int tid = threadIdx.x % 128, lane = tid % 32;
    const int first = q0 + wg * 64, last = first + 63;
    const int row_lo = first + 16 * (tid / 32) + lane / 4;
    const float scale_log2 = a.scale * kLog2e;
    float acc[D / 2], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
    uint32_t pa[BK / 16][4];                      // P_{i-1}, bf16 pairs
    const uint64_t dq = wg_desc(sq + wg * 64 * 128, 16);  // this WG's rows
    mbar_wait(q_full, 0);

    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // S_i = Q K_i^T into sc, started and committed
    auto start_s = [&](int i, float (&sc)[BK / 2]) {
      const int s = i % kStages;
      const uint64_t dk = wg_desc(sk + s * kTileBytes, 16);
      mbar_wait(k_full(s), (i / kStages) & 1);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {       // 16 columns of D each
        const int c = kk / 4, off = (kk % 4) * 32;
        wgmma_ss<BK>(sc, dq + (c * kWgBQ * 128 + off) / 16,
                     dk + (c * BK * 128 + off) / 16, kk > 0);
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    };
    // O += P_{i-1} V_{i-1} (P in pa), started and committed
    auto start_pv = [&](int i) {
      const int s = i % kStages;
      const uint64_t dv = wg_desc(sv + s * kTileBytes, BK * 128);
      mbar_wait(v_full(s), (i / kStages) & 1);
      wg_fence_regs(acc);             // the rescale of O lands before
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)        // 16 keys each
        wgmma_rs<D>(acc, pa[kk], dv + kk * 16 * 128 / 16);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    };
    // the online softmax of tile i: sc becomes P_i, rounded to bf16 (the
    // row sums add the rounded values, the weights P V applies); corr
    // gets the factors that rescale O and l to the new row maxima
    auto softmax = [&](int i, float (&sc)[BK / 2], float (&corr)[2]) {
      const int k0 = (t_begin + i) * BK;
      // a tile every row of the warpgroup sees whole needs no mask
      const bool whole = k0 + BK <= a.Sk &&
          (!a.causal || k0 + BK - 1 <= first) &&
          (a.window <= 0 || last - k0 < a.window);
      float mt[2] = {-INFINITY, -INFINITY}, rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {          // scores in log2 units
        float x = sc[j] * scale_log2;
        if (!whole) {
          const int row = row_lo + 8 * ((j / 2) % 2);
          const int col = k0 + 8 * (j / 4) + 2 * (lane % 4) + j % 2;
          if ((a.causal && row < col) ||
              (a.window > 0 && row - col >= a.window))
            x = kNegInf;
          if (col >= a.Sk) x = -INFINITY;
        }
        sc[j] = x;
        mt[(j / 2) % 2] = fmaxf(mt[(j / 2) % 2], x);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
        const float m_new = fmaxf(m[r], mt[r]);
        corr[r] = fast_exp2(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        sc[j] = __bfloat162float(
            __float2bfloat16_rn(fast_exp2(sc[j] - m[(j / 2) % 2])));
        rs[(j / 2) % 2] += sc[j];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = fmaf(l[r], corr[r], rs[r]);
    };
    // P_i as the A fragments of P V: scores j = 8 kk .. 8 kk + 7 are keys
    // 16 kk .. 16 kk + 15
    auto pack = [&](const float (&sc)[BK / 2]) {
#pragma unroll
      for (int j = 0; j < BK / 2; j += 2) {
        const __nv_bfloat162 pb = __floats2bfloat162_rn(sc[j], sc[j + 1]);
        pa[j / 8][(j % 8) / 2] = *reinterpret_cast<const uint32_t*>(&pb);
      }
    };

    {                                             // tile 0: O is still 0
      float sc[BK / 2], corr[2];
      start_s(0, sc);
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      wg_fence_regs(sc);
      release(k_free(0));
      softmax(0, sc, corr);
      pack(sc);
    }
    // every wait below is unconditional: ptxas serialises the wgmmas when
    // some path it cannot rule out writes O while P V is in flight
    for (int i = 1; i < n; ++i) {
      float sc[BK / 2], corr[2];
      start_s(i, sc);
      start_pv(i - 1);
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      wg_fence_regs(sc);
      release(k_free(i % kStages));
      softmax(i, sc, corr);                       // while P V runs
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      wg_fence_regs(acc);
      release(v_free((i - 1) % kStages));
      pack(sc);
#pragma unroll
      for (int j = 0; j < D / 2; ++j) acc[j] *= corr[(j / 2) % 2];
    }
    start_pv(n - 1);
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    wg_fence_regs(acc);
    release(v_free((n - 1) % kStages));

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = fmaxf(l[r], 1e-30f);
    }
    __nv_bfloat16* op = o + b * a.q_b + h * a.q_h;
    if (lane % 4 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_lo + 8 * r;
        if (row < a.Sq)
          a.lse[static_cast<int64_t>(bh) * a.Sq + row] = row_lse(m[r], l[r]);
      }
    }
#pragma unroll
    for (int j = 0; j < D / 2; j += 2) {
      const int r = (j / 2) % 2, row = row_lo + 8 * r;
      const int col = 8 * (j / 4) + 2 * (lane % 4);
      if (row < a.Sq)
        *reinterpret_cast<__nv_bfloat162*>(op + row * a.q_s + col) =
            __floats2bfloat162_rn(acc[j] / l[r], acc[j + 1] / l[r]);
    }
  }
}

// cuTensorMapEncodeTiled from libcuda, looked up once
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// the 4-D map (D, S, H, B) of a bf16 tensor with element strides s_st,
// h_st, b_st (d contiguous), read in boxes of 64 columns x `rows` rows
// with 128-byte swizzle; rows past S read as zeros
bool encode_map(CUtensorMap* map, const void* ptr, int D, int S, int H,
                int B, int64_t s_st, int64_t h_st, int64_t b_st,
                int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s_st) * 2,
                                 static_cast<cuuint64_t>(h_st) * 2,
                                 static_cast<cuuint64_t>(b_st) * 2};
  const cuuint32_t box[4] = {kBoxCols, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_flash_bf16(const void* q, const void* k, const void* v, void* o,
                      int B, const FlashArgs& a, void* stream) {
  constexpr int kSmem = wg_smem_bytes<D>();
  const int Hkv = a.Hq / a.group;
  CUtensorMap tq, tk, tv;
  if (!encode_map(&tq, q, D, a.Sq, a.Hq, B, a.q_s, a.q_h, a.q_b, kWgBQ) ||
      !encode_map(&tk, k, D, a.Sk, Hkv, B, a.k_s, a.k_h, a.k_b, wg_bk(D)) ||
      !encode_map(&tv, v, D, a.Sk, Hkv, B, a.k_s, a.k_h, a.k_b, wg_bk(D)))
    return cudaErrorInvalidValue;
  auto kernel = flash_attention_wgmma_kernel<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * a.Hq, (a.Sq + kWgBQ - 1) / kWgBQ);
  kernel<<<grid, kWgThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), a);
  return cudaGetLastError();
}

template <typename T, int D>
int launch_flash(const void* q, const void* k, const void* v, void* o,
                 int B, const FlashArgs& a, void* stream) {
  if constexpr (sizeof(T) == 2)
    return launch_flash_bf16<D>(q, k, v, o, B, a, stream);
  else
    return launch_flash_f32<D>(q, k, v, o, B, a, stream);
}

template <typename T>
int dispatch_flash(const void* q, const void* k, const void* v, void* o,
                   int B, int D, const FlashArgs& a, void* stream) {
  switch (D) {
    case 64: return launch_flash<T, 64>(q, k, v, o, B, a, stream);
    case 128: return launch_flash<T, 128>(q, k, v, o, B, a, stream);
    case 192: return launch_flash<T, 192>(q, k, v, o, B, a, stream);
    case 256: return launch_flash<T, 256>(q, k, v, o, B, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---- flash_attention_bwd -----------------------------------------------
// The gradient of flash_attention (dQ, dK, dV from q, k, v, the output
// o, its gradient dO and the forward's log-sum-exp), FlashAttention-2's
// split on the tensor cores.  Three kernels under one entry:
//   delta  one warp a query row: delta = rowsum(dO * o);
//   dk_dv  one block a (batch, kv head, key tile): the K and V tile stay
//          in shared memory while the block walks every query head of
//          its GQA group and every query tile the masks let see its keys
//          (and, under a window, the rows that see no key at all, which
//          average v uniformly and so reach dV with P = 1 / Sk);
//   dq     one block a (batch, query head, tile of 64 query rows): Q and
//          dO stay in shared memory while it walks the key tiles its
//          rows see.
// Operations bound it: 10 D flops a kept pair (0.35 ms for a llama3-8b
// prefill at the bf16 tensor cores' 989 TFLOP/s), which only the tensor
// cores deliver; the split does 14 D, recomputing S and dP in dq.
// Four warps a block, each owning 16 rows of the output: keys in dk_dv,
// queries in dq.  dk_dv computes the transposes S^T = K Q^T and
// dP^T = V dO^T, so the warp's keys are the rows of its accumulators;
// P^T = exp2(S^T scale log2e - lse log2e) and dS^T = P^T (dP^T - delta)
// are taken on the accumulator fragment and are, as they stand, the A
// fragments of dV += P^T dO and dK += dS^T Q (an accumulator's 16 x 8
// tiles j and j + 1 hold the 16 x 16 A fragment of k step j / 2), so
// neither goes through shared memory.  dq does the same with S = Q K^T,
// dP = dO V^T, dS and dQ += dS K.  Each product is mma.sync, float32
// accumulators in registers:
// * bf16: m16n8k16; P and dS rounded to bf16 on the fragment, as row 9
//   rounds its P, every sum float32.  Tiles are bf16 in shared memory
//   with their 16-byte chunks XOR-swizzled by row (chunk c of row r at
//   c ^ (r % 8)), read by ldmatrix (.trans for the B operands taken
//   along their rows: dO and Q in dk_dv, K in dq) with no bank conflict.
// * float32: 3xTF32 on m16n8k8 (split_tf32, mma_3xtf32, as row 9f),
//   tiles as floats with rows D + 4 apart (conflict-free scalar reads),
//   and each k step of 8 queries or keys taking its columns in the order
//   0, 2, 4, 6, 1, 3, 5, 7, so the accumulator is the A fragment.  The
//   tensor cores' adds cut rather than round, so every sum runs in short
//   chains joined by float32 adds: S over 32 head_dim columns, each dV,
//   dK and dQ tile over one query or key step.
// Tiles reach shared memory by 16-byte cp.async in a ring of two
// stages: dk_dv's next Q and dO tile (lse and delta with it) and dq's
// next K and V tile are in flight while this one is multiplied.  At
// head_dim 192 and 256 a warp's dK and dV would not fit in registers, so
// two warps share 16 keys, each accumulating half the columns, and both
// recompute the same S^T and dP^T (18 D flops a kept pair there,
// against 14 D below).  Tiles (keys a dk_dv block / queries a step of
// it; dq: 64 queries / keys a step), and each instance's registers a
// thread (ptxas, no spills) and dynamic shared memory in bytes:
//          bf16                           float32
//          dk_dv            dq            dk_dv            dq
//   D 64   64/64 223 50176  64/64 168 49152   64/16 168 52480  64/32 128 69632
//   D 128  64/32 249 66048  64/64 255 98304   64/16 255 101632 64/16 168 101376
//   D 192  32/32 241 74240  64/32 253 98304   32/16 255 100608 64/16 168 150528
//   D 256  32/16 239 65792  64/16 242 98304   32/16 255 133376 64/16 255 199680
// One step larger spilled: bf16 D 256 with 32 queries (16 bytes) or 32
// keys (80), float32 dq at D 128 with 32 keys (8).
// No atomics: every sum has one owner and one order, so a gradient is
// bitwise repeatable; dQ could instead be summed in dk_dv's walk (FA2's
// atomic add, or an ordered semaphore per query tile) and save the
// recompute of S and dP in dq, 4 D of the 14 D.  Blocks go heavy causal
// tiles first across every head; dK and dQ are scaled once, at the end.
constexpr int kBwdWarps = 4;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kDeltaThreads = 256;          // 8 rows a block

// The tiles, fragments and mma of one element type
template <typename T>
struct BwdMma;

template <>
struct BwdMma<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static constexpr int kK = 16;             // k of one mma
  static constexpr bool kChains = false;    // sums in one chain each
  struct A { uint32_t x[4]; };
  struct B { uint32_t x[2]; };
  // element (r, c) of a tile of rows of D; c % 8 == 0 for a chunk
  template <int D>
  static __device__ __forceinline__ int off(int r, int c) {
    return r * D + ((((c >> 3) ^ r) & 7) | ((c >> 3) & ~7)) * 8 + (c & 7);
  }
  template <int D>
  static constexpr int row_elems() { return D; }
  // A of the 16 x 16 block at (r0, k0) of a row-major tile
  template <int D>
  static __device__ __forceinline__ void load_a(A& a, const T* s, int r0,
                                                int k0) {
    const int lane = threadIdx.x & 31;
    ldmatrix_x4<false>(a.x, smem_addr(s + off<D>(r0 + (lane & 15),
                                                 k0 + (lane >> 4) * 8)));
  }
  // B of the n8 tiles n0 and n0 + 8 at k step k0 from an [n][k] tile
  template <int D>
  static __device__ __forceinline__ void load_b(B (&b)[2], const T* s,
                                                int n0, int k0) {
    const int lane = threadIdx.x & 31;
    uint32_t r[4];
    ldmatrix_x4<false>(r, smem_addr(s + off<D>(
                              n0 + (lane & 7) + ((lane >> 4) << 3),
                              k0 + ((lane >> 3) & 1) * 8)));
    b[0] = {{r[0], r[1]}};
    b[1] = {{r[2], r[3]}};
  }
  // ... from a [k][n] tile
  template <int D>
  static __device__ __forceinline__ void load_bt(B (&b)[2], const T* s,
                                                 int k0, int n0) {
    const int lane = threadIdx.x & 31;
    uint32_t r[4];
    ldmatrix_x4<true>(r, smem_addr(s + off<D>(
                             k0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                             n0 + (lane >> 4) * 8)));
    b[0] = {{r[0], r[1]}};
    b[1] = {{r[2], r[3]}};
  }
  // A of k step i from the 16 x 8 accumulator tiles 2i and 2i + 1,
  // rounded to bf16
  template <int NT>
  static __device__ __forceinline__ void acc_a(A& a, const float (&c)[NT][4],
                                               int i) {
    a.x[0] = pack_bf16(c[2 * i][0], c[2 * i][1]);
    a.x[1] = pack_bf16(c[2 * i][2], c[2 * i][3]);
    a.x[2] = pack_bf16(c[2 * i + 1][0], c[2 * i + 1][1]);
    a.x[3] = pack_bf16(c[2 * i + 1][2], c[2 * i + 1][3]);
  }
  static __device__ __forceinline__ void mma(float (&d)[4], const A& a,
                                             const B& b) {
    mma_bf16(d, a.x, b.x);
  }
};

template <>
struct BwdMma<float> {
  using T = float;
  static constexpr int kK = 8;
  static constexpr bool kChains = true;     // the adds cut: short chains
  static constexpr int kChainSteps = 4;     // k steps of S in one chain
  struct A { uint32_t hi[4], lo[4]; };
  struct B { uint32_t hi[2], lo[2]; };
  template <int D>
  static __device__ __forceinline__ int off(int r, int c) {
    return r * (D + 4) + c;
  }
  template <int D>
  static constexpr int row_elems() { return D + 4; }
  // head_dim steps (load_a, load_b) take their columns in order: A's
  // (g, t) is column k0 + t
  template <int D>
  static __device__ __forceinline__ void load_a(A& a, const T* s, int r0,
                                                int k0) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const T* p = s + off<D>(r0 + g, k0 + t);
    split_tf32(p[0], a.hi[0], a.lo[0]);
    split_tf32(p[8 * (D + 4)], a.hi[1], a.lo[1]);
    split_tf32(p[4], a.hi[2], a.lo[2]);
    split_tf32(p[8 * (D + 4) + 4], a.hi[3], a.lo[3]);
  }
  template <int D>
  static __device__ __forceinline__ void load_b(B (&b)[2], const T* s,
                                                int n0, int k0) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const T* p = s + off<D>(n0 + 8 * i + g, k0 + t);
      split_tf32(p[0], b[i].hi[0], b[i].lo[0]);
      split_tf32(p[4], b[i].hi[1], b[i].lo[1]);
    }
  }
  // query and key steps (acc_a, load_bt) take 0, 2, 4, 6, 1, 3, 5, 7:
  // A's (g, t) and (g, t + 4) are columns 2t and 2t + 1 of the step,
  // where the accumulator holds them; B's (t, g) and (t + 4, g) rows 2t
  // and 2t + 1
  template <int D>
  static __device__ __forceinline__ void load_bt(B (&b)[2], const T* s,
                                                 int k0, int n0) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const T* p = s + off<D>(k0 + 2 * t, n0 + 8 * i + g);
      split_tf32(p[0], b[i].hi[0], b[i].lo[0]);
      split_tf32(p[D + 4], b[i].hi[1], b[i].lo[1]);
    }
  }
  template <int NT>
  static __device__ __forceinline__ void acc_a(A& a, const float (&c)[NT][4],
                                               int i) {
    split_tf32(c[i][0], a.hi[0], a.lo[0]);
    split_tf32(c[i][2], a.hi[1], a.lo[1]);
    split_tf32(c[i][1], a.hi[2], a.lo[2]);
    split_tf32(c[i][3], a.hi[3], a.lo[3]);
  }
  static __device__ __forceinline__ void mma(float (&d)[4], const A& a,
                                             const B& b) {
    mma_3xtf32(d, a.hi, a.lo, b.hi, b.lo);
  }
};

// The tiles of one instance (the table in the section comment)
template <typename T, int D>
struct BwdTiles {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int kSplit = D <= 128 ? 1 : 2;   // warps a 16-key row
  static constexpr int kKeys = 16 * kBwdWarps / kSplit;
  static constexpr int kQStep = !kBf16 || D == 256 ? 16 : D == 64 ? 64 : 32;
  static constexpr int kQRows = 16 * kBwdWarps;
  static constexpr int kKStep = kBf16 ? (D <= 128 ? 64 : D == 192 ? 32 : 16)
                                      : (D == 64 ? 32 : 16);
  static constexpr int kRow = BwdMma<T>::template row_elems<D>();
  static constexpr int smem_dkdv() {        // K, V; 2 x (Q, dO, lse, delta)
    return (2 * kKeys + 4 * kQStep) * kRow * sizeof(T) + 4 * kQStep * 4;
  }
  static constexpr int smem_dq() {          // Q, dO; 2 x (K, V)
    return (2 * kQRows + 4 * kKStep) * kRow * sizeof(T);
  }
};

// rows [0, R) x D of src (row stride `stride`, the first n_rows valid,
// the rest zero) into the tile at dst by 16-byte cp.async
template <typename T, int D, int R>
__device__ __forceinline__ void bwd_copy(T* dst, const T* __restrict__ src,
                                         int64_t stride, int n_rows) {
  constexpr int kPer = 16 / sizeof(T);      // elements a copy
  constexpr int kChunks = R * D / kPer;
  static_assert(kChunks % kBwdThreads == 0, "whole passes");
#pragma unroll
  for (int it = 0; it < kChunks / kBwdThreads; ++it) {
    const int i = it * kBwdThreads + threadIdx.x;
    const int r = i / (D / kPer), c = (i % (D / kPer)) * kPer;
    const bool ok = r < n_rows;
    cp_async16(smem_addr(dst + BwdMma<T>::template off<D>(r, c)),
               src + (ok ? r : 0) * stride + c, ok);
  }
}

// c[j] (+)= A B^T over head_dim: A the 16 rows at r0 of tile as, B^T the
// NT * 8 rows of tile bs (both rows of D); in chains of kChainSteps k
// steps under 3xTF32, each joined to c by a float32 add
template <typename T, int D, int NT>
__device__ __forceinline__ void tile_abt(float (&c)[NT][4], const T* as,
                                        int r0, const T* bs) {
  using M = BwdMma<T>;
  static_assert(NT % 2 == 0, "pairs of n8 tiles");
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
  if constexpr (!M::kChains) {
#pragma unroll
    for (int k0 = 0; k0 < D; k0 += M::kK) {
      typename M::A a;
      M::template load_a<D>(a, as, r0, k0);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        typename M::B b[2];
        M::template load_b<D>(b, bs, 8 * j, k0);
        M::mma(c[j], a, b[0]);
        M::mma(c[j + 1], a, b[1]);
      }
    }
  } else {
    constexpr int kCh = M::kChainSteps * M::kK;
    static_assert(D % kCh == 0, "whole chains");
#pragma unroll 1
    for (int kc = 0; kc < D; kc += kCh) {
      float part[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll
      for (int k0 = kc; k0 < kc + kCh; k0 += M::kK) {
        typename M::A a;
        M::template load_a<D>(a, as, r0, k0);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          typename M::B b[2];
          M::template load_b<D>(b, bs, 8 * j, k0);
          M::mma(part[j], a, b[0]);
          M::mma(part[j + 1], a, b[1]);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[j][e] += part[j][e];
    }
  }
}

// acc[n] += X Y for the NN n8 column tiles at n0 of tile ys ([k][n],
// rows of D): X the A fragments xa of the KT k steps; under 3xTF32 each
// tile's chain over the KT steps joins acc by a float32 add
template <typename T, int D, int KT, int NN>
__device__ __forceinline__ void tile_acc(float (&acc)[NN][4],
                                        const typename BwdMma<T>::A (&xa)[KT],
                                        const T* ys, int n0) {
  using M = BwdMma<T>;
  static_assert(NN % 2 == 0, "pairs of n8 tiles");
#pragma unroll
  for (int n = 0; n < NN; n += 2) {
    float part[2][4] = {};
#pragma unroll
    for (int i = 0; i < KT; ++i) {
      typename M::B b[2];
      M::template load_bt<D>(b, ys, M::kK * i, n0 + 8 * n);
      if constexpr (M::kChains) {
        M::mma(part[0], xa[i], b[0]);
        M::mma(part[1], xa[i], b[1]);
      } else {
        M::mma(acc[n], xa[i], b[0]);
        M::mma(acc[n + 1], xa[i], b[1]);
      }
    }
    if constexpr (M::kChains) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[n][e] += part[0][e];
        acc[n + 1][e] += part[1][e];
      }
    }
  }
}

// two neighbouring elements of a gradient row, scaled
template <typename T>
__device__ __forceinline__ void bwd_store2(T* p, float x, float y) {
  if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  }
}

// whether query row i keeps key j (the forward's masks; both in range)
__device__ __forceinline__ bool bwd_keep(const FlashArgs& a, int i, int j) {
  return i < a.Sq && j < a.Sk && !(a.causal && i < j) &&
         !(a.window > 0 && i - j >= a.window);
}

// a query row that sees no key (only under a window: rows past
// Sk + window - 2) averages v uniformly in the forward
__device__ __forceinline__ bool bwd_empty(const FlashArgs& a, int i) {
  return a.window > 0 && i >= a.Sk + a.window - 1;
}

// whether every query of [q_first, q_last] keeps every key of
// [k_first, k_last] (then no element needs a mask)
__device__ __forceinline__ bool bwd_whole(const FlashArgs& a, int q_first,
                                          int q_last, int k_first,
                                          int k_last) {
  return q_last < a.Sq && k_last < a.Sk && (!a.causal || k_last <= q_first)
      && (a.window <= 0 || q_last - k_first < a.window);
}

template <typename T, int D>
__global__ void __launch_bounds__(kDeltaThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, const FlashArgs a,
                       int64_t rows) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (kDeltaThreads / 32) +
      threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int i = static_cast<int>(row % a.Sq);
  const int64_t bh = row / a.Sq;
  const int h = static_cast<int>(bh % a.Hq), b = static_cast<int>(bh / a.Hq);
  const int64_t off = b * a.q_b + h * a.q_h + i * a.q_s;
  float s = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32)
    s = fmaf(to_float(dout[off + d]), to_float(o[off + d]), s);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  if (lane == 0) delta[row] = s;
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, const FlashArgs a) {
  using M = BwdMma<T>;
  using Tl = BwdTiles<T, D>;
  constexpr int BN = Tl::kKeys, BM = Tl::kQStep, RW = Tl::kRow;
  constexpr int DH = D / Tl::kSplit;        // a warp's columns of dK, dV
  constexpr int KT = BM / M::kK;            // query steps of a tile
  extern __shared__ float4 bwd_smem_v4[];   // 16-byte aligned
  T* ks = reinterpret_cast<T*>(bwd_smem_v4);  // [BN][RW]
  T* vs = ks + BN * RW;
  T* qs = vs + BN * RW;                     // [stage] Q, dO: [BM][RW] each
  float* stats = reinterpret_cast<float*>(qs + 4 * BM * RW);
                                            // [stage] lse, delta: [BM] each

  const int hkv = a.Hq / a.group;
  const int b = blockIdx.x / hkv, hk = blockIdx.x % hkv;
  const int k0 = blockIdx.y * BN;           // heavy causal tiles first
  const int k_rows = min(BN, a.Sk - k0);
  bwd_copy<T, D, BN>(ks, k + b * a.k_b + hk * a.k_h + k0 * a.k_s, a.k_s,
                     k_rows);
  bwd_copy<T, D, BN>(vs, v + b * a.k_b + hk * a.k_h + k0 * a.k_s, a.k_s,
                     k_rows);

  // the (head of the group, query tile) steps, g * n_qt + qt: those with
  // a row that may keep a key of this tile, or that sees no key at all
  const int q_lo = a.causal ? k0 : 0;
  const int q_hi = a.window > 0 ? min(a.Sq, k0 + BN - 1 + a.window) : a.Sq;
  const int e_lo = a.window > 0 ? a.Sk + a.window - 1 : a.Sq;
  const int n_qt = (a.Sq + BM - 1) / BM, total = a.group * n_qt;
  auto next = [&](int i) {
    for (; i < total; ++i) {
      const int q0 = (i % n_qt) * BM, q_end = min(a.Sq, q0 + BM);
      if ((q0 < q_hi && q_end > q_lo) || q_end > e_lo) break;
    }
    return i;
  };
  auto load_q = [&](int i, int s) {
    const int h = hk * a.group + i / n_qt, q0 = (i % n_qt) * BM;
    const int rows = min(BM, a.Sq - q0);
    const int64_t off = b * a.q_b + h * a.q_h + q0 * a.q_s;
    T* qd = qs + s * 2 * BM * RW;
    bwd_copy<T, D, BM>(qd, q + off, a.q_s, rows);
    bwd_copy<T, D, BM>(qd + BM * RW, dout + off, a.q_s, rows);
    const int64_t row0 = (static_cast<int64_t>(b) * a.Hq + h) * a.Sq + q0;
    float* st = stats + s * 2 * BM;
    for (int r = threadIdx.x; r < 2 * BM; r += kBwdThreads) {
      const int rr = r % BM;
      const bool ok = rr < rows;
      cp_async4(smem_addr(st + r), (r < BM ? a.lse : delta) + row0 +
                (ok ? rr : 0), ok);
    }
  };

  int cur = next(0);
  if (cur < total) load_q(cur, 0);
  cp_async_commit();                        // K, V and the first Q tile

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int kw = 16 * (warp / Tl::kSplit);  // the warp's keys in the tile
  const int d0 = DH * (warp % Tl::kSplit);  // and its columns of dK, dV
  const int key = k0 + kw + g;              // accumulator rows g, g + 8
  const float scale_log2 = a.scale * kLog2e;
  const float inv_sk = 1.f / static_cast<float>(a.Sk);
  float dk_acc[DH / 8][4], dv_acc[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int it = 0; cur < total; ++it) {
    const int nxt = next(cur + 1);
    if (nxt < total) {                      // the next Q tile in flight
      load_q(nxt, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                        // this tile visible to all
    const T* qt = qs + (it & 1) * 2 * BM * RW;
    const T* dot = qt + BM * RW;
    const float* lse_s = stats + (it & 1) * 2 * BM;
    const float* del_s = lse_s + BM;
    const int q0 = (cur % n_qt) * BM;

    // S^T and dP^T: the warp's 16 keys x the tile's BM queries; element
    // e of tile j is key `key` + 8 (e / 2), query 8 j + 2t + e % 2
    float st[BM / 8][4], dpt[BM / 8][4];
    tile_abt<T, D, BM / 8>(st, ks, kw, qt);
    tile_abt<T, D, BM / 8>(dpt, vs, kw, dot);
    const bool whole = bwd_whole(a, q0, q0 + BM - 1, k0 + kw, k0 + kw + 15);
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = 8 * j + 2 * t + (e & 1), qi = q0 + ql;
        const int kj = key + 8 * (e >> 1);
        float p = 0.f, ds = 0.f;
        if (whole || bwd_keep(a, qi, kj)) {
          p = fast_exp2(fmaf(st[j][e], scale_log2, -lse_s[ql] * kLog2e));
          ds = p * (dpt[j][e] - del_s[ql]);
        } else if (qi < a.Sq && kj < a.Sk && bwd_empty(a, qi)) {
          p = inv_sk;
        }
        st[j][e] = p;
        dpt[j][e] = ds;
      }
    typename M::A pa[KT], dsa[KT];
#pragma unroll
    for (int i = 0; i < KT; ++i) {
      M::acc_a(pa[i], st, i);
      M::acc_a(dsa[i], dpt, i);
    }
    tile_acc<T, D, KT, DH / 8>(dv_acc, pa, dot, d0);
    tile_acc<T, D, KT, DH / 8>(dk_acc, dsa, qt, d0);
    __syncthreads();                        // reads done before the refill
    cur = nxt;
  }
  cp_async_wait<0>();

  T* dkp = dk + b * a.k_b + hk * a.k_h;
  T* dvp = dv + b * a.k_b + hk * a.k_h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = key + 8 * r;
    if (j >= a.Sk) continue;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      const int64_t o = j * a.k_s + d0 + 8 * n + 2 * t;
      bwd_store2(dkp + o, dk_acc[n][2 * r] * a.scale,
                 dk_acc[n][2 * r + 1] * a.scale);
      bwd_store2(dvp + o, dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    const FlashArgs a) {
  using M = BwdMma<T>;
  using Tl = BwdTiles<T, D>;
  constexpr int BM = Tl::kQRows, BN = Tl::kKStep, RW = Tl::kRow;
  constexpr int KT = BN / M::kK;            // key steps of a tile
  extern __shared__ float4 bwd_smem_v4[];
  T* qs = reinterpret_cast<T*>(bwd_smem_v4);  // [BM][RW]
  T* dos = qs + BM * RW;
  T* kvs = dos + BM * RW;                   // [stage] K, V: [BN][RW] each

  const int b = blockIdx.x / a.Hq, h = blockIdx.x % a.Hq, hk = h / a.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // heavy causal first
  const int q_rows = min(BM, a.Sq - q0);
  const int64_t off = b * a.q_b + h * a.q_h + q0 * a.q_s;
  bwd_copy<T, D, BM>(qs, q + off, a.q_s, q_rows);
  bwd_copy<T, D, BM>(dos, dout + off, a.q_s, q_rows);

  // keys any row of the tile keeps (rows that keep none get no dQ)
  const int q_last = q0 + q_rows - 1;
  const int k_lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int k_hi = a.causal ? min(a.Sk, q_last + 1) : a.Sk;
  const int t_begin = k_lo / BN;
  const int n = k_hi > k_lo ? (k_hi + BN - 1) / BN - t_begin : 0;
  const T* kp = k + b * a.k_b + hk * a.k_h;
  const T* vp = v + b * a.k_b + hk * a.k_h;
  auto load_kv = [&](int i, int s) {
    const int kb = (t_begin + i) * BN, rows = min(BN, a.Sk - kb);
    T* kd = kvs + s * 2 * BN * RW;
    bwd_copy<T, D, BN>(kd, kp + kb * a.k_s, a.k_s, rows);
    bwd_copy<T, D, BN>(kd + BN * RW, vp + kb * a.k_s, a.k_s, rows);
  };
  if (n > 0) load_kv(0, 0);
  cp_async_commit();                        // Q, dO and the first K, V

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int qw = 16 * warp;                 // the warp's rows in the tile
  const int row = q0 + qw + g;              // accumulator rows g, g + 8
  const int64_t row0 = static_cast<int64_t>(b * a.Hq + h) * a.Sq;
  float lse2[2], del[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = row + 8 * r < a.Sq;
    lse2[r] = ok ? a.lse[row0 + row + 8 * r] * kLog2e : 0.f;
    del[r] = ok ? delta[row0 + row + 8 * r] : 0.f;
  }
  const float scale_log2 = a.scale * kLog2e;
  float acc[D / 8][4];
#pragma unroll
  for (int c = 0; c < D / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;

  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) {                        // the next K, V tile in flight
      load_kv(i + 1, (i + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* kt = kvs + (i & 1) * 2 * BN * RW;
    const T* vt = kt + BN * RW;
    const int kb = (t_begin + i) * BN;

    // S and dP: the warp's 16 rows x the tile's BN keys; element e of
    // tile j is row `row` + 8 (e / 2), key kb + 8 j + 2t + e % 2
    float s[BN / 8][4], dp[BN / 8][4];
    tile_abt<T, D, BN / 8>(s, qs, qw, kt);
    tile_abt<T, D, BN / 8>(dp, dos, qw, vt);
    const bool whole = bwd_whole(a, q0 + qw, q0 + qw + 15, kb, kb + BN - 1);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float ds = 0.f;
        if (whole || bwd_keep(a, row + 8 * r, kb + 8 * j + 2 * t + (e & 1))) {
          const float p = fast_exp2(fmaf(s[j][e], scale_log2, -lse2[r]));
          ds = p * (dp[j][e] - del[r]);
        }
        s[j][e] = ds;
      }
    typename M::A dsa[KT];
#pragma unroll
    for (int c = 0; c < KT; ++c) M::acc_a(dsa[c], s, c);
    tile_acc<T, D, KT, D / 8>(acc, dsa, kt, 0);
    __syncthreads();                        // reads done before the refill
  }
  cp_async_wait<0>();

  T* dqp = dq + b * a.q_b + h * a.q_h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row + 8 * r;
    if (i >= a.Sq) continue;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      bwd_store2(dqp + i * a.q_s + 8 * c + 2 * t, acc[c][2 * r] * a.scale,
                 acc[c][2 * r + 1] * a.scale);
  }
}

template <typename T, int D>
int launch_flash_bwd(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, void* delta, void* dq,
                     void* dk, void* dv, int B, const FlashArgs& a,
                     void* stream) {
  using Tl = BwdTiles<T, D>;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  float* fdelta = static_cast<float*>(delta);
  const int64_t rows = static_cast<int64_t>(B) * a.Hq * a.Sq;
  constexpr int kRowsABlock = kDeltaThreads / 32;
  flash_bwd_delta_kernel<T, D><<<(rows + kRowsABlock - 1) / kRowsABlock,
                                 kDeltaThreads, 0, st>>>(
      static_cast<const T*>(o), tdo, fdelta, a, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dkdv = flash_bwd_dkdv_kernel<T, D>;
  constexpr int kSmemKV = Tl::smem_dkdv();
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemKV);
  if (err != cudaSuccess) return err;
  const int Hkv = a.Hq / a.group;
  dkdv<<<dim3(B * Hkv, (a.Sk + Tl::kKeys - 1) / Tl::kKeys), kBwdThreads,
         kSmemKV, st>>>(tq, tk, tv, tdo, fdelta, static_cast<T*>(dk),
                        static_cast<T*>(dv), a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dqk = flash_bwd_dq_kernel<T, D>;
  constexpr int kSmemQ = Tl::smem_dq();
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemQ);
  if (err != cudaSuccess) return err;
  dqk<<<dim3(B * a.Hq, (a.Sq + Tl::kQRows - 1) / Tl::kQRows), kBwdThreads,
        kSmemQ, st>>>(tq, tk, tv, tdo, fdelta, static_cast<T*>(dq), a);
  return cudaGetLastError();
}

template <typename T>
int dispatch_flash_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, void* delta,
                       void* dq, void* dk, void* dv, int B, int D,
                       const FlashArgs& a, void* stream) {
  switch (D) {
    case 64:
      return launch_flash_bwd<T, 64>(q, k, v, o, dout, delta, dq, dk, dv, B,
                                     a, stream);
    case 128:
      return launch_flash_bwd<T, 128>(q, k, v, o, dout, delta, dq, dk, dv,
                                      B, a, stream);
    case 192:
      return launch_flash_bwd<T, 192>(q, k, v, o, dout, delta, dq, dk, dv,
                                      B, a, stream);
    case 256:
      return launch_flash_bwd<T, 256>(q, k, v, o, dout, delta, dq, dk, dv,
                                      B, a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---- decode_attention -------------------------------------------------
constexpr int kChunk = 256;         // keys per block
constexpr int kDecThreads = 256;    // 8 warps
constexpr int kDecWarps = kDecThreads / 32;
static_assert(kDecThreads == kChunk, "one score per thread");

__device__ __forceinline__ int valid_keys(int len, int S) {
  // keys a row reads: those below its length, or all of them for a row
  // of length <= 0 (every score NEG_INF: the uniform mean of v)
  return len > 0 ? min(len, S) : S;
}

template <int N>
__device__ __forceinline__ float block_reduce(float x, bool is_max,
                                              float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, off);
    x = is_max ? fmaxf(x, y) : x + y;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int w = 1; w < N / 32; ++w) x = is_max ? fmaxf(x, red[w]) : x + red[w];
  __syncthreads();                  // red is free again
  return x;
}

// Element strides of q, k and v and the head grouping: query head h of
// batch row b reads q at b * q_b + h * q_h and kv head h / G, whose key
// i sits at b * k_b + (h / G) * k_h + i * k_s (v alike).  The (B, H, S,
// D) entry is G = 1 with contiguous strides; the model's (B, S, Hkv, D)
// ring cache is read in place through them, with no copy of the kv
// heads.  Every stride is a multiple of 16 bytes (the wrapper checks),
// so each lane's row slice stays aligned for load_vec.  The contiguous
// (B, H, S, D) layout keeps an instance of its own (kContig) whose
// strides follow from D at compile time: through run-time strides its
// chip_smoke decode case read 3-4% slower (PERF.md, section 6).
struct DecodeArgs {
  int64_t q_b, q_h, k_b, k_h, k_s, v_b, v_h, v_s;
  int H, G, S;
  float scale;
};

template <typename T, int D, bool kContig>
__global__ void __launch_bounds__(kDecThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const int32_t* __restrict__ lengths,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_acc, const DecodeArgs a) {
  constexpr int E = D / 32;         // elements of a row per lane
  __shared__ float ps[kChunk];
  __shared__ float red[kDecWarps];
  __shared__ float accw[kDecWarps][D];

  const int split = blockIdx.x, n_split = gridDim.x;
  const int bh = blockIdx.y, b = bh / a.H, h = bh - b * a.H;
  const int kvh = h / a.G;
  const int len = lengths[b];
  const int n = valid_keys(len, a.S);
  const int k0 = split * kChunk;
  if (k0 >= n) return;              // the combine pass skips this chunk
  const int kend = min(k0 + kChunk, n);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t row = (int64_t)bh * a.S * D;    // kContig: (b, h)'s rows
  const T* kb =
      (kContig ? k + row : k + b * a.k_b + kvh * a.k_h) + lane * E;
  const T* vb =
      (kContig ? v + row : v + b * a.v_b + kvh * a.v_h) + lane * E;
  const int64_t k_s = kContig ? D : a.k_s, v_s = kContig ? D : a.v_s;
  const float scale = a.scale;

  float qv[E];
  load_vec<T, E>((kContig ? q + (int64_t)bh * D : q + b * a.q_b + h * a.q_h)
                     + lane * E, qv);

  // scores: a warp per key, lanes across D, four keys in flight; a
  // warp's rows are kDecWarps keys apart, so its row pointer advances
  // by a fixed step (no 64-bit multiply by the run-time stride a key)
  const int64_t k_step = kDecWarps * k_s;
  const T* krow = kb + (k0 + warp) * k_s;
  for (int kk = warp; kk < kChunk; kk += 4 * kDecWarps,
           krow += 4 * k_step) {
    float dot[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int key = k0 + kk + u * kDecWarps;
      dot[u] = 0.f;
      if (key < kend) {
        float kv[E];
        load_vec<T, E>(krow + u * k_step, kv);
#pragma unroll
        for (int e = 0; e < E; ++e) dot[u] = fmaf(qv[e], kv[e], dot[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        dot[u] += __shfl_xor_sync(0xffffffffu, dot[u], off);
      const int key = k0 + kk + u * kDecWarps;
      if (lane == 0 && kk + u * kDecWarps < kChunk)
        ps[kk + u * kDecWarps] =
            key >= kend ? -INFINITY
                        : (key >= len ? kNegInf : dot[u] * scale);
    }
  }
  __syncthreads();

  const float s = ps[threadIdx.x];
  const float m = block_reduce<kDecThreads>(s, true, red);
  const float p = expf(s - m);
  ps[threadIdx.x] = p;
  const float l = block_reduce<kDecThreads>(p, false, red);  // syncs ps

  // p-weighted sum of v rows: a warp per key, lanes across D
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  const int64_t v_step = kDecWarps * v_s;
  const T* vrow = vb + (k0 + warp) * v_s;
  for (int kk = warp; kk < kend - k0; kk += 4 * kDecWarps,
           vrow += 4 * v_step) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = kk + u * kDecWarps;
      if (c < kend - k0) {
        float vv[E];
        load_vec<T, E>(vrow + u * v_step, vv);
        const float pc = ps[c];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] = fmaf(pc, vv[e], acc[e]);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) accw[warp][lane * E + e] = acc[e];
  __syncthreads();
  const int64_t part = (int64_t)bh * n_split + split;
  for (int d = threadIdx.x; d < D; d += kDecThreads) {
    float x = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) x += accw[w][d];
    part_acc[part * D + d] = x;
  }
  if (threadIdx.x == 0) {
    part_m[part] = m;
    part_l[part] = l;
  }
}

template <typename T, int D>
__global__ void decode_combine_kernel(const int32_t* __restrict__ lengths,
                                      const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      const float* __restrict__ part_acc,
                                      T* __restrict__ out, int H, int S,
                                      int n_split) {
  const int bh = blockIdx.x, b = bh / H;
  const int n = valid_keys(lengths[b], S);
  const int used = (n + kChunk - 1) / kChunk;
  const int64_t base = (int64_t)bh * n_split;
  float M = -INFINITY;
  for (int i = 0; i < used; ++i) M = fmaxf(M, part_m[base + i]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float l = 0.f, acc = 0.f;
    for (int i = 0; i < used; ++i) {
      const float w = expf(part_m[base + i] - M);
      l = fmaf(part_l[base + i], w, l);
      acc = fmaf(part_acc[(base + i) * D + d], w, acc);
    }
    out[(int64_t)bh * D + d] = from_float<T>(acc / fmaxf(l, 1e-30f));
  }
}

template <typename T, int D>
int launch_decode(const void* q, const void* k, const void* v,
                  const void* lengths, void* part_m, void* part_l,
                  void* part_acc, void* out, int BH, int n_split,
                  const DecodeArgs& a, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const int64_t SD = (int64_t)a.S * D;
  const bool contig = a.G == 1 && a.q_h == D && a.q_b == a.H * D &&
                      a.k_s == D && a.k_h == SD && a.k_b == a.H * SD &&
                      a.v_s == D && a.v_h == SD && a.v_b == a.H * SD;
  auto kernel = contig ? decode_split_kernel<T, D, true>
                       : decode_split_kernel<T, D, false>;
  kernel<<<dim3(n_split, BH), kDecThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(lengths),
      static_cast<float*>(part_m), static_cast<float*>(part_l),
      static_cast<float*>(part_acc), a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T, D><<<BH, D, 0, st>>>(
      static_cast<const int32_t*>(lengths),
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), static_cast<T*>(out), a.H, a.S,
      n_split);
  return cudaGetLastError();
}

template <typename T>
int dispatch_decode(const void* q, const void* k, const void* v,
                    const void* lengths, void* part_m, void* part_l,
                    void* part_acc, void* out, int BH, int D, int n_split,
                    const DecodeArgs& a, void* stream) {
  if (a.G < 1 || a.H % a.G) return cudaErrorInvalidValue;
#define DECODE_CASE(DIM)                                                   \
  case DIM:                                                                \
    return launch_decode<T, DIM>(q, k, v, lengths, part_m, part_l,         \
                                 part_acc, out, BH, n_split, a, stream);
  switch (D) {
    DECODE_CASE(64)
    DECODE_CASE(128)
    DECODE_CASE(192)
    DECODE_CASE(256)
    default: return cudaErrorInvalidValue;
  }
#undef DECODE_CASE
}

// ---- int8 codec -------------------------------------------------------
// int8_encode is bound by bytes: x and the noise are read once and the
// codes written once (4,096 x 14,336 f32: 528.5 MB, 0.158 ms at the HBM
// rate).  The first kernel read each row twice, the max of |x| and then
// the code, in 4-byte loads; with some 8 rows of 57 KB in flight an SM
// (60 MB, more than the 50 MB L2) the second read came mostly from HBM
// again.  Here one block a row reads the row once, in one of three
// instances that the wrapper picks from C, the dtype and the pointers'
// alignment (kernels/int8_codec.py::encode_instance):
//   registers  the row lives in registers, VPT loads a thread (at
//              compile time) of W elements each: one 16-byte load (4
//              f32 or 8 bf16) when C and the pointers allow it, else
//              one element.  The noise of the thread's elements is
//              loaded before the block's max-reduce, so it is in flight
//              across the barrier, and each load's W codes leave in one
//              W-byte store.  A thread holds at most kEncMaxLoads loads
//              and kEncMaxElems elements (rows of up to 8,192), which
//              keeps it near 64 registers and two 512-thread blocks an
//              SM; a wider tile (7 f32 loads a thread at 14,336) took
//              124 registers, one block an SM, and lost to the shared
//              instance (PERF.md, section 6).
//   shared     longer rows are staged in dynamic shared memory: by one
//              TMA bulk copy (cp.async.bulk, completion on an mbarrier)
//              when C and the pointers allow 16-byte loads, else in
//              element loads; the noise is read after the reduce.  Rows
//              of up to kEncRowBytes.
//   two-pass   longer still: the max of |x| and then the code, each a
//              pass over the row in global memory (the first kernel).
// The arithmetic is the plain version's: s = max(amax, 1e-12) / 127 as
// an IEEE division, rintf(x / s + noise) with a true division (127 is
// not a power of two, so a multiply by the reciprocal would change
// bits), the clip to +-127.  The max of |x| is exact in any order.
constexpr int kCodecThreads = 256;      // int8_decode, two-pass encode
constexpr int kEncThreads = 512;        // threads of an encode block, most
constexpr int kEncMaxLoads = 8;         // register instance, a thread:
constexpr int kEncMaxElems = 16;        // loads and elements at most
// the shared instance's shared memory: an mbarrier (padded to 16
// bytes) and the reduce's scratch (a float a warp), then the row, up to
// a block's 227 KB
constexpr int kEncHeadBytes = 16 + kEncThreads / 32 * 4;
constexpr int64_t kEncRowBytes = 232448 - kEncHeadBytes;

enum EncodeInstance { kEncRegisters = 0, kEncShared = 1, kEncTwoPass = 2 };

// the max of x over the block (any multiple of 32 threads); red holds a
// float a warp
__device__ __forceinline__ float block_max(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = red[0];
  for (int w = 1; w < static_cast<int>(blockDim.x / 32); ++w)
    x = fmaxf(x, red[w]);
  __syncthreads();                  // red is free again
  return x;
}

// one load of x: W elements, 16 bytes when W > 1
template <typename T, int W>
using XLoad = typename std::conditional<W == 1, T, uint4>::type;

template <typename T, int W>
__device__ __forceinline__ XLoad<T, W> load_x(const T* __restrict__ row,
                                              int64_t j) {
  if constexpr (W == 1)
    return row[j];
  else
    return __ldg(reinterpret_cast<const uint4*>(row) + j);
}

template <typename T, int W>
__device__ __forceinline__ void unpack_x(const XLoad<T, W>& v,
                                         float (&out)[W]) {
  if constexpr (W == 1) {
    out[0] = to_float(v);
  } else {
    static_assert(W * sizeof(T) == 16, "a 16-byte load");
    alignas(16) T tmp[W];
    *reinterpret_cast<uint4*>(tmp) = v;
#pragma unroll
    for (int e = 0; e < W; ++e) out[e] = to_float(tmp[e]);
  }
}

// the W noise values of load j (16-byte loads when W > 1)
template <int W>
__device__ __forceinline__ void load_noise(const float* __restrict__ row,
                                           int64_t j, float (&out)[W]) {
  if constexpr (W == 1) {
    out[0] = row[j];
  } else {
#pragma unroll
    for (int h = 0; h < W / 4; ++h) {
      const float4 v =
          __ldg(reinterpret_cast<const float4*>(row + j * W) + h);
      out[4 * h] = v.x;
      out[4 * h + 1] = v.y;
      out[4 * h + 2] = v.z;
      out[4 * h + 3] = v.w;
    }
  }
}

// the code of x at scale s, as the byte of a wider store
__device__ __forceinline__ uint32_t int8_code(float x, float s,
                                              float noise) {
  const float y = rintf(__fadd_rn(x / s, noise));
  return static_cast<uint8_t>(
      static_cast<int8_t>(fminf(fmaxf(y, -127.f), 127.f)));
}

// the W codes of load j in one W-byte store
template <int W>
__device__ __forceinline__ void store_codes(int8_t* __restrict__ row,
                                            int64_t j, const float (&x)[W],
                                            float s,
                                            const float (&noise)[W]) {
  if constexpr (W == 1) {
    row[j] = static_cast<int8_t>(int8_code(x[0], s, noise[0]));
  } else if constexpr (W == 4) {
    uint32_t v = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v |= int8_code(x[e], s, noise[e]) << (8 * e);
    reinterpret_cast<uint32_t*>(row)[j] = v;
  } else {
    static_assert(W == 8, "4 or 8 codes a store");
    uint2 v{0u, 0u};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v.x |= int8_code(x[e], s, noise[e]) << (8 * e);
      v.y |= int8_code(x[e + 4], s, noise[e + 4]) << (8 * e);
    }
    reinterpret_cast<uint2*>(row)[j] = v;
  }
}

template <typename T, int W, int VPT>
__global__ void __launch_bounds__(kEncThreads)
int8_encode_registers_kernel(const T* __restrict__ x,
                             const float* __restrict__ noise,
                             int8_t* __restrict__ q,
                             float* __restrict__ scale, int64_t R,
                             int64_t C) {
  __shared__ float red[kEncThreads / 32];
  const int64_t loads = C / W;
  for (int64_t row = blockIdx.x; row < R; row += gridDim.x) {
    const T* xr = x + row * C;
    const float* nr = noise + row * C;
    XLoad<T, W> xv[VPT];
    float nz[VPT][W];
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int64_t j = threadIdx.x + (int64_t)k * blockDim.x;
      if (j < loads) xv[k] = load_x<T, W>(xr, j);
    }
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int64_t j = threadIdx.x + (int64_t)k * blockDim.x;
      if (j < loads) load_noise<W>(nr, j, nz[k]);
    }
    float amax = 0.f;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int64_t j = threadIdx.x + (int64_t)k * blockDim.x;
      if (j < loads) {
        float xf[W];
        unpack_x<T, W>(xv[k], xf);
#pragma unroll
        for (int e = 0; e < W; ++e) amax = fmaxf(amax, fabsf(xf[e]));
      }
    }
    amax = block_max(amax, red);
    const float s = fmaxf(amax, 1e-12f) / 127.0f;   // IEEE division
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int64_t j = threadIdx.x + (int64_t)k * blockDim.x;
      if (j < loads) {
        float xf[W];
        unpack_x<T, W>(xv[k], xf);
        store_codes<W>(q + row * C, j, xf, s, nz[k]);
      }
    }
    if (threadIdx.x == 0) scale[row] = s;
  }
}

template <typename T, int W>
__global__ void __launch_bounds__(kEncThreads)
int8_encode_shared_kernel(const T* __restrict__ x,
                          const float* __restrict__ noise,
                          int8_t* __restrict__ q, float* __restrict__ scale,
                          int64_t R, int64_t C) {
  // dynamic shared memory: the mbarrier, the reduce's scratch, the row
  extern __shared__ __align__(16) unsigned char enc_smem[];
  const uint32_t bar = smem_addr(enc_smem);
  float* red = reinterpret_cast<float*>(enc_smem + 16);
  XLoad<T, W>* xs =
      reinterpret_cast<XLoad<T, W>*>(enc_smem + kEncHeadBytes);
  if (W > 1 && threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int64_t loads = C / W;
  uint32_t parity = 0;
  for (int64_t row = blockIdx.x; row < R; row += gridDim.x) {
    const T* xr = x + row * C;
    float amax = 0.f;
    if constexpr (W > 1) {
      // the row in one TMA bulk copy (C * sizeof(T) is a multiple of 16)
      if (threadIdx.x == 0) {
        const uint32_t bytes = static_cast<uint32_t>(C * sizeof(T));
        // the last row's reads of xs come before the copy's writes
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_expect_tx(bar, bytes);
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
            "::bytes [%0], [%1], %2, [%3];" ::"r"(smem_addr(xs)),
            "l"(xr), "r"(bytes), "r"(bar)
            : "memory");
      }
      mbar_wait(bar, parity);
      parity ^= 1;
      for (int64_t j = threadIdx.x; j < loads; j += blockDim.x) {
        float xf[W];
        unpack_x<T, W>(xs[j], xf);
#pragma unroll
        for (int e = 0; e < W; ++e) amax = fmaxf(amax, fabsf(xf[e]));
      }
    } else {
      // element loads; each thread reads back only what it staged
#pragma unroll 4
      for (int64_t j = threadIdx.x; j < loads; j += blockDim.x) {
        const T v = xr[j];
        xs[j] = v;
        amax = fmaxf(amax, fabsf(to_float(v)));
      }
    }
    amax = block_max(amax, red);
    const float s = fmaxf(amax, 1e-12f) / 127.0f;   // IEEE division
    const float* nr = noise + row * C;
#pragma unroll 4
    for (int64_t j = threadIdx.x; j < loads; j += blockDim.x) {
      float nz[W], xf[W];
      load_noise<W>(nr, j, nz);
      unpack_x<T, W>(xs[j], xf);
      store_codes<W>(q + row * C, j, xf, s, nz);
    }
    if (threadIdx.x == 0) scale[row] = s;
    __syncthreads();                // every read of xs before the next copy
  }
}

template <typename T>
__global__ void __launch_bounds__(kCodecThreads)
int8_encode_two_pass_kernel(const T* __restrict__ x,
                            const float* __restrict__ noise,
                            int8_t* __restrict__ q,
                            float* __restrict__ scale, int64_t R,
                            int64_t C) {
  __shared__ float red[kCodecThreads / 32];
  for (int64_t row = blockIdx.x; row < R; row += gridDim.x) {
    const T* xr = x + row * C;
    float amax = 0.f;
    for (int64_t c = threadIdx.x; c < C; c += kCodecThreads)
      amax = fmaxf(amax, fabsf(to_float(xr[c])));
    amax = block_reduce<kCodecThreads>(amax, true, red);
    const float s = fmaxf(amax, 1e-12f) / 127.0f;   // IEEE division
    const float* nr = noise + row * C;
    int8_t* qr = q + row * C;
    for (int64_t c = threadIdx.x; c < C; c += kCodecThreads)
      qr[c] = static_cast<int8_t>(int8_code(to_float(xr[c]), s, nr[c]));
    if (threadIdx.x == 0) scale[row] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kCodecThreads)
int8_decode_kernel(const int8_t* __restrict__ q,
                   const float* __restrict__ scale, T* __restrict__ out,
                   int64_t R, int64_t C) {
  for (int64_t row = blockIdx.x; row < R; row += gridDim.x) {
    const float s = scale[row];
    const int8_t* qr = q + row * C;
    T* orow = out + row * C;
    for (int64_t c = threadIdx.x; c < C; c += kCodecThreads)
      orow[c] = from_float<T>(static_cast<float>(qr[c]) * s);
  }
}

inline unsigned row_blocks(int64_t R) {
  return static_cast<unsigned>(R < (1 << 20) ? (R < 1 ? 1 : R) : (1 << 20));
}

template <typename T, int W, int VPT>
int launch_encode_registers(const T* x, const float* noise, int8_t* q,
                            float* scale, int64_t R, int64_t C,
                            cudaStream_t st) {
  // as few threads as hold the row's loads at VPT a thread
  const int64_t loads = C / W;
  const int64_t need = (loads + VPT - 1) / VPT;
  const int threads = static_cast<int>((need + 31) / 32 * 32);
  int8_encode_registers_kernel<T, W, VPT>
      <<<row_blocks(R), threads, 0, st>>>(x, noise, q, scale, R, C);
  return cudaGetLastError();
}

template <typename T, int W>
int launch_encode_registers_vpt(const T* x, const float* noise, int8_t* q,
                                float* scale, int64_t R, int64_t C,
                                cudaStream_t st) {
  constexpr int kMax = kEncMaxElems / W < kEncMaxLoads ? kEncMaxElems / W
                                                       : kEncMaxLoads;
  const int64_t loads = C / W;
  const int64_t vpt = (loads + kEncThreads - 1) / kEncThreads;
  static_assert(kEncMaxLoads == 8, "one case a count of loads");
#define ENC_REG_CASE(N)                                                   \
  case N:                                                                 \
    if constexpr (N <= kMax)                                              \
      return launch_encode_registers<T, W, N>(x, noise, q, scale, R, C,   \
                                              st);                        \
    else                                                                  \
      return cudaErrorInvalidValue;
  switch (vpt) {
    ENC_REG_CASE(1)
    ENC_REG_CASE(2)
    ENC_REG_CASE(3)
    ENC_REG_CASE(4)
    ENC_REG_CASE(5)
    ENC_REG_CASE(6)
    ENC_REG_CASE(7)
    ENC_REG_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef ENC_REG_CASE
}

template <typename T, int W>
int launch_encode_shared(const T* x, const float* noise, int8_t* q,
                         float* scale, int64_t R, int64_t C,
                         cudaStream_t st) {
  if (C * (int64_t)sizeof(T) > kEncRowBytes) return cudaErrorInvalidValue;
  const int64_t smem = kEncHeadBytes + C * (int64_t)sizeof(T);
  auto kernel = int8_encode_shared_kernel<T, W>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<row_blocks(R), kEncThreads, static_cast<size_t>(smem), st>>>(
      x, noise, q, scale, R, C);
  return cudaGetLastError();
}

inline bool aligned_to(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// instance: an EncodeInstance; vec: 16-byte loads of x (W = 16 /
// sizeof(T) elements) and W-byte code stores, which need C % W == 0, x
// and noise on 16 bytes and q on W bytes (the two-pass instance takes
// element loads only).
template <typename T>
int launch_int8_encode(const void* x_, const void* noise_, void* q_,
                       void* scale_, int64_t R, int64_t C, int instance,
                       int vec, void* stream) {
  constexpr int W = 16 / sizeof(T);
  if (R < 0 || C < 1) return cudaErrorInvalidValue;
  if (vec && (C % W != 0 || !aligned_to(x_, 16) ||
              !aligned_to(noise_, 16) || !aligned_to(q_, W) ||
              instance == kEncTwoPass))
    return cudaErrorInvalidValue;
  if (R == 0) return cudaSuccess;
  const T* x = static_cast<const T*>(x_);
  const float* noise = static_cast<const float*>(noise_);
  int8_t* q = static_cast<int8_t*>(q_);
  float* scale = static_cast<float*>(scale_);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (instance) {
    case kEncRegisters:
      return vec ? launch_encode_registers_vpt<T, W>(x, noise, q, scale, R,
                                                     C, st)
                 : launch_encode_registers_vpt<T, 1>(x, noise, q, scale, R,
                                                     C, st);
    case kEncShared:
      return vec ? launch_encode_shared<T, W>(x, noise, q, scale, R, C, st)
                 : launch_encode_shared<T, 1>(x, noise, q, scale, R, C, st);
    case kEncTwoPass:
      int8_encode_two_pass_kernel<T><<<row_blocks(R), kCodecThreads, 0,
                                       st>>>(x, noise, q, scale, R, C);
      return cudaGetLastError();
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_int8_decode(const void* q, const void* scale, void* out,
                       int64_t R, int64_t C, void* stream) {
  int8_decode_kernel<T><<<row_blocks(R), kCodecThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scale),
      static_cast<T*>(out), R, C);
  return cudaGetLastError();
}

}  // namespace

#define MODEL_EXPORT(SUFFIX, T)                                             \
  extern "C" int model_flash_attention_##SUFFIX(                            \
      const void* q, const void* k, const void* v, void* o, void* lse,      \
      int B, int Hq, int Hkv, int Sq, int Sk, int D, int64_t q_b,           \
      int64_t q_h, int64_t q_s, int64_t k_b, int64_t k_h, int64_t k_s,      \
      int causal, int window, double scale, void* stream) {                 \
    const FlashArgs a{q_b, q_h, q_s, k_b, k_h, k_s, Hq, Hq / Hkv, Sq, Sk,   \
                      causal, window, static_cast<float>(scale),            \
                      static_cast<float*>(lse)};                            \
    return dispatch_flash<T>(q, k, v, o, B, D, a, stream);                  \
  }                                                                         \
  extern "C" int model_flash_attention_bwd_##SUFFIX(                        \
      const void* q, const void* k, const void* v, const void* o,           \
      const void* dout, const void* lse, void* delta, void* dq, void* dk,   \
      void* dv, int B, int Hq, int Hkv, int Sq, int Sk, int D, int64_t q_b, \
      int64_t q_h, int64_t q_s, int64_t k_b, int64_t k_h, int64_t k_s,      \
      int causal, int window, double scale, void* stream) {                 \
    if (Hkv < 1) return cudaErrorInvalidValue;                              \
    const FlashArgs a{q_b, q_h, q_s, k_b, k_h, k_s, Hq, Hq / Hkv, Sq, Sk,   \
                      causal, window, static_cast<float>(scale),            \
                      const_cast<float*>(static_cast<const float*>(lse))};  \
    return dispatch_flash_bwd<T>(q, k, v, o, dout, delta, dq, dk, dv, B, D, \
                                 a, stream);                                \
  }                                                                         \
  extern "C" int model_decode_attention_##SUFFIX(                           \
      const void* q, const void* k, const void* v, const void* lengths,     \
      void* part_m, void* part_l, void* part_acc, void* out, int BH, int H, \
      int Hkv, int S, int D, int n_split, int64_t q_b, int64_t q_h,         \
      int64_t k_b, int64_t k_h, int64_t k_s, int64_t v_b, int64_t v_h,      \
      int64_t v_s, double scale, void* stream) {                            \
    if (Hkv < 1) return cudaErrorInvalidValue;                              \
    const DecodeArgs a{q_b, q_h, k_b, k_h, k_s, v_b, v_h, v_s, H, H / Hkv,  \
                       S, static_cast<float>(scale)};                       \
    return dispatch_decode<T>(q, k, v, lengths, part_m, part_l, part_acc,   \
                              out, BH, D, n_split, a, stream);              \
  }                                                                         \
  extern "C" int model_int8_encode_##SUFFIX(                                \
      const void* x, const void* noise, void* q, void* scale, int64_t R,    \
      int64_t C, int instance, int vec, void* stream) {                     \
    return launch_int8_encode<T>(x, noise, q, scale, R, C, instance, vec,   \
                                 stream);                                   \
  }                                                                         \
  extern "C" int model_int8_decode_##SUFFIX(const void* q,                  \
                                            const void* scale, void* out,   \
                                            int64_t R, int64_t C,           \
                                            void* stream) {                 \
    return launch_int8_decode<T>(q, scale, out, R, C, stream);              \
  }

MODEL_EXPORT(f32, float)
MODEL_EXPORT(bf16, __nv_bfloat16)
