// Kernels of the model side, for Hopper (sm_90a).
//
// Four kernels, each the CUDA twin of one Pallas kernel of the JAX
// package (in `repro/kernels/`) and of one plain PyTorch function in
// `kernels/ref.py`:
//
//   flash_attention  <- flash_attention.py  _flash_kernel
//   decode_attention <- decode_attention.py _decode_kernel
//   int8_encode      <- int8_codec.py       _encode_kernel
//   int8_decode      <- int8_codec.py       _decode_kernel
//
// flash_attention is bound by operations (4 D flops per unmasked
// query-key pair); this first version runs them on CUDA cores in
// float32, not on the tensor cores, so it sits far above its bf16
// bound.  One block of 256 threads owns 64 query rows of one (batch,
// head) and walks the key tiles of 64 in a loop, which takes the place
// of the Pallas grid's sequential k axis: Q (transposed), K
// (transposed), V and the probabilities sit in shared memory as
// float32; each thread holds a 4x4 tile of scores and a 4 x D/16 tile
// of the output, and the 16 threads of a row group (one half warp)
// reduce the row max and sum with shuffles.  Key tiles that no row of
// the block may see are skipped, unless some row of the block sees no
// key at all: that row averages v uniformly, as the reference does, so
// it needs every tile.  GQA reads kv head h / (Hq / Hkv); strides let
// one kernel read (B, H, S, D) and (B, S, H, D) without a copy.
//
// decode_attention, int8_encode and int8_decode are bound by bytes.
// decode splits each (batch, head) row into chunks of 256 keys, one
// block each, reads only the keys below lengths[b] (all of them for a
// row of length 0, which averages v), and writes a partial (max, sum,
// acc); a second pass per (batch, head) combines the chunks.  The codec
// runs one block per row: a max-reduce of |x|, the scale as a true
// IEEE division, then rintf (round half to even) of x / scale + noise.
//
// Masked scores are the finite NEG_INF = -1e30, as in the reference;
// keys past the end of a tile (ragged tails) score -inf and weigh 0.
// Built with --fmad=false like the other kernels: the products of the
// attention kernels use explicit fmaf; the codec has no multiply-add.
//
// Plain C interface (loaded with ctypes): every entry point takes raw
// pointers and the CUDA stream, launches on that stream, allocates
// nothing (decode's partials arrive from the caller), and returns
// cudaGetLastError() so the caller sees a refused launch.

#include <cstdint>
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

// ---- flash_attention --------------------------------------------------
constexpr int kBQ = 64;             // query rows per block
constexpr int kBK = 64;             // keys per tile
constexpr int kFlashThreads = 256;  // 16 row groups x 16 column lanes
constexpr int kPStride = kBK + 4;   // padded row of the probability tile

template <int D>
constexpr int flash_smem_bytes() {
  return (2 * D * kBQ + kBK * D + kBQ * kPStride) * sizeof(float);
}

struct FlashArgs {
  int64_t q_b, q_h, q_s;   // strides of q and o (elements)
  int64_t k_b, k_h, k_s;   // strides of k and v
  int Hq, group, Sq, Sk;   // group = Hq / Hkv
  int causal, window;
  float scale;
};

// rows [0, kBQ) x D of `src` (row stride `stride`, n_rows valid) into
// dst[d * kBQ + r] as float: lanes take neighbouring rows, so the
// transposed stores hit neighbouring banks.
template <typename T, int D>
__device__ __forceinline__ void load_tile_t(const T* __restrict__ src,
                                            int64_t stride, int n_rows,
                                            float* __restrict__ dst) {
  constexpr int E = 16 / sizeof(T);
  constexpr int kChunks = kBQ * (D / E);
  for (int idx = threadIdx.x; idx < kChunks; idx += kFlashThreads) {
    const int r = idx % kBQ, d0 = (idx / kBQ) * E;
    float x[E];
    if (r < n_rows) {
      load_vec<T, E>(src + r * stride + d0, x);
    } else {
#pragma unroll
      for (int u = 0; u < E; ++u) x[u] = 0.f;
    }
#pragma unroll
    for (int u = 0; u < E; ++u) dst[(d0 + u) * kBQ + r] = x[u];
  }
}

// rows [0, kBK) x D of v into dst[c * D + d] as float (lanes take
// neighbouring chunks of one row).
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          int64_t stride, int n_rows,
                                          float* __restrict__ dst) {
  constexpr int E = 16 / sizeof(T);
  constexpr int kChunks = kBK * (D / E);
  for (int idx = threadIdx.x; idx < kChunks; idx += kFlashThreads) {
    const int c = idx / (D / E), d0 = (idx % (D / E)) * E;
    float x[E];
    if (c < n_rows) {
      load_vec<T, E>(src + c * stride + d0, x);
    } else {
#pragma unroll
      for (int u = 0; u < E; ++u) x[u] = 0.f;
    }
#pragma unroll
    for (int u = 0; u < E; ++u) dst[c * D + d0 + u] = x[u];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kFlashThreads, D <= 128 ? 2 : 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       FlashArgs a) {
  extern __shared__ float4 smem_v4[];          // 16-byte aligned
  float* qt = reinterpret_cast<float*>(smem_v4);  // [D][kBQ]
  float* kt = qt + D * kBQ;         // [D][kBK]
  float* vs = kt + D * kBK;         // [kBK][D]
  float* ps = vs + kBK * D;         // [kBQ][kPStride]
  constexpr int kCols = D / 16;     // output columns per thread
  constexpr int kColVecs = D / 64;  // ... as float4 groups

  const int n_qt = gridDim.x;
  const int qtile = n_qt - 1 - blockIdx.x;   // heavy causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / a.Hq, h = bh % a.Hq, hk = h / a.group;
  const int q0 = qtile * kBQ;
  const int q_rows = min(kBQ, a.Sq - q0);
  const T* qp = q + b * a.q_b + h * a.q_h + q0 * a.q_s;
  const T* kp = k + b * a.k_b + hk * a.k_h;
  const T* vp = v + b * a.k_b + hk * a.k_h;
  T* op = o + b * a.q_b + h * a.q_h + q0 * a.q_s;

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int r0 = ty * 4;            // this thread's rows r0..r0+3
  const int c0 = tx * 4;            // its score columns c0..c0+3

  // key range any row of the block may see, and whether every row
  // sees at least one key (then the tiles outside can be skipped)
  const int q_last = q0 + q_rows - 1;
  int k_lo = 0, k_hi = a.Sk;
  if (a.window > 0) k_lo = max(0, q0 - a.window + 1);
  if (a.causal) k_hi = min(a.Sk, q_last + 1);
  const int last_lo = a.window > 0 ? max(0, q_last - a.window + 1) : 0;
  const int last_hi = a.causal ? min(q_last, a.Sk - 1) : a.Sk - 1;
  const bool all_live = last_lo <= last_hi;
  const int t_begin = all_live ? k_lo / kBK : 0;
  const int t_end = all_live ? (k_hi + kBK - 1) / kBK
                             : (a.Sk + kBK - 1) / kBK;

  load_tile_t<T, D>(qp, a.q_s, q_rows, qt);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBK;
    const int k_rows = min(kBK, a.Sk - k0);
    __syncthreads();                // previous tile fully consumed
    load_tile_t<T, D>(kp + k0 * a.k_s, a.k_s, k_rows, kt);
    load_tile<T, D>(vp + k0 * a.k_s, a.k_s, k_rows, vs);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(qt + d * kBQ + r0);
      const float4 kb = *reinterpret_cast<const float4*>(kt + d * kBK + c0);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + r0 + i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + c0 + j;
        float x = s[i][j] * a.scale;
        if ((a.causal && qpos < kpos) ||
            (a.window > 0 && qpos - kpos >= a.window))
          x = kNegInf;
        if (kpos >= a.Sk) x = -INFINITY;
        s[i][j] = x;
        mt = fmaxf(mt, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      corr[i] = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      l[i] = l[i] * corr[i] + rs;   // this thread's share of the row sum
      m[i] = m_new;
      *reinterpret_cast<float4*>(ps + (r0 + i) * kPStride + c0) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= corr[i];
    __syncthreads();

    for (int c = 0; c < k_rows; c += 4) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 pv =
            *reinterpret_cast<const float4*>(ps + (r0 + i) * kPStride + c);
        p[i][0] = pv.x; p[i][1] = pv.y; p[i][2] = pv.z; p[i][3] = pv.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int g = 0; g < kColVecs; ++g) {
          const float4 vv = *reinterpret_cast<const float4*>(
              vs + (c + u) * D + g * 64 + c0);
          const float vx[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[i][g * 4 + e] = fmaf(p[i][u], vx[e], acc[i][g * 4 + e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lt = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    const int r = r0 + i;
    if (r >= q_rows) continue;
    const float den = fmaxf(lt, 1e-30f);
#pragma unroll
    for (int g = 0; g < kColVecs; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        op[r * a.q_s + g * 64 + c0 + e] =
            from_float<T>(acc[i][g * 4 + e] / den);
  }
}

template <typename T, int D>
int launch_flash(const void* q, const void* k, const void* v, void* o,
                 int B, const FlashArgs& a, void* stream) {
  constexpr int kSmem = flash_smem_bytes<D>();
  auto kernel = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, B * a.Hq);
  kernel<<<grid, kFlashThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), a);
  return cudaGetLastError();
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

template <typename T, int D>
__global__ void __launch_bounds__(kDecThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const int32_t* __restrict__ lengths,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_acc, int H, int S,
                    float scale) {
  constexpr int E = D / 32;         // elements of a row per lane
  __shared__ float ps[kChunk];
  __shared__ float red[kDecWarps];
  __shared__ float accw[kDecWarps][D];

  const int split = blockIdx.x, n_split = gridDim.x;
  const int bh = blockIdx.y, b = bh / H;
  const int len = lengths[b];
  const int n = valid_keys(len, S);
  const int k0 = split * kChunk;
  if (k0 >= n) return;              // the combine pass skips this chunk
  const int kend = min(k0 + kChunk, n);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* kb = k + (int64_t)bh * S * D + lane * E;
  const T* vb = v + (int64_t)bh * S * D + lane * E;

  float qv[E];
  load_vec<T, E>(q + (int64_t)bh * D + lane * E, qv);

  // scores: a warp per key, lanes across D, four keys in flight
  for (int kk = warp; kk < kChunk; kk += 4 * kDecWarps) {
    float dot[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int key = k0 + kk + u * kDecWarps;
      dot[u] = 0.f;
      if (key < kend) {
        float kv[E];
        load_vec<T, E>(kb + (int64_t)key * D, kv);
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
  for (int kk = warp; kk < kend - k0; kk += 4 * kDecWarps) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = kk + u * kDecWarps;
      if (c < kend - k0) {
        float vv[E];
        load_vec<T, E>(vb + (int64_t)(k0 + c) * D, vv);
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
                  void* part_acc, void* out, int BH, int H, int S,
                  int n_split, float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  decode_split_kernel<T, D><<<dim3(n_split, BH), kDecThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(lengths),
      static_cast<float*>(part_m), static_cast<float*>(part_l),
      static_cast<float*>(part_acc), H, S, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T, D><<<BH, D, 0, st>>>(
      static_cast<const int32_t*>(lengths),
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), static_cast<T*>(out), H, S,
      n_split);
  return cudaGetLastError();
}

template <typename T>
int dispatch_decode(const void* q, const void* k, const void* v,
                    const void* lengths, void* part_m, void* part_l,
                    void* part_acc, void* out, int BH, int H, int S,
                    int D, int n_split, float scale, void* stream) {
#define DECODE_CASE(DIM)                                                   \
  case DIM:                                                                \
    return launch_decode<T, DIM>(q, k, v, lengths, part_m, part_l,         \
                                 part_acc, out, BH, H, S, n_split, scale,  \
                                 stream);
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
constexpr int kCodecThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kCodecThreads)
int8_encode_kernel(const T* __restrict__ x, const float* __restrict__ noise,
                   int8_t* __restrict__ q, float* __restrict__ scale,
                   int64_t R, int64_t C) {
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
    for (int64_t c = threadIdx.x; c < C; c += kCodecThreads) {
      const float y = rintf(__fadd_rn(to_float(xr[c]) / s, nr[c]));
      qr[c] = static_cast<int8_t>(fminf(fmaxf(y, -127.f), 127.f));
    }
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

template <typename T>
int launch_int8_encode(const void* x, const void* noise, void* q,
                       void* scale, int64_t R, int64_t C, void* stream) {
  int8_encode_kernel<T><<<row_blocks(R), kCodecThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(noise),
      static_cast<int8_t*>(q), static_cast<float*>(scale), R, C);
  return cudaGetLastError();
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
      const void* q, const void* k, const void* v, void* o, int B, int Hq,  \
      int Hkv, int Sq, int Sk, int D, int64_t q_b, int64_t q_h,             \
      int64_t q_s, int64_t k_b, int64_t k_h, int64_t k_s, int causal,       \
      int window, double scale, void* stream) {                             \
    const FlashArgs a{q_b, q_h, q_s, k_b, k_h, k_s, Hq, Hq / Hkv, Sq, Sk,   \
                      causal, window, static_cast<float>(scale)};           \
    return dispatch_flash<T>(q, k, v, o, B, D, a, stream);                  \
  }                                                                         \
  extern "C" int model_decode_attention_##SUFFIX(                           \
      const void* q, const void* k, const void* v, const void* lengths,     \
      void* part_m, void* part_l, void* part_acc, void* out, int BH, int H, \
      int S, int D, int n_split, double scale, void* stream) {              \
    return dispatch_decode<T>(q, k, v, lengths, part_m, part_l, part_acc,   \
                              out, BH, H, S, D, n_split,                    \
                              static_cast<float>(scale), stream);           \
  }                                                                         \
  extern "C" int model_int8_encode_##SUFFIX(const void* x,                  \
                                            const void* noise, void* q,     \
                                            void* scale, int64_t R,         \
                                            int64_t C, void* stream) {      \
    return launch_int8_encode<T>(x, noise, q, scale, R, C, stream);         \
  }                                                                         \
  extern "C" int model_int8_decode_##SUFFIX(const void* q,                  \
                                            const void* scale, void* out,   \
                                            int64_t R, int64_t C,           \
                                            void* stream) {                 \
    return launch_int8_decode<T>(q, scale, out, R, C, stream);              \
  }

MODEL_EXPORT(f32, float)
MODEL_EXPORT(bf16, __nv_bfloat16)
