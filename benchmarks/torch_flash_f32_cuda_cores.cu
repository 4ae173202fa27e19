// A design of the port's float32 flash_attention kernel that was timed and
// not shipped: benchmarks/torch_flash_f32_jsq_designs.py splices it into
// src/repro_torch/kernels/csrc/model_kernels.cu in place of the float32
// section (from its "flash_attention, float32" banner to the bf16 one).
//
// ---- flash_attention, float32 (CUDA cores, register-blocked) ----------
// 256 threads own 128 query rows: thread (ty, tx) = (tid / 16, tid % 16)
// holds an 8 x 4 tile of scores (rows 8 ty .. 8 ty + 7, keys tx + 16 c)
// and an 8 x D/16 tile of the output.  Q (scaled by scale x log2(e)
// once) and K sit K-major in shared memory, K double-buffered by
// cp.async, V in one stage whose next tile is requested as soon as
// P V is done; the probabilities go through shared memory key-major.
// head_dim <= 128 only: at 256 Q alone fills 133 KB.
constexpr int kCcBQ = 128, kCcBK = 64, kCcThreads = 256;

struct FlashArgs {
  int64_t q_b, q_h, q_s;   // strides of q and o (elements)
  int64_t k_b, k_h, k_s;   // strides of k and v
  int Hq, group, Sq, Sk;   // group = Hq / Hkv
  int causal, window;
  float scale;
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

template <int D, int ROWS, int STRIDE>
__device__ __forceinline__ void cc_copy_rows(uint32_t dst,
                                             const float* __restrict__ src,
                                             int64_t stride, int n_rows) {
  constexpr int kVecs = D / 4;
  static_assert(ROWS * kVecs % kCcThreads == 0, "whole passes");
#pragma unroll
  for (int it = 0; it < ROWS * kVecs / kCcThreads; ++it) {
    const int idx = it * kCcThreads + threadIdx.x;
    const int r = idx / kVecs, c = (idx % kVecs) * 4;
    const bool ok = r < n_rows;
    cp_async16(dst + (r * STRIDE + c) * 4, src + (ok ? r : 0) * stride + c,
               ok);
  }
}

template <int D>
constexpr int cc_smem_bytes() {
  return ((kCcBQ + 2 * kCcBK) * (D + 4) + kCcBK * D +
          kCcBK * (kCcBQ + 4)) * 4;
}

template <int D>
__global__ void __launch_bounds__(kCcThreads, 1)
flash_attention_cc_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          float* __restrict__ o, FlashArgs a) {
  constexpr int BQ = kCcBQ, BK = kCcBK, QS = D + 4, KS = D + 4;
  constexpr int PS = BQ + 4, CV = D / 64;   // float4 output groups
  extern __shared__ float4 cc_smem_v4[];
  float* qs = reinterpret_cast<float*>(cc_smem_v4);   // [BQ][QS]
  float* ks = qs + BQ * QS;                 // [2][BK][KS]
  float* vs = ks + 2 * BK * KS;             // [BK][D]
  float* pt = vs + BK * D;                  // [BK][PS]

  const int qtile = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / a.Hq, h = bh % a.Hq, hk = h / a.group;
  const int q0 = qtile * BQ;
  const int q_rows = min(BQ, a.Sq - q0);
  const float* qp = q + b * a.q_b + h * a.q_h + q0 * a.q_s;
  const float* kp = k + b * a.k_b + hk * a.k_h;
  const float* vp = v + b * a.k_b + hk * a.k_h;

  const int q_last = q0 + q_rows - 1;
  int k_lo = 0, k_hi = a.Sk;
  if (a.window > 0) k_lo = max(0, q0 - a.window + 1);
  if (a.causal) k_hi = min(a.Sk, q_last + 1);
  const int last_lo = a.window > 0 ? max(0, q_last - a.window + 1) : 0;
  const int last_hi = a.causal ? min(q_last, a.Sk - 1) : a.Sk - 1;
  const bool all_live = last_lo <= last_hi;
  const int t_begin = all_live ? k_lo / BK : 0;
  const int n = (all_live ? (k_hi + BK - 1) / BK : (a.Sk + BK - 1) / BK) -
                t_begin;

  auto rows_of = [&](int i) { return min(BK, a.Sk - (t_begin + i) * BK); };
  auto load_k = [&](int i) {
    cc_copy_rows<D, BK, KS>(smem_addr(ks + (i % 2) * BK * KS),
                            kp + (t_begin + i) * BK * a.k_s, a.k_s,
                            rows_of(i));
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  auto load_v = [&](int i) {
    cc_copy_rows<D, BK, D>(smem_addr(vs), vp + (t_begin + i) * BK * a.k_s,
                           a.k_s, rows_of(i));
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  cc_copy_rows<D, BQ, QS>(smem_addr(qs), qp, a.q_s, q_rows);
  load_k(0);
  load_v(0);

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int r0 = ty * 8;
  const float scale_log2 = a.scale * kLog2e;
  float m[8], l[8], acc[8][4 * CV];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * CV; ++j) acc[i][j] = 0.f;
  }

  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) {
      load_k(i + 1);
      asm volatile("cp.async.wait_group 2;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    }
    __syncthreads();                        // K_i (and Q) arrived
    if (i == 0) {                           // fold the scale into Q
      for (int idx = threadIdx.x; idx < BQ * D; idx += kCcThreads)
        qs[(idx / D) * QS + idx % D] *= scale_log2;
      __syncthreads();
    }
    const float* kt = ks + (i % 2) * BK * KS + tx * KS;
    float s[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 kv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kv[c] = *reinterpret_cast<const float4*>(kt + 16 * c * KS + d);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(qs + (r0 + r) * QS + d);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = fmaf(qv.x, kv[c].x, s[r][c]);
          s[r][c] = fmaf(qv.y, kv[c].y, s[r][c]);
          s[r][c] = fmaf(qv.z, kv[c].z, s[r][c]);
          s[r][c] = fmaf(qv.w, kv[c].w, s[r][c]);
        }
      }
    }
    const int k0 = (t_begin + i) * BK;
    const int first = q0 + r0, last = first + 7;
    const bool whole = k0 + BK <= a.Sk &&
        (!a.causal || k0 + BK - 1 <= first) &&
        (a.window <= 0 || last - k0 < a.window);
    float corr[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float mt = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[r][c];
        if (!whole) {
          const int row = first + r, col = k0 + tx + 16 * c;
          if ((a.causal && row < col) ||
              (a.window > 0 && row - col >= a.window))
            x = kNegInf;
          if (col >= a.Sk) x = -INFINITY;
        }
        s[r][c] = x;
        mt = fmaxf(mt, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[r], mt);
      corr[r] = exp2f(m[r] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = exp2f(s[r][c] - m_new);
        rs += s[r][c];
      }
      l[r] = fmaf(l[r], corr[r], rs);
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < 4 * CV; ++j) acc[r][j] *= corr[r];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float* dst = pt + (tx + 16 * c) * PS + r0;
      *reinterpret_cast<float4*>(dst) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(s[4][c], s[5][c], s[6][c], s[7][c]);
    }
    if (i + 1 < n) {
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();                        // V_i and P visible
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(pt + c * PS + r0);
      const float4 pb =
          *reinterpret_cast<const float4*>(pt + c * PS + r0 + 4);
      const float p[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
      for (int gq = 0; gq < CV; ++gq) {
        const float4 vv =
            *reinterpret_cast<const float4*>(vs + c * D + 64 * gq + 4 * tx);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          acc[r][4 * gq] = fmaf(p[r], vv.x, acc[r][4 * gq]);
          acc[r][4 * gq + 1] = fmaf(p[r], vv.y, acc[r][4 * gq + 1]);
          acc[r][4 * gq + 2] = fmaf(p[r], vv.z, acc[r][4 * gq + 2]);
          acc[r][4 * gq + 3] = fmaf(p[r], vv.w, acc[r][4 * gq + 3]);
        }
      }
    }
    __syncthreads();                        // V, P and K_i free
    if (i + 1 < n) load_v(i + 1);
  }

  float* op = o + b * a.q_b + h * a.q_h;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    float lt = l[r];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    const int row = q0 + r0 + r;
    if (row >= a.Sq) continue;
    const float den = fmaxf(lt, 1e-30f);
#pragma unroll
    for (int gq = 0; gq < CV; ++gq)
      *reinterpret_cast<float4*>(op + row * a.q_s + 64 * gq + 4 * tx) =
          make_float4(acc[r][4 * gq] / den, acc[r][4 * gq + 1] / den,
                      acc[r][4 * gq + 2] / den, acc[r][4 * gq + 3] / den);
  }
}

template <int D>
int launch_flash_f32(const void* q, const void* k, const void* v, void* o,
                     int B, const FlashArgs& a, void* stream) {
  if constexpr (D > 128) {
    return cudaErrorInvalidValue;
  } else {
    constexpr int kSmem = cc_smem_bytes<D>();
    auto kernel = flash_attention_cc_kernel<D>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.Sq + kCcBQ - 1) / kCcBQ, B * a.Hq);
    kernel<<<grid, kCcThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), a);
    return cudaGetLastError();
  }
}

