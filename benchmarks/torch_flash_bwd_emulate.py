"""Run the flash backward kernels of model_kernels.cu on the CPU.

A check of the kernels' fragment indexing that needs no GPU (the
hardware-specific parts cannot run here, but their index arithmetic can):

The backward section is compiled by g++ with CUDA's qualifiers defined
away: a block's threads are std::threads, __syncthreads a std::barrier,
and the warp-wide PTX (ldmatrix, mma.sync m16n8k16 bf16 and m16n8k8
TF32, shuffles) is emulated lane by lane through a per-warp exchange, so
every fragment index of the kernels is exercised.  cp.async copies at
once.  The tensor cores' adds are emulated as cutting toward zero once
per mma.  Shared memory starts as NaN, so a read of a byte no copy
wrote shows.

    PYTHONPATH=src python3 benchmarks/torch_flash_bwd_emulate.py [--quick]

(about 2 minutes on 8 cores; --quick runs three cases a dtype).  Each
case holds dQ, dK and dV to `ref.flash_attention_bwd_ref` within the
GPU tests' BWD_TOL.  The library is built into build/flash_bwd_emulate/.
"""
import ctypes
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src/repro_torch/kernels/csrc/model_kernels.cu"
OUT = ROOT / "build" / "flash_bwd_emulate"

PRELUDE = r"""
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <cassert>
#include <barrier>
#include <memory>
#include <thread>
#include <vector>
#include <algorithm>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
using std::min;
using std::max;
struct Idx { unsigned x, y, z; };
thread_local Idx threadIdx, blockIdx;
Idx gridDim;
struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
inline float2 make_float2(float x, float y) { return {x, y}; }
struct __nv_bfloat16 { uint16_t x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline uint32_t __float_as_uint(float f) { uint32_t u; memcpy(&u, &f, 4); return u; }
inline float __uint_as_float(uint32_t u) { float f; memcpy(&f, &u, 4); return f; }
inline float __bfloat162float(__nv_bfloat16 h) { return __uint_as_float(uint32_t(h.x) << 16); }
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {uint16_t((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {uint16_t(u >> 16)};
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16_rn(a), __float2bfloat16_rn(b)};
}
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
inline float to_float(float x) { return x; }
inline float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
inline float fast_exp2(float x) { return exp2f(x); }
struct FlashArgs {
  int64_t q_b, q_h, q_s;
  int64_t k_b, k_h, k_s;
  int Hq, group, Sq, Sk;
  int causal, window;
  float scale;
  float* lse;
};
constexpr int kSmemBytes = 232448;
alignas(128) static unsigned char g_smem[kSmemBytes];
inline uint32_t smem_addr(const void* p) {
  const long d = (const unsigned char*)p - g_smem;
  assert(d >= 0 && d < kSmemBytes);
  return uint32_t(d);
}
static int g_smem_limit = 0;   // the launch's dynamic shared memory
inline void smem_check(uint32_t a, int n) {
  if (int(a) + n > g_smem_limit) { fprintf(stderr, "smem %u+%d > %d\n", a, n, g_smem_limit); abort(); }
}
struct Warp { std::barrier<> bar{32}; uint32_t u[32][8]; float f[32][4]; };
static std::barrier<>* g_block;
static Warp* g_warps;
inline void __syncthreads() { g_block->arrive_and_wait(); }
inline Warp& my_warp() { return g_warps[threadIdx.x / 32]; }
inline float __shfl_xor_sync(unsigned, float v, int m) {
  Warp& w = my_warp(); const int l = threadIdx.x & 31;
  w.f[l][0] = v; w.bar.arrive_and_wait();
  const float r = w.f[l ^ m][0]; w.bar.arrive_and_wait();
  return r;
}
inline void cp_async16(uint32_t dst, const void* src, bool valid) {
  assert(dst % 16 == 0 && (uintptr_t)src % 16 == 0);
  smem_check(dst, 16);
  if (valid) memcpy(g_smem + dst, src, 16); else memset(g_smem + dst, 0, 16);
}
inline void cp_async4(uint32_t dst, const void* src, bool valid) {
  assert(dst % 4 == 0);
  smem_check(dst, 4);
  if (valid) memcpy(g_smem + dst, src, 4); else memset(g_smem + dst, 0, 4);
}
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}
template <bool TRANS>
inline void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  Warp& w = my_warp(); const int l = threadIdx.x & 31;
  assert(addr % 16 == 0);
  smem_check(addr, 16);
  w.u[l][0] = addr; w.bar.arrive_and_wait();
  const int g = l / 4, t = l % 4;
  for (int i = 0; i < 4; ++i) {
    uint16_t lo, hi;
    if (!TRANS) {
      const uint32_t row = w.u[8 * i + g][0];
      memcpy(&lo, g_smem + row + 4 * t, 2);
      memcpy(&hi, g_smem + row + 4 * t + 2, 2);
    } else {
      memcpy(&lo, g_smem + w.u[8 * i + 2 * t][0] + 2 * g, 2);
      memcpy(&hi, g_smem + w.u[8 * i + 2 * t + 1][0] + 2 * g, 2);
    }
    r[i] = uint32_t(lo) | (uint32_t(hi) << 16);
  }
  w.bar.arrive_and_wait();
}
inline float bf_lo(uint32_t u) { return __uint_as_float(u << 16); }
inline float bf_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }
// d + sum, cut toward zero once (the tensor cores' add)
inline float rz(double x) {
  float f = float(x);
  if (std::fabs(double(f)) > std::fabs(x)) f = std::nextafter(f, 0.f);
  return f;
}
inline void mma_bf16(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  Warp& w = my_warp(); const int l = threadIdx.x & 31;
  for (int i = 0; i < 4; ++i) w.u[l][i] = a[i];
  for (int i = 0; i < 2; ++i) w.u[l][4 + i] = b[i];
  w.bar.arrive_and_wait();
  const int g = l / 4, t = l % 4;
  auto A = [&](int r, int c) {
    const uint32_t u = w.u[(r % 8) * 4 + (c % 8) / 2][(r >= 8) + 2 * (c >= 8)];
    return (c % 2) ? bf_hi(u) : bf_lo(u);
  };
  auto B = [&](int k, int n) {
    const uint32_t u = w.u[n * 4 + (k % 8) / 2][4 + (k >= 8)];
    return (k % 2) ? bf_hi(u) : bf_lo(u);
  };
  float out[4];
  for (int e = 0; e < 4; ++e) {
    const int r = g + 8 * (e >> 1), c = 2 * t + (e & 1);
    double s = d[e];
    for (int k = 0; k < 16; ++k) s += double(A(r, k)) * double(B(k, c));
    out[e] = rz(s);
  }
  w.bar.arrive_and_wait();
  for (int e = 0; e < 4; ++e) d[e] = out[e];
}
inline void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  Warp& w = my_warp(); const int l = threadIdx.x & 31;
  for (int i = 0; i < 4; ++i) w.u[l][i] = a[i];
  for (int i = 0; i < 2; ++i) w.u[l][4 + i] = b[i];
  w.bar.arrive_and_wait();
  const int g = l / 4, t = l % 4;
  auto A = [&](int r, int c) {
    const uint32_t u = w.u[(r % 8) * 4 + c % 4][(r >= 8) + 2 * (c >= 4)];
    assert((u & 0x1fffu) == 0);
    return __uint_as_float(u);
  };
  auto B = [&](int k, int n) {
    const uint32_t u = w.u[n * 4 + k % 4][4 + (k >= 4)];
    assert((u & 0x1fffu) == 0);
    return __uint_as_float(u);
  };
  float out[4];
  for (int e = 0; e < 4; ++e) {
    const int r = g + 8 * (e >> 1), c = 2 * t + (e & 1);
    double s = d[e];
    for (int k = 0; k < 8; ++k) s += double(A(r, k)) * double(B(k, c));
    out[e] = rz(s);
  }
  w.bar.arrive_and_wait();
  for (int e = 0; e < 4; ++e) d[e] = out[e];
}
inline void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xFFFFE000u;
}
inline void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                       const uint32_t (&bh)[2], const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}
inline uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return uint32_t(v.x.x) | (uint32_t(v.y.x) << 16);
}
"""

LAUNCH = r"""
template <typename K>
void run_grid(Idx grid, int threads, int smem, K kern) {
  gridDim = grid;
  g_smem_limit = smem;
  std::barrier<> block(threads);
  g_block = &block;
  std::unique_ptr<Warp[]> warps(new Warp[threads / 32]);
  g_warps = warps.get();
  std::vector<std::thread> ts;
  for (int tid = 0; tid < threads; ++tid)
    ts.emplace_back([&, tid] {
      threadIdx = {unsigned(tid), 0, 0};
      for (unsigned y = 0; y < grid.y; ++y)
        for (unsigned x = 0; x < grid.x; ++x) {
          if (tid == 0) memset(g_smem, 0xff, kSmemBytes);
          block.arrive_and_wait();
          blockIdx = {x, y, 0};
          kern();
          block.arrive_and_wait();
        }
    });
  for (auto& t : ts) t.join();
}

template <typename T, int D>
int emu(const void* q, const void* k, const void* v, const void* o,
        const void* dout, void* delta, void* dq, void* dk, void* dv, int B,
        const FlashArgs& a) {
  using Tl = BwdTiles<T, D>;
  const T* tq = (const T*)q; const T* tk = (const T*)k; const T* tv = (const T*)v;
  const T* tdo = (const T*)dout;
  float* fd = (float*)delta;
  const int64_t rows = int64_t(B) * a.Hq * a.Sq;
  run_grid({unsigned((rows + 7) / 8), 1, 1}, kDeltaThreads, 0, [&] {
    flash_bwd_delta_kernel<T, D>((const T*)o, tdo, fd, a, rows); });
  static_assert(Tl::smem_dkdv() <= kSmemBytes && Tl::smem_dq() <= kSmemBytes, "smem");
  const int hkv = a.Hq / a.group;
  run_grid({unsigned(B * hkv), unsigned((a.Sk + Tl::kKeys - 1) / Tl::kKeys), 1},
           kBwdThreads, Tl::smem_dkdv(), [&] {
    flash_bwd_dkdv_kernel<T, D>(tq, tk, tv, tdo, fd, (T*)dk, (T*)dv, a); });
  run_grid({unsigned(B * a.Hq), unsigned((a.Sq + Tl::kQRows - 1) / Tl::kQRows), 1},
           kBwdThreads, Tl::smem_dq(), [&] {
    flash_bwd_dq_kernel<T, D>(tq, tk, tv, tdo, fd, (T*)dq, a); });
  return 0;
}

#define EMU(SUFFIX, T)                                                      \
  extern "C" int emu_bwd_##SUFFIX(                                          \
      const void* q, const void* k, const void* v, const void* o,           \
      const void* dout, const void* lse, void* delta, void* dq, void* dk,   \
      void* dv, int B, int Hq, int Hkv, int Sq, int Sk, int D, int64_t q_b, \
      int64_t q_h, int64_t q_s, int64_t k_b, int64_t k_h, int64_t k_s,      \
      int causal, int window, double scale) {                               \
    const FlashArgs a{q_b, q_h, q_s, k_b, k_h, k_s, Hq, Hq / Hkv, Sq, Sk,   \
                      causal, window, float(scale), (float*)lse};           \
    switch (D) {                                                            \
      case 64: return emu<T, 64>(q, k, v, o, dout, delta, dq, dk, dv, B, a); \
      case 128: return emu<T, 128>(q, k, v, o, dout, delta, dq, dk, dv, B, a); \
      case 192: return emu<T, 192>(q, k, v, o, dout, delta, dq, dk, dv, B, a); \
      case 256: return emu<T, 256>(q, k, v, o, dout, delta, dq, dk, dv, B, a); \
    }                                                                       \
    return 1;                                                               \
  }
EMU(f32, float)
EMU(bf16, __nv_bfloat16)
"""


def build():
    s = SRC.read_text()
    a = s.index("// ---- flash_attention_bwd ---")
    b = s.index("template <typename T, int D>\nint launch_flash_bwd")
    sec = s[a:b].replace("extern __shared__ float4 bwd_smem_v4[];",
                         "float4* bwd_smem_v4 = (float4*)g_smem;")
    assert "asm" not in sec, "inline PTX in the section"
    OUT.mkdir(parents=True, exist_ok=True)
    cpp = OUT / "emu.cpp"
    cpp.write_text(PRELUDE + "namespace {\n" + sec + "\n" + LAUNCH.replace(
        "#define EMU", "}  // namespace\n#define EMU", 1))
    lib = OUT / "libemu.so"
    t = time.time()
    subprocess.run(["g++", "-O2", "-std=c++20", "-shared", "-fPIC",
                    "-pthread", "-o", str(lib), str(cpp)], check=True)
    print(f"built in {time.time() - t:.1f} s", flush=True)
    L = ctypes.CDLL(str(lib))
    P, I, I64, Dd = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, \
        ctypes.c_double
    for suf in ("f32", "bf16"):
        fn = getattr(L, f"emu_bwd_{suf}")
        fn.argtypes = [P] * 10 + [I] * 6 + [I64] * 6 + [I, I, Dd]
        fn.restype = I
    return L


def run(L, q, k, v, out, dout, lse, causal, window):
    from repro_torch.kernels import ref  # noqa
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32)
    dq, dk, dv = (torch.full_like(t, float("nan")) for t in (q, k, v))
    fn = L.emu_bwd_bf16 if q.dtype == torch.bfloat16 else L.emu_bwd_f32
    qs, ks = q.stride(), k.stride()
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, Hq, Hkv, Sq, Sk, D, qs[0], qs[2],
            qs[1], ks[0], ks[2], ks[1], int(causal), int(window),
            1.0 / D ** 0.5)
    assert rc == 0
    return dq, dk, dv


TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


def check(L, B, Sq, Sk, Hq, Hkv, D, causal, window, dtype, seed=0):
    from repro_torch.kernels import ref
    g = np.random.default_rng(seed)
    mk = lambda *s: torch.tensor(g.standard_normal(s), dtype=torch.float32
                                 ).to(dtype)
    q, dout = mk(B, Sq, Hq, D), mk(B, Sq, Hq, D)
    k, v = mk(B, Sk, Hkv, D), mk(B, Sk, Hkv, D)
    out = ref.flash_attention_bshd_ref(q, k, v, causal=causal, window=window)
    lse = ref.flash_attention_lse_ref(q, k, v, causal=causal, window=window)
    t = time.time()
    got = run(L, q, k, v, out, dout, lse, causal, window)
    want = ref.flash_attention_bwd_ref(q, k, v, out, dout, lse,
                                       causal=causal, window=window)
    errs = []
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        scale = max(1.0, float(b.float().abs().max()))
        e = float((a.float() - b.float()).abs().max()) / scale
        assert bool(a.float().isfinite().all()), name
        errs.append(e)
    ok = max(errs) <= TOL[dtype]
    print(f"{'ok ' if ok else 'BAD'} {str(dtype)[6:]:8s} B={B} Sq={Sq} Sk={Sk} "
          f"{Hq}/{Hkv} D={D} causal={causal} window={window}: "
          f"dq {errs[0]:.2e} dk {errs[1]:.2e} dv {errs[2]:.2e} "
          f"({time.time() - t:.1f} s)", flush=True)
    return ok


CASES = [
    # (B, Sq, Sk, Hq, Hkv, D, causal, window)
    (1, 100, 100, 2, 2, 64, True, 0),
    (1, 130, 130, 4, 1, 64, True, 17),
    (1, 70, 150, 2, 1, 64, True, 0),
    (1, 150, 70, 2, 1, 64, False, 20),
    (1, 1, 1, 1, 1, 64, True, 0),
    (1, 1, 300, 2, 1, 64, False, 0),
    (1, 65, 65, 2, 2, 128, True, 0),
    (1, 129, 129, 8, 1, 128, True, 33),
    (1, 40, 40, 2, 1, 192, True, 0),
    (1, 70, 90, 2, 2, 256, False, 20),
]


def main():
    L = build()
    quick = "--quick" in sys.argv
    ok = True
    for dtype in (torch.bfloat16, torch.float32):
        for c in CASES[:3] if quick else CASES:
            ok &= check(L, *c, dtype)
    print("all ok" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
