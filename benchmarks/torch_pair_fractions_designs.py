#!/usr/bin/env python3
"""Designs of the port's `pair_fractions` CUDA kernel, timed side by side.

Run from the root of a checkout on a machine with one NVIDIA GPU and the
CUDA toolkit:

    python3 benchmarks/torch_pair_fractions_designs.py [--out PATH]

Builds `src/repro_torch/kernels/csrc/netsim_kernels.cu` three times,
each with another kernel for rows of S <= 32 spines, and times each on
the giga-scale inputs of `chip_smoke.py`'s kernel phase ((2, 256, 256,
16), float64 and float32) in CUDA graphs of 20 calls, in the order
shipped, shuffle, tma, then back:

  shipped  the source as it is: each warp stages its tile in shared
           memory and one lane a row takes the row max and sum;
  shuffle  the shipped loads and logits, then the row max by a shuffle
           tree and the ordered row sum by S shuffles in every lane;
  tma      the shipped math on a persistent grid of 128-thread blocks,
           each warp's tiles brought into a two-stage shared-memory ring
           by bulk copies (`cp.async.bulk`, one lane, mbarrier
           completion) one tile ahead of the math.

Every design must equal the shipped kernel bit for bit.  Prints the
card's name and power limit, one line per design and dtype, and a JSON
object last.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SOURCE = ROOT / "src/repro_torch/kernels/csrc/netsim_kernels.cu"
OUT_DIR = ROOT / "build/repro_torch/pair_fractions_designs"
KERNEL_START = ("template <typename T, int G>\n__global__ void "
                "__launch_bounds__(kThreads) pair_fractions_warp_kernel(")
KERNEL_END = "// S > 32, the generic path"
LAUNCH_START = "template <typename T, int G>\nint launch_pair_fractions_warp("
LAUNCH_END = "// 1 / x when x is a power of two"
REDUCE_START = "      tile[row[u] * kStride + s] = l[u];\n"
REDUCE_END = "    __syncwarp();                                // every sum read\n"

SHUFFLE_REDUCE = r"""    }
#pragma unroll
    for (int u = 0; u < kPairUnroll; ++u) {
      T m = l[u];
#pragma unroll
      for (int off = G / 2; off > 0; off /= 2)
        m = max_(m, __shfl_xor_sync(0xffffffffu, m, off, G));
      const T ev = exp(l[u] - m);
      T sum = __shfl_sync(0xffffffffu, ev, 0, G);
#pragma unroll
      for (int k = 1; k < G; ++k) {
        const T v = __shfl_sync(0xffffffffu, ev, k, G);
        if (k < S) sum = sum + v;
      }
      if (live[u])
        out[base + row[u] * S + s] =
            sum > T(0) ? ev / max_(sum, T(1e-30)) : T(0);
    }
"""

TMA_KERNEL = r"""constexpr int kTmaThreads = 128;
constexpr int kTmaStages = 2;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <typename T, int G>
struct alignas(16) TmaSmem {
  T in[kTmaStages][3][kPairUnroll * 32];           // q, cap, w
  T rows[kPairUnroll * (32 / G)][G + 1];           // slot G: max, sum
  uint64_t bar[kTmaStages];
};

template <typename T, int G>
__global__ void __launch_bounds__(kTmaThreads) pair_fractions_warp_kernel(
    const T* __restrict__ q, const T* __restrict__ cap,
    const T* __restrict__ w, T* __restrict__ out, int64_t R, int S, T hi,
    T qmax, T nbins, T temperature, T inv_qmax, T inv_temperature) {
  constexpr int kRowsPerPass = 32 / G;
  constexpr int kTileRows = kPairUnroll * kRowsPerPass;
  __shared__ TmaSmem<T, G> smem[kTmaThreads / 32];
  const int lane = threadIdx.x & 31;
  const int s = lane % G;
  const int sub = lane / G;
  TmaSmem<T, G>& sm = smem[threadIdx.x / 32];
  const int64_t warp = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) / 32;
  const int64_t step = (int64_t)gridDim.x * blockDim.x / 32 * kTileRows;
  const uint32_t bytes = kTileRows * S * sizeof(T);
  const T* const src[3] = {q, cap, w};
  auto whole = [&](int64_t first) { return first + kTileRows <= R; };
  auto fetch = [&](int64_t first, int stage) {
    if (lane == 0 && first < R && whole(first)) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
              smem_addr(&sm.bar[stage])), "r"(3 * bytes) : "memory");
#pragma unroll
      for (int k = 0; k < 3; ++k)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
            "::bytes [%0], [%1], %2, [%3];" ::"r"(smem_addr(sm.in[stage][k])),
            "l"(src[k] + first * S), "r"(bytes),
            "r"(smem_addr(&sm.bar[stage])) : "memory");
    }
  };
  if (lane == 0) {
    for (int k = 0; k < kTmaStages; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
          smem_addr(&sm.bar[k])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
  for (int k = 0; k < kTmaStages; ++k) fetch(warp * kTileRows + k * step, k);
  int i = 0;
  for (int64_t first = warp * kTileRows; first < R; first += step, ++i) {
    const int stage = i % kTmaStages;
    T vq[kPairUnroll], vc[kPairUnroll], vw[kPairUnroll];
    bool live[kPairUnroll];
    if (whole(first)) {
      uint32_t done = 0;
      while (!done)
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}"
            : "=r"(done)
            : "r"(smem_addr(&sm.bar[stage])), "r"((i / kTmaStages) & 1)
            : "memory");
#pragma unroll
      for (int u = 0; u < kPairUnroll; ++u) {
        const int j = (u * kRowsPerPass + sub) * S + s;
        live[u] = s < S;
        vq[u] = live[u] ? sm.in[stage][0][j] : T(0);
        vc[u] = live[u] ? sm.in[stage][1][j] : T(0);
        vw[u] = live[u] ? sm.in[stage][2][j] : T(0);
      }
      __syncwarp();                              // the stage is read
      fetch(first + kTmaStages * step, stage);
    } else {
#pragma unroll
      for (int u = 0; u < kPairUnroll; ++u) {
        const int64_t row = first + u * kRowsPerPass + sub;
        live[u] = s < S && row < R;
        vq[u] = live[u] ? __ldg(q + row * S + s) : T(0);
        vc[u] = live[u] ? __ldg(cap + row * S + s) : T(0);
        vw[u] = live[u] ? __ldg(w + row * S + s) : T(0);
      }
    }
    T l[kPairUnroll], e[kPairUnroll];
#pragma unroll
    for (int u = 0; u < kPairUnroll; ++u) {
      l[u] = live[u] ? pair_logit(vq[u], vc[u], vw[u], hi, qmax, nbins,
                                  temperature, inv_qmax, inv_temperature)
                     : T(-1e30);
      sm.rows[u * kRowsPerPass + sub][s] = l[u];
    }
    __syncwarp();
    for (int r = lane; r < kTileRows; r += 32) {
      T m = sm.rows[r][0];
#pragma unroll
      for (int k = 1; k < G; ++k)
        if (k < S) m = max_(m, sm.rows[r][k]);
      sm.rows[r][G] = m;
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < kPairUnroll; ++u)
      e[u] = exp(l[u] - sm.rows[u * kRowsPerPass + sub][G]);
    __syncwarp();
#pragma unroll
    for (int u = 0; u < kPairUnroll; ++u)
      sm.rows[u * kRowsPerPass + sub][s] = e[u];
    __syncwarp();
    for (int r = lane; r < kTileRows; r += 32) {
      T sum = sm.rows[r][0];
#pragma unroll
      for (int k = 1; k < G; ++k)
        if (k < S) sum = sum + sm.rows[r][k];
      sm.rows[r][G] = sum;
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < kPairUnroll; ++u) {
      const T sum = sm.rows[u * kRowsPerPass + sub][G];
      if (live[u])
        out[(first + u * kRowsPerPass + sub) * S + s] =
            sum > T(0) ? e[u] / max_(sum, T(1e-30)) : T(0);
    }
    __syncwarp();
  }
}

"""

TMA_LAUNCH = r"""template <typename T, int G>
int launch_pair_fractions_warp(const T* q, const T* cap, const T* w,
                               T* out, int64_t R, int S, T hi, T qmax,
                               T nbins, T temperature, T inv_qmax,
                               T inv_temperature, cudaStream_t s) {
  if (((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(cap) |
        reinterpret_cast<uintptr_t>(w)) & 15) != 0)
    return cudaErrorInvalidValue;          // bulk copies: 16-byte aligned
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, pair_fractions_warp_kernel<T, G>, kTmaThreads, 0);
  constexpr int64_t kBlockRows = (kTmaThreads / 32) * kPairUnroll * (32 / G);
  int64_t blocks = (R + kBlockRows - 1) / kBlockRows;
  if (blocks > (int64_t)sms * per_sm) blocks = (int64_t)sms * per_sm;
  pair_fractions_warp_kernel<T, G>
      <<<static_cast<unsigned>(blocks), kTmaThreads, 0, s>>>(
          q, cap, w, out, R, S, hi, qmax, nbins, temperature, inv_qmax,
          inv_temperature);
  return cudaGetLastError();
}

"""


def _splice(src: str, start: str, end: str, new: str) -> str:
    i, j = src.index(start), src.index(end)
    return src[:i] + new + src[j:]


def design_sources() -> dict:
    """The source of each design, from the shipped one."""
    src = SOURCE.read_text()
    kernel = src[src.index(KERNEL_START):src.index(KERNEL_END)]
    i = kernel.index(REDUCE_START)
    j = kernel.index(REDUCE_END) + len(REDUCE_END)
    shuffle = kernel[:i] + SHUFFLE_REDUCE + kernel[j:]
    tma = _splice(_splice(src, KERNEL_START, KERNEL_END, TMA_KERNEL),
                  LAUNCH_START, LAUNCH_END, TMA_LAUNCH)
    return {"shipped": src,
            "shuffle": _splice(src, KERNEL_START, KERNEL_END, shuffle),
            "tma": tma}


def build_all(sources: dict) -> dict:
    """One nvcc per design, all started together; the loaded libraries."""
    from repro_torch.kernels import build
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = OUT_DIR / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
             str(OUT_DIR / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        (OUT_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(OUT_DIR / f"lib{name}.so"))
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"netsim_pair_fractions_{suffix}")
            fn.argtypes = build._ENTRIES["pair_fractions"][2]
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    import torch
    import chip_smoke as smoke

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", type=Path, default=None,
                        help="also write the results as JSON here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("pair_fractions designs: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    libs = build_all(design_sources())
    names = list(libs)
    rows = []
    for dtype in (torch.float64, torch.float32):
        case = next(c for c in smoke.kernel_cases(
            "giga", smoke.SHAPES["giga"], dtype, seed=0)
            if c["kernel"] == "pair_fractions")
        cells = dict(zip(case["run"].__code__.co_freevars,
                         (c.cell_contents for c in case["run"].__closure__)))
        q, cap, w = cells["q"], cells["cap"], cells["w"]
        S = q.shape[-1]
        suffix = "f64" if dtype == torch.float64 else "f32"

        def run(name):
            out = torch.empty_like(q)
            rc = getattr(libs[name], f"netsim_pair_fractions_{suffix}")(
                q.data_ptr(), cap.data_ptr(), w.data_ptr(), out.data_ptr(),
                q.numel() // S, S, 1 - 1e-9, 8.0, 16.0, 0.25,
                torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"{name}: CUDA error {rc}")
            return out

        want = run("shipped")
        times = {n: [] for n in names}
        for name in names + names[::-1]:
            times[name].append(smoke.graph_ms(lambda n=name: run(n)))
        bound = case["bytes"] / smoke.HBM_BYTES_PER_S * 1e3
        for name in names:
            equal = torch.equal(run(name), want)
            row = dict(design=name, dtype=suffix, shape=list(q.shape),
                       ms=min(times[name]), ms_runs=times[name],
                       bound_ms=bound, bit_equal_to_shipped=equal)
            rows.append(row)
            print(f"pair_fractions {name} giga {suffix}: "
                  f"ms={row['ms']:.6f} (runs {', '.join(f'{t:.6f}' for t in times[name])}) "
                  f"bound_ms={bound:.6f} "
                  f"share_of_bound={bound / row['ms']:.3f} "
                  f"bit_equal_to_shipped={equal}", flush=True)
            if not equal:
                print(f"{name}: differs from the shipped kernel",
                      file=sys.stderr)
                return 1
    result = {"nvidia_smi": smi, "designs": rows}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
