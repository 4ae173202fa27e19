#!/usr/bin/env python3
"""Designs of the port's `plane_split` CUDA kernel, timed side by side.

Run from the root of a checkout on a machine with one NVIDIA GPU and the
CUDA toolkit:

    python3 benchmarks/torch_plane_split_designs.py [--parent DIR] [--out PATH]

Builds `src/repro_torch/kernels/csrc/netsim_kernels.cu` once per design,
all `nvcc` started together, and times each design's
`netsim_plane_split` on giga-scale inputs (102,400 flows x 2 planes,
spx, float64 and float32; `chip_smoke.plane_inputs`) in CUDA graphs of
20 calls, in design order and then back:

  first      the kernel of an earlier checkout (`--parent DIR`, the root
             of a checkout whose kernel took P at run time, one thread
             a flow, every plane loop guarded); left out without it;
  shipped    the source as it is: P at compile time, a row read element
             by element, one row a thread;
  rows{k}_sm{b}
             P at compile time with each row read in 16-byte or
             whole-row vector loads where the data is aligned for them,
             k rows in flight a thread (one a block width apart, all
             loads before the math) and at most b blocks a
             multiprocessor (b = 0: a grid covering F), 256-thread
             blocks; rows1_sm0 is the shipped kernel with row loads.

Every design must equal the plain version (`ref.plane_split_ref`) bit
for bit, in every mode.  Prints the card's name and power limit, one
line per design and dtype, and a JSON object last.
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

SOURCE_PATH = "src/repro_torch/kernels/csrc/netsim_kernels.cu"
OUT_DIR = ROOT / "build/repro_torch/plane_split_designs"
# the shipped kernel and its launch, which the rows designs replace
SHIPPED_KERNEL = "// NP = 1, 2, 4: the planes at compile time"
KERNEL_END = "// ---- pair_fractions ----"
SHIPPED_LAUNCH = "template <typename T, int MODE>\nvoid launch_split_planes("
LAUNCH_END = "template <typename T>\nint launch_plane_split("
ROWS = "constexpr int kSplitRows = "
BLOCKS = "constexpr int kSplitBlocksPerSm = "
# (rows a thread, blocks a multiprocessor) of the rows{k}_sm{b} designs
GRID = ((1, 0), (2, 0), (4, 0), (2, 4), (4, 2), (4, 4), (8, 2), (8, 4))

ROWS_KERNEL = r"""// a register image of 1-16 bytes, for row loads and stores
template <int BYTES> struct RawVec;
template <> struct RawVec<1> { using type = uint8_t; };
template <> struct RawVec<2> { using type = uint16_t; };
template <> struct RawVec<4> { using type = uint32_t; };
template <> struct RawVec<8> { using type = uint2; };
template <> struct RawVec<16> { using type = uint4; };

// the bytes of one access to a row of N elements of E: the whole row,
// or 16 when the row is longer
template <typename E, int N>
__host__ __device__ constexpr int row_chunk() {
  return N * (int)sizeof(E) < 16 ? N * (int)sizeof(E) : 16;
}

// dst[0, N) <- src[0, N): in accesses of row_chunk<E, N>() bytes when
// VEC (src aligned to that), else element by element
template <bool VEC, typename E, int N>
__device__ __forceinline__ void load_row(const E* __restrict__ src,
                                         E (&dst)[N]) {
  if constexpr (VEC) {
    constexpr int kChunk = row_chunk<E, N>();
    using V = typename RawVec<kChunk>::type;
    const V* s = reinterpret_cast<const V*>(src);
#pragma unroll
    for (int c = 0; c < N * (int)sizeof(E) / kChunk; ++c) {
      const V v = s[c];
      memcpy(reinterpret_cast<char*>(dst) + c * kChunk, &v, kChunk);
    }
  } else {
#pragma unroll
    for (int p = 0; p < N; ++p) dst[p] = src[p];
  }
}

template <bool VEC, typename E, int N>
__device__ __forceinline__ void store_row(E* __restrict__ dst,
                                          const E (&src)[N]) {
  if constexpr (VEC) {
    constexpr int kChunk = row_chunk<E, N>();
    using V = typename RawVec<kChunk>::type;
    V* d = reinterpret_cast<V*>(dst);
#pragma unroll
    for (int c = 0; c < N * (int)sizeof(E) / kChunk; ++c) {
      V v;
      memcpy(&v, reinterpret_cast<const char*>(src) + c * kChunk, kChunk);
      d[c] = v;
    }
  } else {
#pragma unroll
    for (int p = 0; p < N; ++p) dst[p] = src[p];
  }
}

constexpr int kSplitThreads = 256;
constexpr int kSplitRows = 4;           // rows in flight a thread
constexpr int kSplitBlocksPerSm = 4;    // grid cap; 0 = cover F at once

// NP = 1, 2, 4: the planes at compile time, rows loaded whole when
// VEC; NP = 0: P at run time (<= kMaxPlanes), element loads.
template <typename T, int MODE, int NP, bool VEC>
__global__ void __launch_bounds__(kSplitThreads) plane_split_kernel(
    const T* __restrict__ rate, const uint8_t* __restrict__ elig,
    const T* __restrict__ demand, T* __restrict__ out, int64_t F,
    int P_rt, T thresh, T fallback) {
  constexpr int N = NP > 0 ? NP : kMaxPlanes;
  const int P = NP > 0 ? NP : P_rt;
  const int64_t tile = (int64_t)kSplitRows * blockDim.x;
  for (int64_t first = blockIdx.x * tile + threadIdx.x; first < F;
       first += (int64_t)gridDim.x * tile) {
    T rr[kSplitRows][N];
    uint8_t eb[kSplitRows][N];
    T d[kSplitRows];
#pragma unroll
    for (int u = 0; u < kSplitRows; ++u) {
      const int64_t f = first + (int64_t)u * blockDim.x;
      if (f < F) {
        if constexpr (NP > 0) {
          load_row<VEC>(rate + f * NP, rr[u]);
          load_row<VEC>(elig + f * NP, eb[u]);
        } else {
#pragma unroll
          for (int p = 0; p < N; ++p) {
            rr[u][p] = p < P ? rate[f * P + p] : T(0);
            eb[u][p] = p < P ? elig[f * P + p] : 0;
          }
        }
        d[u] = demand[f];
      }
    }
#pragma unroll
    for (int u = 0; u < kSplitRows; ++u) {
      const int64_t f = first + (int64_t)u * blockDim.x;
      if (f < F) {
        T o[N];
        split_row<T, MODE, N>(rr[u], eb[u], d[u], P, thresh, fallback, o);
        if constexpr (NP > 0) {
          store_row<VEC>(out + f * NP, o);
        } else {
#pragma unroll
          for (int p = 0; p < N; ++p)
            if (p < P) out[f * P + p] = o[p];
        }
      }
    }
  }
}

"""

ROWS_LAUNCH = r"""// blocks for `rows` rows at kSplitRows a thread, at most
// kSplitBlocksPerSm a multiprocessor (the rest loop)
inline unsigned split_grid(int64_t rows) {
  const int64_t tile = (int64_t)kSplitRows * kSplitThreads;
  int64_t blocks = (rows + tile - 1) / tile;
  if (kSplitBlocksPerSm > 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int64_t cap = (int64_t)kSplitBlocksPerSm * (sms > 0 ? sms : 1);
    if (blocks > cap) blocks = cap;
  }
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<unsigned>(blocks);
}

inline bool aligned_to(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T, int MODE, int NP>
void launch_split(const T* r, const uint8_t* e, const T* d, T* o,
                  int64_t F, int P, T thresh, T fallback, cudaStream_t s) {
  const unsigned g = split_grid(F);
  const bool vec = aligned_to(r, row_chunk<T, NP>()) &&
                   aligned_to(o, row_chunk<T, NP>()) &&
                   aligned_to(e, row_chunk<uint8_t, NP>());
  if (vec)
    plane_split_kernel<T, MODE, NP, true><<<g, kSplitThreads, 0, s>>>(
        r, e, d, o, F, P, thresh, fallback);
  else
    plane_split_kernel<T, MODE, NP, false><<<g, kSplitThreads, 0, s>>>(
        r, e, d, o, F, P, thresh, fallback);
}

template <typename T, int MODE>
void launch_split_planes(const T* r, const uint8_t* e, const T* d, T* o,
                         int64_t F, int P, T thresh, T fallback,
                         cudaStream_t s) {
  switch (P) {
    case 1:
      return launch_split<T, MODE, 1>(r, e, d, o, F, P, thresh, fallback, s);
    case 2:
      return launch_split<T, MODE, 2>(r, e, d, o, F, P, thresh, fallback, s);
    case 4:
      return launch_split<T, MODE, 4>(r, e, d, o, F, P, thresh, fallback, s);
    default:
      plane_split_kernel<T, MODE, 0, false><<<split_grid(F), kSplitThreads,
                                              0, s>>>(
          r, e, d, o, F, P, thresh, fallback);
  }
}

"""




def _splice(src: str, start: str, end: str, new: str) -> str:
    i, j = src.index(start), src.index(end)
    return src[:i] + new + src[j:]


def _set(src: str, prefix: str, value) -> str:
    """`src` with the constant that `prefix` starts set to `value`."""
    i = src.index(prefix) + len(prefix)
    return src[:i] + str(value) + src[src.index(";", i):]


def design_sources(parent) -> dict:
    """The source of each design: the parent's as it is, the shipped
    one, and the rows designs spliced into the shipped one."""
    src = (ROOT / SOURCE_PATH).read_text()
    out = {}
    if parent is not None:
        out["first"] = (parent / SOURCE_PATH).read_text()
    out["shipped"] = src
    rows = src.replace("#include <cstdint>\n",
                       "#include <cstdint>\n#include <cstring>\n", 1)
    rows = _splice(_splice(rows, SHIPPED_KERNEL, KERNEL_END, ROWS_KERNEL),
                   SHIPPED_LAUNCH, LAUNCH_END, ROWS_LAUNCH)
    for k, b in GRID:
        out[f"rows{k}_sm{b}"] = _set(_set(rows, ROWS, k), BLOCKS, b)
    return out


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
            fn = getattr(lib, f"netsim_plane_split_{suffix}")
            fn.argtypes = build._ENTRIES["plane_split"][2]
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    import torch
    import chip_smoke as smoke
    from repro_torch.kernels import ref

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="root of an earlier checkout whose kernel "
                             "is timed as the 'first' design")
    parser.add_argument("--out", type=Path, default=None,
                        help="also write the results as JSON here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("plane_split designs: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    libs = build_all(design_sources(args.parent))
    names = list(libs)
    modes = {"spx": 0, "dcqcn": 1, "agg": 2, "swlb": 3}
    F, P = smoke.SHAPES["giga"]["F"], smoke.SHAPES["giga"]["P"]
    rows = []
    for dtype in (torch.float64, torch.float32):
        rate, elig, demand = smoke.plane_inputs(F, P, dtype, seed=0)
        suffix = "f64" if dtype == torch.float64 else "f32"
        isz = rate.element_size()

        def run(name, mode="spx"):
            out = torch.empty_like(rate)
            rc = getattr(libs[name], f"netsim_plane_split_{suffix}")(
                rate.data_ptr(), elig.data_ptr(), demand.data_ptr(),
                out.data_ptr(), F, P, modes[mode], 0.01 + 1e-9, 1.0 / P,
                torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"{name}: CUDA error {rc}")
            return out

        times = {n: [] for n in names}
        for name in names + names[::-1]:
            times[name].append(smoke.graph_ms(lambda n=name: run(n)))
        bound = ((F * P * (2 * isz + 1) + F * isz)
                 / smoke.HBM_BYTES_PER_S * 1e3)
        for name in names:
            equal = all(torch.equal(run(name, m), ref.plane_split_ref(
                rate, elig, demand, mode=m, min_rate=0.01)) for m in modes)
            row = dict(design=name, dtype=suffix, shape=[F, P],
                       ms=min(times[name]), ms_runs=times[name],
                       bound_ms=bound, bit_equal_to_plain=equal)
            rows.append(row)
            print(f"plane_split {name} giga {suffix}: "
                  f"ms={row['ms']:.6f} (runs "
                  f"{', '.join(f'{t:.6f}' for t in times[name])}) "
                  f"bound_ms={bound:.6f} "
                  f"share_of_bound={bound / row['ms']:.3f} "
                  f"bit_equal_to_plain={equal}", flush=True)
            if not equal:
                print(f"{name}: differs from the plain version",
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
