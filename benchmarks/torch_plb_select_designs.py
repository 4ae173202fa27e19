#!/usr/bin/env python3
"""Designs of the port's `plb_select` CUDA kernel, timed side by side.

Run from the root of a checkout on a machine with one NVIDIA GPU and the
CUDA toolkit:

    python3 benchmarks/torch_plb_select_designs.py [--parent DIR] [--out PATH]

Builds `src/repro_torch/kernels/csrc/netsim_kernels.cu` once per design,
all `nvcc` started together, and times each design's
`netsim_plb_select_f32` on the packet batches `chip_smoke.py` runs (4
planes x 4,096 packets, and 4,097 for a tail; `chip_smoke.packet_inputs`)
in CUDA graphs of 20 calls, in design order and then back:

  first      the kernel of an earlier checkout (`--parent DIR`, the root
             of a checkout whose kernel took one thread a packet in
             blocks of 256 with P read at run time, and read the plane
             vectors inside its guarded plane loops); left out without
             it;
  shipped    the source as it is: the plane vectors loaded once a
             thread, P at compile time for P = 1, 2, 4, one packet a
             thread in blocks of 256, a grid covering N;
  t{b}_k{k}  the shipped kernel's body in blocks of b threads with k
             packets a thread, in one 4k-byte access each of tx, hash
             and plane where the pointers are aligned to it (element
             accesses in the tail and otherwise), spliced in place of
             the shipped kernel and its launch.

Every design must equal the plain version (`ref.plb_select_ref`) bit for
bit at P = 1..8 and N in {1, 31, 4,096, 4,097}, on random queues, on
equal queues (the hashed tie-break decides) and with no plane passing
the rate filter (the eligible fallback).  Prints the card's name and
power limit, one line per design and shape, and a JSON object last.
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
OUT_DIR = ROOT / "build/repro_torch/plb_select_designs"
# the shipped kernel and its launch, which the t{b}_k{k} designs replace
SHIPPED_KERNEL = "// one thread a packet; the planes at compile time"
KERNEL_END = "template <typename T, int MODE>\nvoid launch_split_planes("
SHIPPED_LAUNCH = "int launch_plb_select("
LAUNCH_END = "}  // namespace"
THREADS = "constexpr int kPlbThreads = "
PACKETS = "constexpr int kPlbPackets = "
# (threads a block, packets a thread) of the t{b}_k{k} designs
GRID = ((256, 1), (128, 1), (64, 1), (32, 1), (256, 2), (64, 2), (32, 2),
        (256, 4), (64, 4), (32, 4))
SHAPES = ((4, 4096), (4, 4097))
CHECK_N = (1, 31, 4096, 4097)


PACKETS_KERNEL = r"""constexpr int kPlbThreads = 64;       // threads a block
constexpr int kPlbPackets = 1;        // packets a thread: 1, 2 or 4
static_assert(kPlbPackets == 1 || kPlbPackets == 2 || kPlbPackets == 4,
              "packets a thread");

// K packets of 4-byte elements in one access
template <int K> struct PlbAccess;
template <> struct PlbAccess<1> { using type = uint32_t; };
template <> struct PlbAccess<2> { using type = uint2; };
template <> struct PlbAccess<4> { using type = uint4; };

template <int K, typename E>
__device__ __forceinline__ void load_packets(const E* __restrict__ src,
                                             E (&dst)[K]) {
  const auto v =
      *reinterpret_cast<const typename PlbAccess<K>::type*>(src);
  memcpy(dst, &v, sizeof(v));
}

// NP = 1, 2, 4: the planes at compile time; NP = 0: P at run time
// (<= kMaxPlanes).  VEC: tx, hash and plane take one access of
// kPlbPackets elements a thread (aligned to it).
template <int NP, bool VEC>
__global__ void __launch_bounds__(kPlbThreads) plb_select_kernel(
    const float* __restrict__ rate, const float* __restrict__ elig,
    const float* __restrict__ queue, const float* __restrict__ tx,
    const uint32_t* __restrict__ hash, int32_t* __restrict__ plane,
    int64_t N, int P_rt) {
  constexpr int M = NP > 0 ? NP : kMaxPlanes;
  constexpr int K = kPlbPackets;
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
  const int64_t step = (int64_t)gridDim.x * blockDim.x * K;
  for (int64_t n0 = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) * K;
       n0 < N; n0 += step) {
    const bool whole = VEC && n0 + K <= N;
    float t[K];
    uint32_t h[K];
    if (whole) {
      load_packets<K>(tx + n0, t);
      load_packets<K>(hash + n0, h);
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        t[k] = n0 + k < N ? __ldg(tx + n0 + k) : 0.0f;
        h[k] = n0 + k < N ? __ldg(hash + n0 + k) : 0u;
      }
    }
    int32_t o[K];
#pragma unroll
    for (int k = 0; k < K; ++k) o[k] = plb_plane<M>(r, e, q, P, t[k], h[k]);
    if (whole) {
      typename PlbAccess<K>::type v;
      memcpy(&v, o, sizeof(v));
      *reinterpret_cast<typename PlbAccess<K>::type*>(plane + n0) = v;
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (n0 + k < N) plane[n0 + k] = o[k];
    }
  }
}

"""

PACKETS_LAUNCH = r"""inline bool aligned_to(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <int NP>
void launch_plb_planes(const float* rate, const float* elig,
                       const float* queue, const float* tx,
                       const uint32_t* hash, int32_t* plane, int64_t N,
                       int P, cudaStream_t s) {
  constexpr int64_t kPerBlock = (int64_t)kPlbThreads * kPlbPackets;
  int64_t blocks = (N + kPerBlock - 1) / kPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  constexpr int kBytes = 4 * kPlbPackets;
  if (kPlbPackets > 1 && aligned_to(tx, kBytes) &&
      aligned_to(hash, kBytes) && aligned_to(plane, kBytes))
    plb_select_kernel<NP, true>
        <<<static_cast<unsigned>(blocks), kPlbThreads, 0, s>>>(
            rate, elig, queue, tx, hash, plane, N, P);
  else
    plb_select_kernel<NP, false>
        <<<static_cast<unsigned>(blocks), kPlbThreads, 0, s>>>(
            rate, elig, queue, tx, hash, plane, N, P);
}

int launch_plb_select(const void* rate_, const void* elig_,
                      const void* queue_, const void* tx_,
                      const void* hash_, void* plane_, int64_t N, int P,
                      void* stream) {
  if (P < 1 || P > kMaxPlanes) return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* rate = static_cast<const float*>(rate_);
  const float* elig = static_cast<const float*>(elig_);
  const float* queue = static_cast<const float*>(queue_);
  const float* tx = static_cast<const float*>(tx_);
  const uint32_t* hash = static_cast<const uint32_t*>(hash_);
  int32_t* plane = static_cast<int32_t*>(plane_);
  switch (P) {
    case 1:
      launch_plb_planes<1>(rate, elig, queue, tx, hash, plane, N, P, s);
      break;
    case 2:
      launch_plb_planes<2>(rate, elig, queue, tx, hash, plane, N, P, s);
      break;
    case 4:
      launch_plb_planes<4>(rate, elig, queue, tx, hash, plane, N, P, s);
      break;
    default:
      launch_plb_planes<0>(rate, elig, queue, tx, hash, plane, N, P, s);
  }
  return cudaGetLastError();
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
    one, and the t{b}_k{k} designs spliced into the shipped one."""
    src = (ROOT / SOURCE_PATH).read_text()
    out = {}
    if parent is not None:
        out["first"] = (parent / SOURCE_PATH).read_text()
    out["shipped"] = src
    packets = src.replace("#include <cstdint>\n",
                          "#include <cstdint>\n#include <cstring>\n", 1)
    packets = _splice(_splice(packets, SHIPPED_KERNEL, KERNEL_END,
                              PACKETS_KERNEL),
                      SHIPPED_LAUNCH, LAUNCH_END, PACKETS_LAUNCH)
    for b, k in GRID:
        out[f"t{b}_k{k}"] = _set(_set(packets, THREADS, b), PACKETS, k)
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
        fn = lib.netsim_plb_select_f32
        fn.argtypes = build._ENTRIES["plb_select"][2]
        fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def check_cases(seed: int = 0):
    """(name, operands) at every P in 1..8 and N in CHECK_N: random
    queues, equal queues, and rates no plane's allowance meets."""
    import chip_smoke as smoke
    out = []
    for P in range(1, 9):
        for N in CHECK_N:
            for kind in ("random", "equal queues", "no plane passes"):
                ra, el, lq, tx, h = smoke.packet_inputs(
                    P, N, seed + 100 * P + N)
                if kind == "equal queues":
                    lq = lq.new_full((P,), 0.5)
                elif kind == "no plane passes":
                    ra = ra.new_zeros((P,))
                    tx = tx + 0.01
                out.append((f"P={P} N={N} {kind}", (ra, el, lq, tx, h)))
    return out


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
        print("plb_select designs: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    libs = build_all(design_sources(args.parent))
    names = list(libs)

    def run(name, ra, el, lq, tx, h):
        out = torch.empty(tx.shape, dtype=torch.int32, device="cuda")
        rc = libs[name].netsim_plb_select_f32(
            ra.data_ptr(), el.data_ptr(), lq.data_ptr(), tx.data_ptr(),
            h.data_ptr(), out.data_ptr(), tx.shape[0], ra.shape[0],
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{name}: CUDA error {rc}")
        return out

    checks = [(what, a, ref.plb_select_ref(*a)) for what, a in
              check_cases()]
    rows = []
    for lanes, N in SHAPES:
        a = smoke.packet_inputs(lanes, N, seed=N + 1)
        times = {n: [] for n in names}
        for name in names + names[::-1]:
            times[name].append(smoke.graph_ms(lambda n=name: run(n, *a)))
        bound = (3 * lanes * 4 + 3 * N * 4) / smoke.HBM_BYTES_PER_S * 1e3
        for name in names:
            equal = torch.equal(run(name, *a), ref.plb_select_ref(*a))
            row = dict(design=name, shape=[lanes, N], ms=min(times[name]),
                       ms_runs=times[name], bound_ms=bound,
                       bit_equal_to_plain=equal)
            rows.append(row)
            print(f"plb_select {name} {lanes}x{N}: ms={row['ms']:.6f} "
                  f"(runs {', '.join(f'{t:.6f}' for t in times[name])}) "
                  f"bound_ms={bound:.6f} bit_equal_to_plain={equal}",
                  flush=True)
            if not equal:
                print(f"{name}: differs from the plain version",
                      file=sys.stderr)
                return 1
    for name in names:
        bad = [what for what, a, want in checks
               if not torch.equal(run(name, *a), want)]
        if bad:
            print(f"{name}: differs from the plain version at "
                  f"{', '.join(bad[:8])}", file=sys.stderr)
            return 1
    print(f"every design equal to the plain version in {len(checks)} "
          "further cases (P = 1..8, N in "
          f"{', '.join(map(str, CHECK_N))}; random, equal queues, no "
          "plane passing)", flush=True)
    result = {"nvidia_smi": smi, "designs": rows}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
