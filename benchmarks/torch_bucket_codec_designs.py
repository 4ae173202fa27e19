#!/usr/bin/env python3
"""Designs of the port's `bucket_load_bottleneck` and `int8_encode` CUDA
kernels, timed side by side.

Run from the root of a checkout on a machine with one NVIDIA GPU and the
CUDA toolkit:

    python3 benchmarks/torch_bucket_codec_designs.py [--parent DIR] [--out PATH]
        [--only bucket|codec]

Builds `src/repro_torch/kernels/csrc/netsim_kernels.cu` and
`model_kernels.cu` once per design, all `nvcc` started together, and
times each design in CUDA graphs of 20 calls, in design order and then
back.

bucket_load_bottleneck, on the giga point's ECMP plan (P = 2, R = 8,192,
C = 47; `chip_smoke.ecmp_plan`) in float64 and float32:

  first        the kernel of an earlier checkout (`--parent DIR`, the
               root of a checkout); left out without it;
  shipped      the source as it is;
  g{G}_r{K}    a group of G lanes a bucket, K buckets a group at once
               (K = 1, 2, 4 where the stage fits in 48 KB), the values
               staged in shared memory and walked by one lane a bucket;
  g{G}_shfl    a group of G lanes a bucket, one bucket a group, every
               lane of the group walking the values by shuffles.

int8_encode at `chip_smoke.CODEC_SHAPE` (4,096 x 14,336) in float32 and
bfloat16:

  first        the kernel of `--parent DIR`;
  shared, two_pass
               the shipped source's shared instance (its pick at this
               shape: the row brought in by one TMA bulk copy) and
               two-pass instance;
  shared_loads the shared instance with the row staged by the threads'
               own 16-byte loads instead of TMA;
  regs32       the register instance with up to 32 elements a thread
               (7 f32 or 4 bf16 loads at 14,336; the shipped one holds
               16), the noise held in registers across the max-reduce;
  regs32_2blk  the same held to 2 blocks an SM (`__launch_bounds__`);
  regs32_late  the same with the noise loaded after the max-reduce;
  regs32_cpasync
               the same with each thread's noise copied to shared memory
               by cp.async instead of held in registers;

and regs32 (at C <= 8,192 the shipped register instance's kernel),
regs32_cpasync and shared at the row lengths SWEEP_C, each at the same
elements a call.

Every design must equal the plain version bit for bit (`ref`), the
bucket designs also on random plans with pads mid-row (C = 13 and 130,
several passes); the codec designs also at C = 1001 (element loads).
Prints the card's name and power limit, one line per design and dtype,
and a JSON object last.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

NETSIM = "src/repro_torch/kernels/csrc/netsim_kernels.cu"
MODEL = "src/repro_torch/kernels/csrc/model_kernels.cu"
BUILD_PY = "src/repro_torch/kernels/build.py"
# row lengths of the codec's instance sweep (elements a call as at
# CODEC_SHAPE)
SWEEP_C = (1024, 2048, 4096, 8192, 14336)
OUT_DIR = ROOT / "build/repro_torch/bucket_codec_designs"
LANES = "constexpr int kBucketLanes = "
ROWS = "constexpr int kBucketRows = "
WALK = "      // the pass's walk: stage the values"
WALK_END = "      // end of the pass's walk"
MAX_ELEMS = "constexpr int kEncMaxElems = "
NOISE_EARLY = """#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int64_t j = threadIdx.x + (int64_t)k * blockDim.x;
      if (j < loads) load_noise<W>(nr, j, nz[k]);
    }
"""
AFTER_SCALE = """    const float s = fmaxf(amax, 1e-12f) / 127.0f;   // IEEE division
#pragma unroll
    for (int k = 0; k < VPT; ++k) {"""
SHARED_KERNEL = ("template <typename T, int W>\n__global__ void "
                 "__launch_bounds__(kEncThreads)\nint8_encode_shared_kernel(")
SHARED_END = "template <typename T>\n__global__ void " \
    "__launch_bounds__(kCodecThreads)\nint8_encode_two_pass_kernel("

# neighbouring groups take the P planes of one bucket row instead of
# neighbouring rows of one plane (the plan's layout stays (P, R, C))
SHUFFLE_WALK = r"""      // the pass's walk by shuffles: every lane of the group adds the
      // group's values in column order (one bucket a group)
      static_assert(kBucketRows == 1, "one bucket a group");
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int k = 0; k < G; ++k) {
          const T y = __shfl_sync(0xffffffffu, v[0][u], k, G);
          const int c = c0 + u * G + k;
          if (c < C) acc = c == 0 ? y : acc + y;
        }
"""

LOADS_KERNEL = r"""template <typename T, int W>
__global__ void __launch_bounds__(kEncThreads)
int8_encode_shared_kernel(const T* __restrict__ x,
                          const float* __restrict__ noise,
                          int8_t* __restrict__ q, float* __restrict__ scale,
                          int64_t R, int64_t C) {
  // the row staged by the threads' own loads, each thread reading back
  // only what it staged
  extern __shared__ __align__(16) unsigned char enc_smem[];
  float* red = reinterpret_cast<float*>(enc_smem + 16);
  XLoad<T, W>* xs =
      reinterpret_cast<XLoad<T, W>*>(enc_smem + kEncHeadBytes);
  const int64_t loads = C / W;
  for (int64_t row = blockIdx.x; row < R; row += gridDim.x) {
    const T* xr = x + row * C;
    float amax = 0.f;
#pragma unroll 4
    for (int64_t j = threadIdx.x; j < loads; j += blockDim.x) {
      const XLoad<T, W> v = load_x<T, W>(xr, j);
      xs[j] = v;
      float xf[W];
      unpack_x<T, W>(v, xf);
#pragma unroll
      for (int e = 0; e < W; ++e) amax = fmaxf(amax, fabsf(xf[e]));
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
  }
}

"""


# the register instance with each thread's noise copied to shared
# memory by cp.async (in flight across the max-reduce without holding
# registers), and its launch with the dynamic shared memory that takes
REGS_KERNEL = ("template <typename T, int W, int VPT>\n__global__ void "
               "__launch_bounds__(kEncThreads)\n"
               "int8_encode_registers_kernel(")
REGS_LAUNCH = "template <typename T, int W, int VPT>\nint launch_encode_registers("
REGS_LAUNCH_END = "template <typename T, int W>\nint launch_encode_registers_vpt("
CPASYNC_KERNEL = r"""// W noise floats of load j into shared memory by cp.async
template <int W>
__device__ __forceinline__ void copy_noise(float* dst,
                                           const float* __restrict__ row,
                                           int64_t j) {
  const uint32_t d = smem_addr(dst);
  if constexpr (W == 1) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d),
                 "l"(row + j) : "memory");
  } else {
#pragma unroll
    for (int h = 0; h < W / 4; ++h)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d + 16 * h),
                   "l"(row + j * W + 4 * h) : "memory");
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
  extern __shared__ __align__(16) float enc_noise[];
  const int64_t loads = C / W;
  for (int64_t row = blockIdx.x; row < R; row += gridDim.x) {
    const T* xr = x + row * C;
    const float* nr = noise + row * C;
    XLoad<T, W> xv[VPT];
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int64_t j = threadIdx.x + (int64_t)k * blockDim.x;
      if (j < loads) xv[k] = load_x<T, W>(xr, j);
    }
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int64_t j = threadIdx.x + (int64_t)k * blockDim.x;
      if (j < loads)
        copy_noise<W>(enc_noise + (k * blockDim.x + threadIdx.x) * W, nr,
                      j);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
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
    asm volatile("cp.async.wait_all;" ::: "memory");
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int64_t j = threadIdx.x + (int64_t)k * blockDim.x;
      if (j < loads) {
        float xf[W], nz[W];
        unpack_x<T, W>(xv[k], xf);
        const float* src = enc_noise + (k * blockDim.x + threadIdx.x) * W;
#pragma unroll
        for (int e = 0; e < W; ++e) nz[e] = src[e];
        store_codes<W>(q + row * C, j, xf, s, nz);
      }
    }
    if (threadIdx.x == 0) scale[row] = s;
  }
}

"""
CPASYNC_LAUNCH = r"""template <typename T, int W, int VPT>
int launch_encode_registers(const T* x, const float* noise, int8_t* q,
                            float* scale, int64_t R, int64_t C,
                            cudaStream_t st) {
  const int64_t loads = C / W;
  const int64_t need = (loads + VPT - 1) / VPT;
  const int threads = static_cast<int>((need + 31) / 32 * 32);
  const int smem = threads * VPT * W * 4;
  auto kernel = int8_encode_registers_kernel<T, W, VPT>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<row_blocks(R), threads, smem, st>>>(x, noise, q, scale, R, C);
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


def netsim_sources(parent) -> dict:
    src = (ROOT / NETSIM).read_text()
    out = {}
    if parent is not None:
        out["first"] = (parent / NETSIM).read_text()
    out["shipped"] = src
    for g in (8, 16, 32):
        for k in (1, 2, 4):
            if 32 // g * k <= 8:      # the f64 stage fits 48 KB
                out[f"g{g}_r{k}"] = _set(_set(src, LANES, g), ROWS, k)
    shuffle = _set(_splice(src, WALK, WALK_END, SHUFFLE_WALK), ROWS, 1)
    for g in (8, 16, 32):
        out[f"g{g}_shfl"] = _set(shuffle, LANES, g)
    return out


def model_sources(parent) -> dict:
    src = (ROOT / MODEL).read_text()
    out = {}
    if parent is not None:
        out["first"] = (parent / MODEL).read_text()
    out["shipped"] = src
    out["shared_loads"] = _splice(src, SHARED_KERNEL, SHARED_END,
                                  LOADS_KERNEL)
    # the register instance with 32 elements a thread (7 f32 or 4 bf16
    # loads at 14,336), as it came first, and three variants of it
    wide = _set(src, MAX_ELEMS, 32)
    out["regs32"] = wide
    out["regs32_2blk"] = wide.replace(REGS_KERNEL, REGS_KERNEL.replace(
        "__launch_bounds__(kEncThreads)", "__launch_bounds__(kEncThreads, 2)"))
    if NOISE_EARLY not in src or AFTER_SCALE not in src:
        raise RuntimeError("register instance anchors not found")
    out["regs32_late"] = wide.replace(NOISE_EARLY, "", 1).replace(
        AFTER_SCALE, AFTER_SCALE.replace(
            "#pragma unroll\n    for (int k = 0; k < VPT; ++k) {",
            NOISE_EARLY + "#pragma unroll\n    for (int k = 0; k < VPT; "
            "++k) {"), 1)
    out["regs32_cpasync"] = _splice(
        _splice(wide, REGS_KERNEL, SHARED_KERNEL, CPASYNC_KERNEL),
        REGS_LAUNCH, REGS_LAUNCH_END, CPASYNC_LAUNCH)
    return out


def build_all(sources: dict) -> dict:
    """One nvcc per (source, design), all started together; the loaded
    libraries by (source, design)."""
    from repro_torch.kernels import build
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for (kind, name), text in sources.items():
        cu = OUT_DIR / f"{kind}_{name}.cu"
        cu.write_text(text)
        procs[kind, name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
             str(OUT_DIR / f"lib{kind}_{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    failed = []
    for (kind, name), proc in procs.items():
        log = proc.communicate()[0]
        (OUT_DIR / f"{kind}_{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{kind} {name}:\n{log[-4000:]}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {key: ctypes.CDLL(str(OUT_DIR / f"lib{key[0]}_{key[1]}.so"))
            for key in procs}


def entry(lib, symbol: str, argtypes):
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def build_module(root: Path):
    """`repro_torch.kernels.build` of the checkout at `root`, for its
    entry points' argument types."""
    spec = importlib.util.spec_from_file_location(
        f"build_{abs(hash(str(root)))}", root / BUILD_PY)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_designs(runs: dict) -> dict:
    """CUDA-graph times of each `runs[name]()`, in order and then back."""
    import chip_smoke as smoke
    names = list(runs)
    times = {n: [] for n in names}
    for name in names + names[::-1]:
        times[name].append(smoke.graph_ms(runs[name]))
    return times


def bucket_rows(libs: dict, parent_build) -> list:
    import numpy as np
    import torch
    import chip_smoke as smoke
    from repro_torch.kernels import build, ref

    F, plan, cap64 = smoke.ecmp_plan("giga")
    P, R, C = plan.shape
    rng = np.random.default_rng(18)
    rows = []
    for dtype in (torch.float64, torch.float32):
        sfx = "f64" if dtype == torch.float64 else "f32"
        fns = {}
        for (kind, name), lib in libs.items():
            if kind == "netsim":
                types = (parent_build if name == "first" else build)._ENTRIES[
                    "bucket_load_bottleneck"][2]
                fns[name] = entry(lib, f"netsim_bucket_load_bottleneck_{sfx}",
                                  types)

        def call(name, rate, pl, cap):
            load, frac = torch.empty_like(cap), torch.empty_like(cap)
            Fr, Pp = rate.shape
            # one lane; an entry point before the lane axis takes no count
            lanes = (1,) if len(fns[name].argtypes) == 12 else ()
            rc = fns[name](rate.data_ptr(), pl.data_ptr(), cap.data_ptr(),
                           load.data_ptr(), frac.data_ptr(), *lanes, Fr, Pp,
                           pl.shape[1], pl.shape[2], 1e-12,
                           torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"{name}: CUDA error {rc}")
            return load, frac

        rate = rng.uniform(0.0, 1.0, (F, P))
        rate[rng.random((F, P)) < 0.1] = 0.0
        rate = torch.tensor(rate, dtype=dtype, device="cuda")
        cap = cap64.to(dtype)
        # random plans with pads anywhere, one and several passes
        checks = [(rate, plan, cap)]
        for c in (13, 130):
            r = torch.tensor(rng.uniform(0.0, 1.0, (1001, 3)), dtype=dtype,
                             device="cuda")
            pl = torch.tensor(rng.integers(0, 1002, (3, 37, c)),
                              dtype=torch.int32, device="cuda")
            checks.append((r, pl, torch.tensor(
                rng.uniform(0.0, 2.0, (3, 37)), dtype=dtype,
                device="cuda")))
        times = time_designs({n: (lambda n=n: call(n, rate, plan, cap))
                              for n in fns})
        isz = rate.element_size()
        bound = ((plan.numel() * 4 + rate.numel() * isz + 3 * P * R * isz)
                 / smoke.HBM_BYTES_PER_S * 1e3)
        for name in fns:
            equal = all(
                all(torch.equal(g, w) for g, w in zip(
                    call(name, r, pl, cp),
                    ref.load_bottleneck_ref(r, pl, cp, ordered=True)))
                for r, pl, cp in checks)
            rows.append(dict(kernel="bucket_load_bottleneck", design=name,
                             dtype=sfx, shape=[P, R, C],
                             ms=min(times[name]), ms_runs=times[name],
                             bound_ms=bound, bit_equal_to_plain=equal))
    return rows


def codec_rows(libs: dict, parent_build) -> list:
    import torch
    import chip_smoke as smoke
    from repro_torch.kernels import build, int8_codec, ref

    R, C = smoke.CODEC_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(18)
    rows = []
    inst = {n: i for i, n in enumerate(int8_codec.ENCODE_INSTANCES)}
    for dtype in (torch.float32, torch.bfloat16):
        sfx = "f32" if dtype == torch.float32 else "bf16"
        designs = {}                  # name -> (fn, forced instance)
        for (kind, name), lib in libs.items():
            if kind != "model":
                continue
            types = (parent_build if name == "first" else build)._ENTRIES[
                "int8_encode"][2]
            fn = entry(lib, f"model_int8_encode_{sfx}", types)
            if name == "first":
                designs[name] = (fn, None)
            elif name == "shipped":     # its pick at CODEC_SHAPE: shared
                for i in ("shared", "two_pass"):
                    designs[i] = (fn, i)
            elif name == "shared_loads":
                designs[name] = (fn, "shared")
            else:
                designs[name] = (fn, "registers")

        def call(name, x, noise, q, scale):
            fn, forced = designs[name]
            args = [x.data_ptr(), noise.data_ptr(), q.data_ptr(),
                    scale.data_ptr(), x.shape[0], x.shape[1]]
            if forced is not None:
                _, width = int8_codec.encode_instance(x, noise)
                if forced == "two_pass":
                    width = 1
                args += [inst[forced], int(width > 1)]
            rc = fn(*args, torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"{name}: CUDA error {rc}")
            return q, scale

        def operands(r, c):
            x = (torch.randn((r, c), generator=gen, device="cuda")
                 * 1e-3).to(dtype)
            noise = torch.rand((r, c), generator=gen, device="cuda") - 0.5
            return (x, noise, torch.empty((r, c), dtype=torch.int8,
                                          device="cuda"),
                    torch.empty((r, 1), device="cuda"))

        main = operands(R, C)
        times = time_designs({n: (lambda n=n: call(n, *main))
                              for n in designs})
        bound = (R * C * (dtype.itemsize + 4 + 1) + R * 4) \
            / smoke.HBM_BYTES_PER_S * 1e3
        odd = operands(37, 1001)
        for name in designs:
            equal = True
            for ops_ in (main, odd):
                q, s = call(name, *ops_)
                q_ref, s_ref = ref.int8_encode_ref(ops_[0], ops_[1])
                equal &= torch.equal(q, q_ref) and torch.equal(
                    s.view(torch.int32), s_ref.view(torch.int32))
            rows.append(dict(kernel="int8_encode", design=name, dtype=sfx,
                             shape=[R, C], ms=min(times[name]),
                             ms_runs=times[name], bound_ms=bound,
                             bit_equal_to_plain=bool(equal)))
        del main, odd
        # the shipped register and shared instances over row lengths, at
        # the same elements a call
        for c in SWEEP_C:
            r = R * C // c
            ops_ = operands(r, c)
            pair = ("regs32", "regs32_cpasync", "shared")
            times = time_designs({n: (lambda n=n: call(n, *ops_))
                                  for n in pair})
            q_ref, s_ref = ref.int8_encode_ref(ops_[0], ops_[1])
            for name in pair:
                q, s = call(name, *ops_)
                equal = torch.equal(q, q_ref) and torch.equal(
                    s.view(torch.int32), s_ref.view(torch.int32))
                rows.append(dict(
                    kernel="int8_encode", design=f"{name} C={c}", dtype=sfx,
                    shape=[r, c], ms=min(times[name]), ms_runs=times[name],
                    bound_ms=(r * c * (dtype.itemsize + 4 + 1) + r * 4)
                    / smoke.HBM_BYTES_PER_S * 1e3,
                    bit_equal_to_plain=bool(equal)))
            del ops_, q_ref, s_ref
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="root of an earlier checkout whose kernels "
                             "are timed as the 'first' designs")
    parser.add_argument("--out", type=Path, default=None,
                        help="also write the results as JSON here")
    parser.add_argument("--only", choices=("bucket", "codec"), default=None,
                        help="time one kernel's designs only")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("bucket/codec designs: no CUDA device", file=sys.stderr)
        return 2
    card = smi()
    print(card, flush=True)
    sources = {}
    if args.only != "codec":
        sources.update({("netsim", n): t
                        for n, t in netsim_sources(args.parent).items()})
    if args.only != "bucket":
        sources.update({("model", n): t
                        for n, t in model_sources(args.parent).items()})
    libs = build_all(sources)
    parent_build = (build_module(args.parent) if args.parent is not None
                    else None)
    rows = ((bucket_rows(libs, parent_build) if args.only != "codec"
             else []) +
            (codec_rows(libs, parent_build) if args.only != "bucket"
             else []))
    for row in rows:
        print(f"{row['kernel']} {row['design']} {row['dtype']}: "
              f"ms={row['ms']:.6f} (runs "
              f"{', '.join(f'{t:.6f}' for t in row['ms_runs'])}) "
              f"bound_ms={row['bound_ms']:.6f} "
              f"share_of_bound={row['bound_ms'] / row['ms']:.3f} "
              f"bit_equal_to_plain={row['bit_equal_to_plain']}", flush=True)
    result = {"nvidia_smi": card, "designs": rows}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    bad = [f"{r['kernel']} {r['design']} {r['dtype']}" for r in rows
           if not r["bit_equal_to_plain"]]
    if bad:
        print(f"differ from the plain version: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
