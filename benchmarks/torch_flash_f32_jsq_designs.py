#!/usr/bin/env python3
"""Designs of the port's float32 `flash_attention` and `jsq_route` CUDA
kernels, timed side by side.

Run from the root of a checkout on a machine with one NVIDIA GPU and the
CUDA toolkit:

    python3 benchmarks/torch_flash_f32_jsq_designs.py [--parent DIR]
        [--out PATH] [--only flash|jsq]

Builds `src/repro_torch/kernels/csrc/model_kernels.cu` (flash) and
`netsim_kernels.cu` (jsq_route) once per design, all `nvcc` started
together, and times each design in CUDA graphs (5 calls for flash, 20
for jsq_route), in design order and then back.

float32 flash_attention at the two prefills of `chip_smoke.py`
(llama3-8b: 32/8 heads, head_dim 128, 4,096 tokens, causal; gemma3-12b
local: 16/8 heads, head_dim 256, window 1,024), model layout:

  first        the kernel of an earlier checkout (`--parent DIR`, the
               root of a checkout); left out without it;
  tf32_w{W}_k{K}_k{K'}
               3xTF32 on the tensor cores (`mma.sync`), W warps of 16
               query rows a block, key tiles of K keys at head_dim <= 128
               and K' above; the shipped source's tiles are one of them;
  split_rna, split_rn_cut
               the shipped tiles with hi and lo both rounded by cvt.rna,
               or hi rounded by an integer add and lo cut, instead of
               both cut (a mask);
  col_groups_{N}
               the shipped tiles with N chains of P V (column steps of
               8) interleaved instead of 8;
  one_s_chain, no_tile_sums
               the shipped tiles with S summed in one chain of products
               over D instead of chunks of 4 steps (32 columns), or with P V
               accumulated onto O instead of summed a tile at a time
               and added by one fmaf; one_chain: both;
  cuda_cores   float32 FMAs on the CUDA cores, register-blocked: 128
               query rows a block, an 8 x 4 score tile a thread read
               from K-major Q and K tiles, K double-buffered by
               cp.async, the scale folded into Q, exp2 (head_dim <= 128
               only: at 256 its tiles do not fit in shared memory).

jsq_route at 256 ports x 4,096 packets (`chip_smoke.packet_inputs`),
random queues and equal scores (ties):

  first        the kernel of `--parent DIR`;
  g{G}         a group of G lanes a packet (G = 1: one thread a packet,
               the first kernel's walk), the shipped source's G among
               them.

Every flash design must be within 1e-4 (max abs) of the plain version
at both prefills and within 1e-5 on small cases at every head_dim it
takes; every jsq_route design must equal the plain version on every
case.  Prints the card's name and power limit, one line per design and
case, and a JSON object last.
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

NETSIM = "src/repro_torch/kernels/csrc/netsim_kernels.cu"
MODEL = "src/repro_torch/kernels/csrc/model_kernels.cu"
OUT_DIR = ROOT / "build/repro_torch/flash_jsq_designs"
F32_BEGIN = "// ---- flash_attention, float32 (3xTF32"
F32_END = "// ---- flash_attention, bf16 (wgmma + TMA)"
TILE_CONSTS = ("constexpr int kTfWarps = ",
               "constexpr int kTfBkNarrow = ", "constexpr int kTfBkWide = ")
S_CHUNK = "constexpr int kTfSChunk = "
COL_GROUPS = "constexpr int kTfColGroups = "
# the shipped split (both halves cut by a mask) and its variants
SPLIT_CUT = """  hi = __float_as_uint(x) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xFFFFE000u;
"""
SPLITS = {
    "split_rna": """  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
""",
    # hi rounded half away from zero by an integer add, lo cut
    "split_rn_cut": """  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xFFFFE000u;
"""}
# P V accumulated onto O (O x correction first), the first design's
# order, in place of the shipped tile sums
PV_BEGIN = "    // each key tile's P V sums in chains of its own"
PV_END = "    __syncthreads();                          // stage i % 2 free again"
PV_ONTO_O = """#pragma unroll
    for (int c = 0; c < DT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] *= corr[e / 2];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < DT; ++c) {
        const float* vj = vt + 8 * j * VS + 8 * c;
        uint32_t bh_[2], bl[2];
        split_tf32(vj[0], bh_[0], bl[0]);
        split_tf32(vj[VS], bh_[1], bl[1]);
        mma_3xtf32(acc[c], ph[j], pl[j], bh_, bl);
      }
"""
LANES = "constexpr int kJsqLanes = "
# (warps, keys a tile at head_dim <= 128, keys a tile above): each fits
# a block in 227 KB of shared memory (8 warps at 32 keys of head_dim 256
# do not)
TILES = ((8, 64, 16), (8, 32, 16), (4, 64, 32), (4, 32, 16))
JSQ_LANES = (1, 8, 16, 32)
# variants of the shipped tiles' constants: name -> {prefix: value}
VARIANTS = {"col_groups_2": {COL_GROUPS: 2},
            "col_groups_4": {COL_GROUPS: 4},
            "one_s_chain": {S_CHUNK: 64}}
PEAK_F32, PEAK_TF32 = 67e12, 495e12           # H100 SXM data sheet
FLASH_TOL, SMALL_TOL = 1e-4, 1e-5
CC_SOURCE = Path(__file__).with_name("torch_flash_f32_cuda_cores.cu")


def _splice(src: str, start: str, end: str, new: str) -> str:
    i, j = src.index(start), src.index(end)
    return src[:i] + new + src[j:]


def _set(src: str, prefix: str, value) -> str:
    """`src` with the constant that `prefix` starts set to `value`."""
    i = src.index(prefix) + len(prefix)
    return src[:i] + str(value) + src[src.index(";", i):]


def model_sources(parent) -> dict:
    src = (ROOT / MODEL).read_text()
    out = {}
    if parent is not None:
        out["first"] = (parent / MODEL).read_text()
    for tiles in TILES:
        text = src
        for prefix, value in zip(TILE_CONSTS, tiles):
            text = _set(text, prefix, value)
        out["tf32_w{}_k{}_k{}".format(*tiles)] = text
    for name, consts in VARIANTS.items():
        text = src
        for prefix, value in consts.items():
            text = _set(text, prefix, value)
        out[name] = text
    if SPLIT_CUT not in src:
        raise RuntimeError("split_tf32 anchor not found")
    for name, body in SPLITS.items():
        out[name] = src.replace(SPLIT_CUT, body, 1)
    out["no_tile_sums"] = _splice(src, PV_BEGIN, PV_END, PV_ONTO_O)
    out["one_chain"] = _set(out["no_tile_sums"], S_CHUNK, 64)
    out["cuda_cores"] = _splice(src, F32_BEGIN, F32_END,
                                CC_SOURCE.read_text())
    return out


def netsim_sources(parent) -> dict:
    src = (ROOT / NETSIM).read_text()
    out = {}
    if parent is not None:
        out["first"] = (parent / NETSIM).read_text()
    for g in JSQ_LANES:
        out[f"g{g}"] = _set(src, LANES, g)
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


def entry(lib, kernel: str):
    """`kernel`'s float32 entry point in `lib`, with the argument types
    of `repro_torch.kernels.build` (the same in the parent)."""
    import torch
    from repro_torch.kernels import build
    fn = getattr(lib, build.symbol(kernel, torch.float32))
    fn.argtypes = build._ENTRIES[kernel][2]
    fn.restype = ctypes.c_int
    return fn


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_designs(runs: dict, reps: int) -> dict:
    """CUDA-graph times of each `runs[name]()`, in order and then back."""
    import chip_smoke as smoke
    names = list(runs)
    times = {n: [] for n in names}
    for name in names + names[::-1]:
        times[name].append(smoke.graph_ms(runs[name], reps=reps))
    return times


def flash_call(fn, q, k, v, *, causal, window, bshd):
    """One launch of a float32 flash entry point on q/k/v in the model
    layout (B, S, H, D) (`bshd`) or (B, H, S, D)."""
    import torch
    h_ax, s_ax = (2, 1) if bshd else (1, 2)
    B, D = q.shape[0], q.shape[3]
    out = torch.empty_like(q)
    qs, ks = q.stride(), k.stride()
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
            q.shape[h_ax], k.shape[h_ax], q.shape[s_ax], k.shape[s_ax], D,
            qs[0], qs[h_ax], qs[s_ax], ks[0], ks[h_ax], ks[s_ax],
            int(causal), int(window), 1.0 / D ** 0.5,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention: CUDA error {rc}")
    return out


def flash_rows(libs: dict) -> list:
    import numpy as np
    import torch
    import chip_smoke as smoke
    from repro_torch.kernels import ref

    torch.backends.cuda.matmul.allow_tf32 = False
    fns = {name: entry(lib, "flash_attention")
           for (kind, name), lib in libs.items() if kind == "model"}
    gen = torch.Generator(device="cuda").manual_seed(19)
    rng = np.random.default_rng(19)
    # small cases at every head_dim: block and tile edges, windows and
    # rows that see no key
    small = []
    for D in (64, 128, 192, 256):
        for Sq, Sk, causal, window in ((129, 257, True, 0),
                                       (257, 127, False, 33),
                                       (300, 1000, True, 0)):
            q = torch.tensor(rng.standard_normal((1, 2, Sq, D)),
                             dtype=torch.float32, device="cuda")
            k, v = (torch.tensor(rng.standard_normal((1, 2, Sk, D)),
                                 dtype=torch.float32, device="cuda")
                    for _ in range(2))
            small.append((q, k, v, causal, window, ref.flash_attention_ref(
                q, k, v, causal=causal, window=window)))
    rows = []
    for name_, cfg in (("llama3-8b prefill", smoke.LLAMA),
                       ("gemma3-12b local", smoke.GEMMA)):
        S, D, window = smoke.PREFILL_S, cfg["D"], cfg["window"]
        q = torch.randn((1, S, cfg["Hq"], D), generator=gen, device="cuda")
        k, v = (torch.randn((1, S, cfg["Hkv"], D), generator=gen,
                            device="cuda") for _ in range(2))
        want = ref.flash_attention_bshd_ref(q, k, v, causal=True,
                                            window=window)
        ops = 4 * D * cfg["Hq"] * smoke.attn_pairs(S, S, True, window)
        live = {n: fn for n, fn in fns.items()
                if not (n == "cuda_cores" and D > 128)}

        def run(n):
            return flash_call(live[n], q, k, v, causal=True, window=window,
                              bshd=True)

        times = time_designs({n: (lambda n=n: run(n)) for n in live}, 5)
        for n in live:
            err = float((run(n) - want).abs().max())
            small_err = max(
                float((flash_call(live[n], sq, sk, sv, causal=c, window=w,
                                  bshd=False) - sw).abs().max())
                for sq, sk, sv, c, w, sw in small
                if not (n == "cuda_cores" and sq.shape[3] > 128))
            rows.append(dict(
                kernel="flash_attention", design=n, case=f"{name_} float32",
                ms=min(times[n]), ms_runs=times[n],
                bound_ms=ops / PEAK_F32 * 1e3,
                tf32x3_bound_ms=3 * ops / PEAK_TF32 * 1e3,
                max_abs_err=err, small_max_abs_err=small_err,
                ok=err <= FLASH_TOL and small_err <= SMALL_TOL))
        del q, k, v, want
        torch.cuda.empty_cache()
    return rows


def jsq_rows(libs: dict) -> list:
    import torch
    import chip_smoke as smoke
    from repro_torch.kernels import ref

    fns = {name: entry(lib, "jsq_route")
           for (kind, name), lib in libs.items() if kind == "netsim"}

    def call(name, q, up, w, h):
        port = torch.empty(h.shape, dtype=torch.int32, device="cuda")
        rc = fns[name](q.data_ptr(), up.data_ptr(), w.data_ptr(),
                       h.data_ptr(), port.data_ptr(), h.numel(), q.numel(),
                       1.0, 16.0, 1.0 - 1e-6,
                       torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"jsq_route {name}: CUDA error {rc}")
        return port

    checks = [smoke.packet_inputs(p, n, p + n, ties=t)
              for p, n, t in ((7, 37, False), (8192, 4097, False),
                              (33, 4097, True), (8192, 37, True))]
    rows = []
    for ties in (False, True):
        ports, N = smoke.PACKET_SHAPES["jsq_route"][0]
        q, up, w, _, h = smoke.packet_inputs(ports, N, 19, ties=ties)
        times = time_designs({n: (lambda n=n: call(n, q, up, w, h))
                              for n in fns}, 20)
        ops = N * ports * smoke.FLOPS_PER_ELEM["jsq_route"]
        for n in fns:
            equal = all(torch.equal(call(n, cq, cu, cw, ch),
                                    ref.jsq_route_ref(cq, cu, cw, ch))
                        for cq, cu, cw, _, ch in
                        [(q, up, w, None, h), *checks])
            rows.append(dict(
                kernel="jsq_route", design=n,
                case=f"{ports}x{N}{' ties' if ties else ''}",
                ms=min(times[n]), ms_runs=times[n],
                bound_ms=ops / PEAK_F32 * 1e3, ok=equal))
    return rows


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="root of an earlier checkout whose kernels "
                             "are timed as the 'first' designs")
    parser.add_argument("--out", type=Path, default=None,
                        help="also write the results as JSON here")
    parser.add_argument("--only", choices=("flash", "jsq"), default=None,
                        help="time one kernel's designs only")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash/jsq designs: no CUDA device", file=sys.stderr)
        return 2
    card = smi()
    print(card, flush=True)
    sources = {}
    if args.only != "jsq":
        sources.update({("model", n): t
                        for n, t in model_sources(args.parent).items()})
    if args.only != "flash":
        sources.update({("netsim", n): t
                        for n, t in netsim_sources(args.parent).items()})
    libs = build_all(sources)
    rows = ((flash_rows(libs) if args.only != "jsq" else []) +
            (jsq_rows(libs) if args.only != "flash" else []))
    for row in rows:
        extra = "".join(f" {k}={row[k]:.3g}" for k in
                        ("tf32x3_bound_ms", "max_abs_err",
                         "small_max_abs_err") if k in row)
        print(f"{row['kernel']} {row['design']} {row['case']}: "
              f"ms={row['ms']:.6f} (runs "
              f"{', '.join(f'{t:.6f}' for t in row['ms_runs'])}) "
              f"bound_ms={row['bound_ms']:.6f} "
              f"share_of_bound={row['bound_ms'] / row['ms']:.3f}{extra} "
              f"ok={row['ok']}", flush=True)
    result = {"nvidia_smi": card, "designs": rows}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    bad = [f"{r['kernel']} {r['design']} {r['case']}" for r in rows
           if not r["ok"]]
    if bad:
        print(f"outside the tolerance or unequal: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
