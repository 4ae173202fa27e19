#!/usr/bin/env python3
"""Designs of the port's `segment_sum` CUDA kernel, timed side by side.

Run from the root of a checkout on a machine with one NVIDIA GPU and the
CUDA toolkit:

    python3 benchmarks/torch_segment_sum_designs.py [--parent DIR] [--out PATH]

Builds `src/repro_torch/kernels/csrc/netsim_kernels.cu` once per source
design, all `nvcc` started together, and times each design in CUDA
graphs of 20 calls, in design order and then back, on the port's own
sparse plans (`chip_smoke.segment_plans`) in float64 and float32:

  first     the kernel of an earlier checkout (`--parent DIR`, the root
            of a checkout): one thread a bucket; left out without it;
  g{G}      the shipped source with G lanes of a warp a bucket for every
            entry of the launch (G = 1, 2, 4, 8, 16, 32);
  width     the shipped source, G the widest bucket rounded up to a
            power of two (at most 32);
  mean      G the plan's mean entries a bucket, rounded up alike;
  mean/4, width/8
            G a quarter of the mean, an eighth of the widest, alike;
  mean2     G = 2 where the mean is 2 entries or more, else 1;
  rule      G as the wrapper picks it (`link_load.segment_lanes_log2`);
  shfl      rule's G, each pass's values walked by shuffles from the
            lanes' registers instead of a shared-memory stage;
  t128      rule's G in blocks of 128 threads instead of 256;
  u16 ..    up to 16 loads a lane a pass (kSegLoads) instead of 8, at
            G = 1, 2, 8 and mean2's;
  lb8 ..    blocks held to 8 an SM (`__launch_bounds__(256, 8)`: at
            most 32 registers a thread), at G = 1, 2, 8 and mean2's.

The plans: the giga point's access plan (8,192 buckets of 25), its dst
plan, the ECMP link plan (16,384 buckets, up to 47), the AR pair plan
(131,072 buckets, mean 1.6), a slot's group of three (access, dst,
links) with and without the bottleneck epilogue, LANES seeds' link
plans as one batch's, the access plan folded over chunks of SEG_CHUNK
flows, and `giga_train_phi35_moe`'s skewed pair plan (1,088 of 131,072
buckets hold 33-80 entries) and access plan.  Every design must equal
the plain version bit for bit (`ref.segment_sum_ref`, and
`ref.bottleneck_ref` of its sums for the scales) on every plan and on a
random plan mixing empty and 80-entry buckets.  Prints the card's name
and power limit, one line per design, plan and dtype, and a JSON object
last.
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
BUILD_PY = "src/repro_torch/kernels/build.py"
OUT_DIR = ROOT / "build/repro_torch/segment_sum_designs"
THREADS = "constexpr int kSegThreads = "
LOADS = "constexpr int kSegLoads = "
BOUNDS = "__launch_bounds__(kSegThreads)\nsegment_sum_kernel("
STAGE = "      else stage[u * 32 + lane] = x[u];"
KEEP = "      else y[u] = x[u];"
SPAN = "const int span = G == 1 ? len : "
WALK = "    if constexpr (G > 1) __syncwarp();\n    // the pass's walk"
WALK_END = "    // end of the pass's walk"
SHUFFLE_WALK = r"""    // the pass's walk by shuffles: the group's lane 0 takes each of
    // its lanes' values in column order
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const T y_c = __shfl_sync(0xffffffffu, y[c / G], c % G, G);
      if (walker && c0 + c < len) acc = acc + y_c;
    }
"""
GS = (1, 2, 4, 8, 16, 32)


def _splice(src: str, start: str, end: str, new: str) -> str:
    """`src` with `new` from `start` up to the first `end` after it."""
    i = src.index(start)
    return src[:i] + new + src[src.index(end, i):]


def _set(src: str, prefix: str, value) -> str:
    """`src` with the constant that `prefix` starts set to `value`."""
    i = src.index(prefix) + len(prefix)
    return src[:i] + str(value) + src[src.index(";", i):]


def sources(parent) -> dict:
    src = (ROOT / NETSIM).read_text()
    if STAGE not in src or SPAN not in src:
        raise RuntimeError("stage or span anchor not found")
    out = {"shipped": src}
    if parent is not None:
        out["first"] = (parent / NETSIM).read_text()
    # every lane joins every shuffle, so a lone lane's passes are the
    # warp's too
    out["shfl"] = _splice(src.replace(STAGE, KEEP, 1).replace(
        SPAN, "const int span = ", 1), WALK, WALK_END, SHUFFLE_WALK)
    out["t128"] = _set(src, THREADS, 128)
    out["u16"] = _set(src, LOADS, 16)
    if BOUNDS not in src:
        raise RuntimeError("launch bounds anchor not found")
    out["lb8"] = src.replace(BOUNDS, BOUNDS.replace(
        "(kSegThreads)", "(kSegThreads, 8)"), 1)
    return out


def build_all(srcs: dict) -> dict:
    """One nvcc per source, all started together; the loaded libraries
    by name."""
    from repro_torch.kernels import build
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in srcs.items():
        cu = OUT_DIR / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
             str(OUT_DIR / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    failed = []
    for name, proc in procs.items():
        log = proc.communicate()[0]
        (OUT_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log[-4000:]}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: ctypes.CDLL(str(OUT_DIR / f"lib{name}.so"))
            for name in procs}


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


def lg(n: int) -> int:
    """log2 of the power of two at least `n` (at most 32)."""
    k = 0
    while k < 5 and (1 << k) < n:
        k += 1
    return k


def designs(libs: dict, parent_build) -> dict:
    """name -> call(items, acc, caps) running one launch of that design
    and returning (sums, scales)."""
    import torch
    from repro_torch.kernels import build, link_load

    def entry(lib, sfx, types):
        fn = getattr(lib, f"netsim_segment_sum_{sfx}")
        fn.argtypes = types
        fn.restype = ctypes.c_int
        return fn

    def ptrs(ts):
        return (ctypes.c_void_p * len(ts))(
            *(None if t is None else t.data_ptr() for t in ts))

    def new_call(lib, pick):
        types = build._ENTRIES["segment_sum"][2]
        fns = {sfx: entry(lib, sfx, types) for sfx in ("f32", "f64")}

        def call(items, acc=None, caps=None):
            n = len(items)
            dt = items[0][0].dtype
            sizes = [p.offsets.numel() - 1 for _, p in items]
            outs = list(acc) if acc is not None else [
                torch.empty(K, dtype=dt, device="cuda") for K in sizes]
            caps = list(caps) if caps is not None else [None] * n
            scales = [None if c is None else torch.empty_like(c)
                      for c in caps]
            lanes = (ctypes.c_int * n)(*(pick(K, p) for K, (_, p) in
                                         zip(sizes, items)))
            rc = fns["f64" if dt == torch.float64 else "f32"](
                ptrs([v for v, _ in items]),
                ptrs([p.offsets for _, p in items]),
                ptrs([p.entries for _, p in items]), ptrs(outs),
                ptrs(caps), ptrs(scales), (ctypes.c_int64 * n)(*sizes),
                lanes, n, int(acc is not None), link_load.EPS,
                torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"CUDA error {rc}")
            return outs, scales
        return call

    def first_call(lib):
        types = parent_build._ENTRIES["segment_sum"][2]
        fns = {sfx: entry(lib, sfx, types) for sfx in ("f32", "f64")}

        def call(items, acc=None, caps=None):
            if caps is not None:
                return None                 # no epilogue in that kernel
            n = len(items)
            dt = items[0][0].dtype
            sizes = [p.offsets.numel() - 1 for _, p in items]
            outs = list(acc) if acc is not None else [
                torch.empty(K, dtype=dt, device="cuda") for K in sizes]
            rc = fns["f64" if dt == torch.float64 else "f32"](
                ptrs([v for v, _ in items]),
                ptrs([p.offsets for _, p in items]),
                ptrs([p.entries for _, p in items]), ptrs(outs),
                (ctypes.c_int64 * n)(*sizes), n, int(acc is not None),
                torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"CUDA error {rc}")
            return outs, [None] * n
        return call

    def rule(K, p):
        return link_load.segment_lanes_log2(K, p.entries.numel(), p.width)

    def mean2(K, p):
        return int(p.entries.numel() >= 2 * K)

    out = {}
    if "first" in libs:
        out["first"] = first_call(libs["first"])
    for g in GS:
        out[f"g{g}"] = new_call(libs["shipped"], lambda K, p, g=g: lg(g))
    out["width"] = new_call(libs["shipped"], lambda K, p: lg(p.width))
    out["mean"] = new_call(libs["shipped"], lambda K, p: lg(
        -(-p.entries.numel() // max(K, 1))))
    out["mean/4"] = new_call(libs["shipped"], lambda K, p: lg(
        -(-p.entries.numel() // max(4 * K, 1))))
    out["width/8"] = new_call(libs["shipped"], lambda K, p: lg(
        -(-p.width // 8)))
    out["rule"] = new_call(libs["shipped"], rule)
    out["mean2"] = new_call(libs["shipped"], mean2)
    out["shfl"] = new_call(libs["shfl"], rule)
    out["t128"] = new_call(libs["t128"], rule)
    for src in ("u16", "lb8"):
        for g in (1, 2, 8):
            out[f"{src} g{g}"] = new_call(libs[src],
                                          lambda K, p, g=g: lg(g))
        out[f"{src} mean2"] = new_call(libs[src], mean2)
    return out


def workloads(dtype, seed: int) -> dict:
    """name -> (items, caps, chunks): one launch's entries, the caps of
    its epilogue (None: none), and for the fold the (plan, values) of
    each chunk's launch instead."""
    import numpy as np
    import torch
    import chip_smoke as smoke
    from repro_torch.netsim import engine

    plans = workloads.plans
    rng = np.random.default_rng(seed)
    F, P = plans["F"], plans["P"]

    def rates(*shape):
        a = rng.uniform(0.0, 1.0, shape)
        a[rng.random(shape) < 0.1] = 0.0
        return torch.tensor(a, dtype=dtype, device="cuda")

    offered, fabric, batch = rates(F, P), rates(F, P), rates(smoke.LANES,
                                                             F, P)
    moe = plans["moe"]
    moe_rate = rates(moe["F"], moe["P"])
    slot = [(offered, plans["access"]), (offered, plans["dst"]),
            (fabric, plans["link"])]
    acc_cap = rates(plans["access"].offsets.numel() - 1) * 4.0
    link_cap = rates(plans["link"].offsets.numel() - 1) * 8.0
    nc, fold = plans["chunks"], plans["fold"]
    ch = smoke.SEG_CHUNK
    chunks = [(offered[c * ch:(c + 1) * ch].contiguous(),
               engine._chunk_plan(fold, c, nc)) for c in range(nc)]
    # a random plan mixing empty and 80-entry buckets (a check only)
    keys = rng.integers(0, 400, (3000, 2))
    keys[rng.random((3000, 2)) < 0.3] = 7
    mixed = engine._csr([(np.arange(3000), keys)], 512, 3000, 1)
    mixed = mixed._replace(
        offsets=torch.as_tensor(mixed.offsets, device="cuda"),
        entries=torch.as_tensor(mixed.entries, device="cuda"))
    return {
        "access": ([(offered, plans["access"])], None, None),
        "dst": ([(offered, plans["dst"])], None, None),
        "ecmp links": ([(fabric, plans["link"])], None, None),
        "pair": ([(fabric, plans["pair"])], None, None),
        "slot x3": (slot, None, None),
        "slot x3 scaled": (slot, [acc_cap, acc_cap, link_cap], None),
        f"{smoke.LANES} lanes": ([(batch, plans["lanes"])], None, None),
        f"fold of {nc} chunks": (None, None, chunks),
        "train_phi35_moe pair": ([(moe_rate, moe["pair"])], None, None),
        "train_phi35_moe access": ([(moe_rate, moe["access"])], None,
                                   None),
        "mixed 0/80 (check)": ([(rates(3000, 2), mixed)], None, None),
    }


def plain(items, caps, chunks):
    """The plain versions' sums (and scales) of one workload."""
    from repro_torch.kernels import ref
    if chunks is not None:
        acc = None
        for v, p in chunks:
            acc = ref.segment_sum_ref(v, p.offsets, p.entries, acc=acc)
        return [acc]
    sums = [ref.segment_sum_ref(v, p.offsets, p.entries) for v, p in items]
    if caps is None:
        return sums
    return sums + [ref.bottleneck_ref(c, s) for c, s in zip(caps, sums)]


def run(call, items, caps, chunks):
    """One workload through one design: its sums (and scales), or None
    where the design cannot run it."""
    if chunks is not None:
        acc = None
        for v, p in chunks:
            r = call([(v, p)], acc=acc)
            acc = r[0]
        return acc
    r = call(items, caps=caps)
    if r is None:
        return None
    sums, scales = r
    return list(sums) + ([] if caps is None else list(scales))


def nbytes(items, caps, chunks) -> int:
    """Each plan's offsets and entries, each value and cap read once,
    each sum and scale written once."""
    if chunks is not None:
        v0 = chunks[0][0]
        isz = v0.element_size()
        K = chunks[0][1].offsets.numel() - 1
        return (sum(v.numel() for v, _ in chunks) * isz
                + 4 * (len(chunks) * (K + 1) + chunks[0][1].entries.numel())
                + (2 * len(chunks) - 1) * K * isz)
    isz = items[0][0].element_size()
    n, seen = 0, set()
    for v, p in items:
        K = p.offsets.numel() - 1
        n += 4 * (K + 1 + p.entries.numel()) + K * isz
        if id(v) not in seen:
            seen.add(id(v))
            n += v.numel() * isz
    for c in {id(c): c for c in caps or ()}.values():
        n += 2 * c.numel() * isz
    return n


def rows_for(calls: dict, dtype, seed: int) -> list:
    import torch
    import chip_smoke as smoke
    sfx = "f64" if dtype == torch.float64 else "f32"
    rows = []
    for wname, (items, caps, chunks) in workloads(dtype, seed).items():
        want = plain(items, caps, chunks)
        runs = {}
        for name, call in calls.items():
            got = run(call, items, caps, chunks)
            if got is None:
                continue
            torch.cuda.synchronize()
            equal = all(torch.equal(g, w) for g, w in zip(got, want))
            runs[name] = (equal, lambda c=call: run(c, items, caps, chunks))
        bound = nbytes(items, caps, chunks) / smoke.HBM_BYTES_PER_S * 1e3
        timed = "check" not in wname
        times = {n: [] for n in runs}
        if timed:
            names = list(runs)
            for name in names + names[::-1]:
                times[name].append(smoke.graph_ms(runs[name][1]))
        for name, (equal, _) in runs.items():
            rows.append(dict(
                kernel="segment_sum", design=name, plan=wname, dtype=sfx,
                ms=min(times[name]) if timed else None,
                ms_runs=times[name], bound_ms=bound,
                bit_equal_to_plain=bool(equal)))
    return rows


def main(argv=None) -> int:
    import torch
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="root of an earlier checkout whose kernel is "
                             "timed as the 'first' design")
    parser.add_argument("--out", type=Path, default=None,
                        help="also write the results as JSON here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("segment_sum designs: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    card = smi()
    print(card, flush=True)
    libs = build_all(sources(args.parent))
    parent_build = (build_module(args.parent) if args.parent is not None
                    else None)
    calls = designs(libs, parent_build)
    workloads.plans = smoke.segment_plans()
    rows = []
    for k, dtype in enumerate((torch.float64, torch.float32)):
        rows += rows_for(calls, dtype, seed=26 + k)
    for row in rows:
        ms = ("not timed" if row["ms"] is None else
              f"ms={row['ms']:.6f} (runs "
              f"{', '.join(f'{t:.6f}' for t in row['ms_runs'])}) "
              f"bound_ms={row['bound_ms']:.6f} "
              f"share_of_bound={row['bound_ms'] / row['ms']:.3f}")
        print(f"segment_sum {row['design']} [{row['plan']}] {row['dtype']}: "
              f"{ms} bit_equal_to_plain={row['bit_equal_to_plain']}",
              flush=True)
    result = {"nvidia_smi": card, "designs": rows}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    bad = [f"{r['design']} {r['plan']} {r['dtype']}" for r in rows
           if not r["bit_equal_to_plain"]]
    if bad:
        print(f"differ from the plain version: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
