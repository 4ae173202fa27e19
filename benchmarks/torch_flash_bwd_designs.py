#!/usr/bin/env python3
"""Designs of the port's bf16 `flash_attention_bwd` kernels at head_dim
64, timed side by side at spx-100m's train shape.

Run from the root of a checkout on a machine with one NVIDIA GPU and the
CUDA toolkit:

    PYTHONPATH=src python3 benchmarks/torch_flash_bwd_designs.py

Builds `src/repro_torch/kernels/csrc/model_kernels.cu` once per design
(all `nvcc` started together), each with the tile constants of
`BwdTiles` spliced for bf16 at head_dim 64 (anchors: the `kQStep` line
and the kernels' `__launch_bounds__` lines):

  shipped      the source as it is;
  q{Q}         Q queries a dK/dV step (the shipped 64 at head_dim 64);
  lb{N}        dK/dV compiled for N blocks an SM (`__launch_bounds__`'s
               second argument, so at most 65,536 / (128 N) registers a
               thread; N = 1 lets ptxas take 255); dqlb{N} the same for
               dQ, lb1 both (the shipped source gives no block count);
  kt_outer     `tile_acc` in bf16 walking its k steps outside its column
               tiles (every B fragment feeds 2 of all the column tiles'
               chains) instead of inside them (splice anchor: the
               function's static_assert).

Each design's backward at spx-100m's cell (B 8, S 1,024, 12/4 heads,
causal, bf16; the designs that change every head_dim also at llama3-8b's
prefill cell: B 1, S 4,096, 32/8 heads, head_dim 128) must be within
BWD_TOL of `ref.flash_attention_bwd_ref` and repeat
bit for bit.  Prints the card's name and power limit, ptxas's registers
and spills of each design's two kernels, and per design: the time of a
call in a CUDA graph (kernels only), between CUDA events as
`chip_smoke.py` times it, and its three kernels apart; SDPA's backward
between events in the same run.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
MODEL = "src/repro_torch/kernels/csrc/model_kernels.cu"
OUT_DIR = ROOT / "build" / "flash_bwd_designs"
QSTEP = "  static constexpr int kQStep = "
# (cell, shape, the designs timed there: None for all)
CELLS = (("spx-100m", dict(B=8, S=1024, Hq=12, Hkv=4, D=64), None),
         ("llama3-8b", dict(B=1, S=4096, Hq=32, Hkv=8, D=128),
          ("shipped", "lb1", "kt_outer")))
LB = "__global__ void __launch_bounds__(kBwdThreads)\nflash_bwd_{}_kernel("


def _bounds(kernel: str, n: int) -> tuple:
    """The splice giving `kernel` (dkdv or dq) N blocks an SM at bf16
    head_dim 64 (1 elsewhere)."""
    return (LB.format(kernel), LB.format(kernel).replace(
        "(kBwdThreads)", f"(kBwdThreads, sizeof(T) == 2 && D == 64 ? {n} : 1)"))


ACC_ANCHOR = '  static_assert(NN % 2 == 0, "pairs of n8 tiles");\n'
KT_OUTER = ACC_ANCHOR + """  if constexpr (!M::kChains) {
#pragma unroll
    for (int i = 0; i < KT; ++i)
#pragma unroll
      for (int n = 0; n < NN; n += 2) {
        typename M::B b[2];
        M::template load_bt<D>(b, ys, M::kK * i, n0 + 8 * n);
        M::mma(acc[n], xa[i], b[0]);
        M::mma(acc[n + 1], xa[i], b[1]);
      }
    return;
  }
"""
# code splices: name -> [(old, new)]
SPLICES = {
    "lb1": [_bounds("dkdv", 1), _bounds("dq", 1)],
    "kt_outer": [(ACC_ANCHOR, KT_OUTER)],
    "lb3": [_bounds("dkdv", 3)],
    "q32_lb3": [_bounds("dkdv", 3)],
    "dqlb4": [_bounds("dq", 4)],
}
# name -> {anchor: value for bf16 at head_dim 64}
DESIGNS = {
    "shipped": {},
    "lb1": {},
    "kt_outer": {},
    "q32": {QSTEP: 32},
    "lb3": {},
    "q32_lb3": {QSTEP: 32},
    "dqlb4": {},
}


def _set_d64(src: str, anchor: str, value: int) -> str:
    """`src` with the constant at `anchor` taking `value` for bf16 at
    head_dim 64 and its shipped expression elsewhere."""
    i = src.index(anchor) + len(anchor)
    j = src.index(";", i)
    return (src[:i] + f"kBf16 && D == 64 ? {value} : ({src[i:j]})"
            + src[j:])


def sources() -> dict:
    src = (ROOT / MODEL).read_text()
    out = {}
    for name, consts in DESIGNS.items():
        text = src
        for anchor, value in consts.items():
            text = _set_d64(text, anchor, value)
        for old, new in SPLICES.get(name, []):
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: anchor {old[:40]!r} not unique")
            text = text.replace(old, new)
        out[name] = text
    return out


def build_all(srcs: dict) -> dict:
    """One nvcc per design, all started together: the loaded libraries
    and ptxas's lines for the bf16 head_dim-64 backward kernels."""
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
    libs, res, failed = {}, {}, []
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log[-4000:]}")
            continue
        lines = log.splitlines()
        res[name] = {}
        for i, line in enumerate(lines):
            m = re.search(r"flash_bwd_(dkdv|dq)_kernelI13__nv_bfloat16Li64E",
                          line)
            if m and "Compiling entry" in line:
                info = " ".join(x.strip() for x in lines[i + 1:i + 4])
                regs = re.search(r"Used (\d+) registers", info)
                spill = re.search(r"(\d+) bytes spill stores", info)
                res[name][m.group(1)] = (int(regs.group(1)),
                                         int(spill.group(1)))
        libs[name] = ctypes.CDLL(str(OUT_DIR / f"lib{name}.so"))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return libs, res


def time_cell(cell: str, shape: dict, names: list, libs: dict,
              res: dict) -> None:
    """Each design in `names` at one cell: checked, then timed in turns
    beside SDPA's backward."""
    import torch
    import torch.nn.functional as F
    import chip_smoke as cs
    from repro_torch.kernels import build, ops, ref
    B, S, Hq, Hkv, D = (shape[k] for k in ("B", "S", "Hq", "Hkv", "D"))
    gen = torch.Generator(device="cuda").manual_seed(29)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    q, dout = randn(B, S, Hq, D), randn(B, S, Hq, D)
    k, v = randn(B, S, Hkv, D), randn(B, S, Hkv, D)
    out, lse = ops.flash_attention_fwd(q, k, v)
    want = ref.flash_attention_bwd_ref(q, k, v, out, dout, lse)
    qs, ks = q.stride(), k.stride()

    def call(fn):
        delta = torch.empty((B, Hq, S), dtype=torch.float32, device="cuda")
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Hq, Hkv, S,
                S, D, qs[0], qs[2], qs[1], ks[0], ks[2], ks[1], 1, 0,
                1.0 / D ** 0.5, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"flash_attention_bwd: CUDA error {rc}")
        return dq, dk, dv

    runs = {}
    for name in names:
        fn = getattr(libs[name], build.symbol("flash_attention_bwd",
                                              torch.bfloat16))
        fn.argtypes = build._ENTRIES["flash_attention_bwd"][2]
        fn.restype = ctypes.c_int
        got = call(fn)
        err = cs.bwd_errors(got, want)
        same = all(torch.equal(a, b) for a, b in zip(got, call(fn)))
        if not (err <= cs.BWD_TOL["bfloat16"] and same):
            raise RuntimeError(f"{cell} {name}: err {err}, repeat {same}")
        runs[name] = lambda fn=fn: call(fn)
    del want
    qx, kx, vx = (t.detach().transpose(1, 2).requires_grad_(True)
                  for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qx, kx, vx, is_causal=True,
                                              enable_gqa=True)

    def sdpa():
        return torch.autograd.grad(sdpa_out, (qx, kx, vx),
                                   dout.transpose(1, 2), retain_graph=True)

    times = {n: dict(graph=[], events=[]) for n in names}
    sdpa_ms = []
    for name in names + names[::-1]:
        times[name]["graph"].append(cs.graph_ms(runs[name], reps=5))
        times[name]["events"].append(cs.event_ms(runs[name], repeats=5))
        sdpa_ms.append(cs.event_ms(sdpa, repeats=5))
    for name in names:
        split = cs.kernel_split_ms(runs[name], cs.BWD_KERNELS)
        print(f"{cell} {name}: registers (spills) at head_dim 64 dK/dV "
              f"{res[name].get('dkdv')} dQ {res[name].get('dq')}; graph ms "
              f"{' '.join(f'{t:.6f}' for t in times[name]['graph'])}; "
              f"events ms "
              f"{' '.join(f'{t:.6f}' for t in times[name]['events'])}; "
              + " ".join(f"{n}={'not measured' if t is None else f'{t:.6f}'}"
                         for n, t in split.items()), flush=True)
    print(f"{cell} SDPA backward, events ms: "
          f"{' '.join(f'{t:.6f}' for t in sdpa_ms)}", flush=True)


def main() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    print(cs.card(), flush=True)
    build.library()
    libs, res = build_all(sources())
    torch.backends.cuda.matmul.allow_tf32 = False
    for cell, shape, names in CELLS:
        time_cell(cell, shape, [n for n in libs if names is None
                                or n in names], libs, res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
