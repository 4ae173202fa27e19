#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (`src/repro_torch`).

Run from the root of a checkout on a machine with one NVIDIA GPU and the
CUDA toolkit:

    python3 chip_smoke.py

Phases, each fatal on failure:

  build     compile the port's kernels from
            `src/repro_torch/kernels/csrc/{netsim,model}_kernels.cu`
            (one nvcc per source, started together, then one link), and
            count the tensor-core instructions that `cuobjdump -sass`
            lists in the flash_attention kernels: HGMMA (wgmma) in the
            bf16 ones, HMMA (mma.sync, 3xTF32) in the float32 ones
            (fatal if one has none; "not measured" without cuobjdump).
  kernels   each of the eight kernels against its plain PyTorch version
            on the same GPU tensors: the five AR/WAR slot kernels at the
            fig9 and giga AR shapes (bottleneck on one pair of links and
            as a slot's grouped launch of four and of two pairs;
            queue_update on one link array and as a slot's grouped
            launch of its up and down links; plane_split also on 4
            planes, fig12's flow and giga's flow count),
            bucket_load_bottleneck on the engine's own ECMP plans of
            fig11 and the giga point, all in float32 and float64, and
            the per-packet jsq_route and plb_select at the
            `kernels_bench.py` shapes plus a block tail (jsq_route
            also with every port scoring the same); CUDA-event
            times of kernel and plain version (each captured in a CUDA
            graph of 20 calls, so host launch overhead is excluded)
            beside the least time the card needs for the bytes moved or
            the operations done; and the launch floor, `bottleneck` on
            one element in the same harness.
  sync      the AR and the ECMP slot loops, eager and the replays of
            the captured one, run with CUDA sync debugging set to
            "error": nothing in them makes the host wait (the capture,
            which synchronises on entry, runs before).
  registry  fig9_victim_noise, fig11_degraded_leaf and fig12_plane_flap
            under their own routing (AR/WAR), and fig12_plane_flap and
            cascading_spine_loss under ECMP, through
            `compile_scenario(...).run(device="cuda")` in float64 (the
            captured slot loop), held against the CPU plain path (1e-5,
            exact completion slots, equal distilled rows) and, for the
            registry's own specs, against `tests/golden/scenarios.json`
            (1e-5); every kernel must have launched `PER_SLOT[routing]`
            times per slot, replays included.
  scale     giga_fabric_storage (4096 hosts, 102,400 flows, 8 random
            link kills, 60 slots) under AR and under its own ECMP, in
            float32 and float64 on the GPU through the entry point
            (captured); each run bit-equal to an eager loop of its
            dtype, and the loop timed apart from the host prep over 3
            eager and 3 captured runs in turns (capture and replays
            apart); each float64 run is held against the CPU plain path
            with the contained-fork contract used for giga-scale
            parity, and the ECMP one against the golden row (1e-5).
  packets   the per-packet path: `repro_torch.kernels.ops.jsq_route` and
            `ops.plb_select` route batches of 4096 packets, and
            jsq_route one more batch over ports that all score the
            same (the hashed tie-break decides), each batch equal to
            the plain versions.
  model_kernels
            the attention and int8-codec entry points of
            `repro_torch.kernels.ops` at full model widths (MODEL_CASES):
            llama3-8b prefill (4096 tokens, causal, bf16 and f32) and
            decode (8 x 8192-slot cache), a gemma3-12b local layer
            (window 1024, bf16 and f32), and the int8 codec on a
            llama3-8b MLP gradient leaf (encode also in bf16 and at an
            odd row length that takes element loads); each kernel held
            to its plain version on the card (attention within
            ATTN_TOL, the codec bit for bit) and timed beside the plain
            version and one PyTorch call
            (`scaled_dot_product_attention`, `q * scale`); attention
            lines also give TFLOP/s of unmasked work and the ratio of
            the kernel's time to SDPA's.
  profile   torch.profiler over 12 giga slots under AR and under ECMP,
            float64 and float32, eager and captured (the replays): the
            device busy share and the kernels that take the device time.

Prints the card's name and power limit first, a `{"kernels": [...]}`
line before the last, and `{"ok": true, "device": {...}}` last.
`--report PATH` also writes the full report (every kernel row, the
registry, scale, packet and profile results) as JSON.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

TOL = 1e-5
# float32 bucket sums: the kernel sums in flow order, the plain version
# in PyTorch's reduction order; 47 non-negative terms differ by at most
# ~47 ulp of the sum
F32_SUM_RTOL = 1e-5
HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
# non-tensor-core peaks for float32/float64; bfloat16 on the tensor cores
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12, "bfloat16": 989e12}
REGISTRY = (("fig9_victim_noise", None), ("fig11_degraded_leaf", None),
            ("fig12_plane_flap", None), ("fig12_plane_flap", "ecmp"),
            ("cascading_spine_loss", "ecmp"))
# hand-written kernel launches per slot on each leaf-spine routing path
# (bottleneck: one grouped launch scales every link of a slot;
# queue_update: one grouped launch integrates its up and down links)
AR_SLOT = {"plane_split": 1, "pair_fractions": 1, "bottleneck": 1,
           "queue_update": 1, "nic_update": 1}
ECMP_SLOT = {"plane_split": 1, "bucket_load_bottleneck": 1,
             "bottleneck": 1, "queue_update": 1, "nic_update": 1}
PER_SLOT = {"ar": AR_SLOT, "war": AR_SLOT, "ecmp": ECMP_SLOT}
REPLACES = {
    "plane_split": "src/repro/kernels/plb_select.py:47",
    "pair_fractions": "src/repro/kernels/jsq_route.py:42",
    "bottleneck": "src/repro/kernels/link_load.py:101",
    "bucket_load_bottleneck": "src/repro/kernels/link_load.py:38",
    "queue_update": "src/repro/kernels/queue_ecn.py:31",
    "nic_update": "src/repro/kernels/queue_ecn.py:73",
    "jsq_route": "src/repro/kernels/jsq_route.py:22",
    "plb_select": "src/repro/kernels/plb_select.py:24",
    "flash_attention": "src/repro/kernels/flash_attention.py:26",
    "decode_attention": "src/repro/kernels/decode_attention.py:20",
    "int8_encode": "src/repro/kernels/int8_codec.py:17",
    "int8_decode": "src/repro/kernels/int8_codec.py:26",
}
# fabric shapes the main path hands the kernels
SHAPES = {"fig9": dict(F=2496, P=1, L=8, S=8, H=64),
          "giga": dict(F=102400, P=2, L=256, S=16, H=4096)}
# further (flows, planes) of plane_split, so that every instance of the
# planes the registry uses (P = 1, 2, 4) runs on the card: fig12's
# single flow on 4 planes, and 4 planes at giga's flow count
PLANE_SHAPES = {"fig12": dict(F=1, P=4), "giga x4": dict(F=102400, P=4)}
# scenarios whose ECMP plans the bucket_load_bottleneck cases use
ECMP_SHAPES = {"fig11": "fig11_degraded_leaf", "giga": "giga_fabric_storage"}
# per-packet shapes: (lanes, packets) for jsq_route (ports) and
# plb_select (planes), as `benchmarks/kernels_bench.py` runs them, plus
# a block tail
PACKET_SHAPES = {"jsq_route": ((256, 4096), (256, 4097)),
                 "plb_select": ((4, 4096), (4, 4097))}
PACKET_BATCHES = 16
# approximate operations per element (per (packet, lane) for the
# per-packet kernels: hash multiply-add, xor-shift, mask, convert,
# scale, score add, compare), for the operations bound
FLOPS_PER_ELEM = {"plane_split": 8, "pair_fractions": 30, "bottleneck": 2,
                  "bucket_load_bottleneck": 1, "queue_update": 7,
                  "nic_update": 20, "jsq_route": 11, "plb_select": 14}
NIC_KW = dict(base_rtt_us=4.0, slot_us=10.0, ecn_thresh=3.0,
              target_rtt_us=12.0, min_rate=0.01, md=0.7, ai=0.08,
              rtt_gain=0.15, dcqcn_ai=0.01, alpha_g=0.0625)
# full widths of the model_kernels phase: configs/llama3_8b.py (32 query
# heads, 8 kv heads, head_dim 128, d_model 4096, d_ff 14336) and
# configs/gemma3_12b.py (16 query heads, 8 kv heads, head_dim 256, local
# layers with a 1024-token window); bfloat16 is the models' compute
# dtype (models/config.py)
LLAMA = dict(Hq=32, Hkv=8, D=128, window=0)
GEMMA = dict(Hq=16, Hkv=8, D=256, window=1024)
PREFILL_S = 4096
DECODE_B, DECODE_S = 8, 8192
CODEC_SHAPE = (4096, 14336)          # a llama3-8b MLP weight's gradient
CODEC_ODD_C = 4095                    # rows no 16-byte load divides
# attention kernels vs their plain versions on the card, max abs error:
# the sums run over 4096-8192 keys in another order than the einsums
ATTN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# launches of one model_kernels main-path run
MODEL_LAUNCHES = {"flash_attention": 4, "decode_attention": 1,
                  "int8_encode": 3, "int8_decode": 1}
# operations per element of the codec (|x|, max, divide, add, round,
# clamp; decode: convert, multiply), for the operations bound
CODEC_FLOPS = {"int8_encode": 6, "int8_decode": 2}


def scenario(name: str, routing=None):
    """The port's registry spec, with `routing` overridden if given."""
    from repro_torch.scenarios import get_scenario
    spec = get_scenario(name)
    return spec if routing is None else spec.with_sim(routing=routing)


def label(name: str, routing=None) -> str:
    return name if routing is None else f"{name}[{routing}]"


def fail(msg: str) -> None:
    raise AssertionError(msg)


def graph_ms(fn, reps: int = 20, repeats: int = 5) -> float:
    """Median device time of one `fn()` call: `reps` calls captured in a
    CUDA graph, replayed `repeats` times between CUDA events."""
    import torch
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()                                     # warm-up outside capture
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    times.sort()
    return times[len(times) // 2]


def case(kernel, mode, shape, dtype, run, plain, nbytes, ops, *,
         rtol=None, loose=None, summary=False, extra=None) -> dict:
    """One kernel-vs-plain comparison.  The kernel must equal `plain`
    bit for bit unless `rtol` is set (then: relative error); `loose` is
    a further (plain call, rtol) the result must meet; `summary` marks
    the case reported in the `{"kernels": [...]}` line; `extra` names
    further calls to time beside the kernel."""
    return dict(kernel=kernel, mode=mode, shape=shape,
                dtype=str(dtype).split(".")[1], run=run, plain=plain,
                bytes=nbytes, ops=ops, rtol=rtol, loose=loose,
                summary=summary, extra=extra or {})


# flash_attention kernels and the tensor-core instruction each must
# hold in its SASS: wgmma (HGMMA) in bf16, mma.sync (HMMA) in float32
SASS_MMA = {"bf16": ("flash_attention_wgmma_kernel", "HGMMA"),
            "float32": ("flash_attention_tf32_kernel", "HMMA")}


def sass_mma(sass: str) -> str:
    """The tensor-core instructions of each flash_attention kernel in
    `sass` (the built library as `cuobjdump -sass` lists it), by dtype
    and head_dim; fails if a kernel is missing or has none."""
    out = []
    for dname, (kernel, instr) in SASS_MMA.items():
        counts, head_dim = {}, None      # head_dim -> instruction lines
        for line in sass.splitlines():
            if "Function :" in line:
                m = re.search(kernel + r"ILi(\d+)E", line)
                head_dim = int(m.group(1)) if m else None
                if head_dim is not None:
                    counts[head_dim] = 0
            elif head_dim is not None and re.search(rf"\b{instr}\b", line):
                counts[head_dim] += 1
        if sorted(counts) != [64, 128, 192, 256] or not all(counts.values()):
            fail(f"{dname} flash kernels without {instr} in their SASS: "
                 f"{counts}")
        out.append(f"{instr} in the {dname} flash kernels, by head_dim: "
                   + ", ".join(f"{d}: {n}" for d, n in sorted(counts.items())))
    return "; ".join(out)


def sass_check() -> str:
    """`sass_mma` of the built library, or "not measured" without
    cuobjdump."""
    import shutil
    from repro_torch.kernels import build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return ("tensor-core instructions in the flash kernels: not "
                "measured (no cuobjdump)")
    return "cuobjdump -sass: " + sass_mma(subprocess.run(
        [tool, "-sass", str(build.library_path())], capture_output=True,
        text=True, check=True).stdout)


def kernel_cases(sname: str, shape: dict, dtype, seed: int):
    """The five AR/WAR slot kernels, every mode, at one fabric shape,
    inputs drawn from numpy with `seed`."""
    import numpy as np
    import torch
    from repro_torch.kernels import jsq_route, link_load, queue_ecn, ref

    rng = np.random.default_rng(seed)
    F, P, L, S, H = (shape[k] for k in "FPLSH")
    isz = torch.empty((), dtype=dtype).element_size()

    def f(*sh, lo=0.0, hi=1.0, zero_frac=0.0):
        a = rng.uniform(lo, hi, sh)
        if zero_frac:
            a[rng.random(sh) < zero_frac] = 0.0
        return torch.tensor(a, dtype=dtype, device="cuda")

    def b(*sh, p=0.9):
        return torch.tensor(rng.random(sh) < p, device="cuda")

    rate = f(F, P, lo=0.01, hi=1.0)
    rate[rate < 0.1] = 0.01                      # some planes at MIN_RATE
    elig, demand = b(F, P), f(F)
    q, cap = f(P, L, L, S, hi=20.0), f(P, L, L, S, zero_frac=0.1)
    w = cap * f(P, L, L, S)
    link_cap, link_load_ = f(P, L, S, zero_frac=0.1), f(P, L, S, hi=2.0)
    acc_cap, acc_load = f(H, P, zero_frac=0.05), f(H, P, hi=2.0)
    q_link = f(P, L, S, hi=70.0)
    qmean, alpha, esr = f(F, P, hi=8.0), f(F, P), b(F, 1, p=0.5)
    # a slot's grouped bottleneck launch: up and down links, then the
    # access links toward and from the hosts (ECMP: the last two only)
    down_cap, down_load = f(P, S, L, zero_frac=0.1), f(P, S, L, hi=2.0)
    rx_load = f(H, P, hi=2.0)
    groups = {"slot x4": ((link_cap, link_load_), (down_cap, down_load),
                          (acc_cap, acc_load), (acc_cap, rx_load)),
              "slot x2": ((acc_cap, acc_load), (acc_cap, rx_load))}
    n_pair, n_link = P * L * L * S, P * L * S
    big = sname == "giga" and dtype == torch.float64
    fl = FLOPS_PER_ELEM
    out = plane_split_cases(sname, rate, elig, demand, dtype,
                            summary=big)
    out.append(case(
        "pair_fractions", "", sname, dtype,
        lambda: jsq_route.pair_fractions(q, cap, w, nbins=16,
                                         temperature=0.25),
        lambda: ref.pair_score_softmax_ref(q, cap, w, nbins=16,
                                           temperature=0.25),
        4 * n_pair * isz, n_pair * fl["pair_fractions"],
        rtol=1e-12 if dtype == torch.float64 else 1e-6, summary=big))
    for name, c, ld in (("links", link_cap, link_load_),
                        ("access", acc_cap, acc_load)):
        out.append(case(
            "bottleneck", name, sname, dtype,
            lambda c=c, ld=ld: link_load.bottleneck(c, ld),
            lambda c=c, ld=ld: ref.bottleneck_ref(c, ld),
            3 * c.numel() * isz, c.numel() * fl["bottleneck"]))
    for name, group in groups.items():
        n = sum(c.numel() for c, _ in group)
        out.append(case(
            "bottleneck", name, sname, dtype,
            lambda g=group: link_load.bottleneck_many(g),
            lambda g=group: tuple(ref.bottleneck_ref(c, ld) for c, ld in g),
            3 * n * isz, n * fl["bottleneck"],
            summary=big and name == "slot x4"))
    out.append(case(
        "queue_update", "", sname, dtype,
        lambda: queue_ecn.queue_update(q_link, link_load_, link_cap,
                                       q_cap=64.0),
        lambda: ref.queue_update_ref(q_link, link_load_, link_cap,
                                     q_cap=64.0),
        5 * n_link * isz, n_link * fl["queue_update"]))
    for mode in ("spx", "dcqcn", "agg"):
        out.append(case(
            "nic_update", mode, sname, dtype,
            lambda m=mode: queue_ecn.nic_update(qmean, rate, alpha, esr,
                                                mode=m, **NIC_KW),
            lambda m=mode: ref.nic_update_ref(qmean, rate, alpha, esr,
                                              mode=m, **NIC_KW),
            7 * F * P * isz + F, F * P * fl["nic_update"],
            summary=big and mode == "spx"))
    return out


def plane_split_cases(sname: str, rate, elig, demand, dtype, *,
                      summary: bool = False) -> list:
    """plane_split in its four modes on (F, P) `rate`, `elig` and (F,)
    `demand`; `summary` marks the spx case."""
    from repro_torch.kernels import plb_select, ref
    F, P = rate.shape
    isz = rate.element_size()
    return [case(
        "plane_split", mode, sname, dtype,
        lambda m=mode: plb_select.plane_split(rate, elig, demand, mode=m,
                                              min_rate=0.01),
        lambda m=mode: ref.plane_split_ref(rate, elig, demand, mode=m,
                                           min_rate=0.01),
        F * P * (2 * isz + 1) + F * isz, F * P * FLOPS_PER_ELEM["plane_split"],
        summary=summary and mode == "spx")
        for mode in ("spx", "dcqcn", "agg", "swlb")]


def plane_inputs(F: int, P: int, dtype, seed: int):
    """(F, P) rates (some planes at MIN_RATE), eligibilities (about one
    in ten planes out) and (F,) demands on the card, drawn from numpy
    with `seed`."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    rate = rng.uniform(0.01, 1.0, (F, P))
    rate[rate < 0.1] = 0.01
    return (torch.tensor(rate, dtype=dtype, device="cuda"),
            torch.tensor(rng.random((F, P)) < 0.9, device="cuda"),
            torch.tensor(rng.uniform(0.0, 1.0, F), dtype=dtype,
                         device="cuda"))


def queue_slot_case(sname: str, shape: dict, dtype, seed: int) -> dict:
    """queue_update as a slot's grouped launch: its up (P, L, S) and down
    (P, S, L) links, drawn from numpy with `seed`; the summary case at
    giga in float64."""
    import numpy as np
    import torch
    from repro_torch.kernels import queue_ecn, ref

    rng = np.random.default_rng(seed)
    P, L, S = (shape[k] for k in "PLS")

    def f(*sh, hi=1.0, zero_frac=0.0):
        a = rng.uniform(0.0, hi, sh)
        if zero_frac:
            a[rng.random(sh) < zero_frac] = 0.0
        return torch.tensor(a, dtype=dtype, device="cuda")

    slot = tuple((f(*sh, hi=70.0), f(*sh, hi=2.0), f(*sh, zero_frac=0.1))
                 for sh in ((P, L, S), (P, S, L)))
    n = 2 * P * L * S
    isz = torch.empty((), dtype=dtype).element_size()
    return case(
        "queue_update", "slot x2", sname, dtype,
        lambda: sum(queue_ecn.queue_update_many(slot, q_cap=64.0), ()),
        lambda: sum((ref.queue_update_ref(*e, q_cap=64.0) for e in slot),
                    ()),
        5 * n * isz, n * FLOPS_PER_ELEM["queue_update"],
        summary=sname == "giga" and dtype == torch.float64)


def ecmp_plan(sname: str):
    """(ECMP link-bucket plan, stacked link capacities) of the last
    capacity segment of `ECMP_SHAPES[sname]` under ECMP, from the
    port's own host prep, on the card."""
    import torch
    from repro_torch.netsim import engine
    from repro_torch.scenarios import compile_scenario
    c = compile_scenario(scenario(ECMP_SHAPES[sname], "ecmp"))
    _, fa, ops = engine.prepare(c, "cuda", torch.float64)
    return len(fa), ops.ecmp_load[-1], ops.link_cap[-1]


def ecmp_cases(sname: str, plan, cap64, F: int, dtype, seed: int):
    """bucket_load_bottleneck on a real plan: in float64 bit-equal to the
    (ordered) plain version; in float32 bit-equal to the ordered plain
    sum and within F32_SUM_RTOL of the default (unordered) one."""
    import numpy as np
    import torch
    from repro_torch.kernels import link_load, ref

    rng = np.random.default_rng(seed)
    P, R, C = plan.shape
    rate = rng.uniform(0.0, 1.0, (F, P))
    rate[rng.random((F, P)) < 0.1] = 0.0
    rate = torch.tensor(rate, dtype=dtype, device="cuda")
    cap = cap64.to(dtype)
    isz = rate.element_size()
    pidx = torch.arange(P, device="cuda")[:, None, None]
    g = torch.cat([rate, rate.new_zeros((1, P))], 0).T[pidx, plan.long()]
    terms = int((plan < F).sum())
    f64 = dtype == torch.float64
    return [case(
        "bucket_load_bottleneck", "", sname, dtype,
        lambda: link_load.bucket_load_bottleneck(rate, plan, cap),
        lambda: ref.load_bottleneck_ref(rate, plan, cap, ordered=True),
        plan.numel() * 4 + rate.numel() * isz + 3 * P * R * isz,
        terms + 4 * P * R,
        loose=None if f64 else (
            lambda: ref.load_bottleneck_ref(rate, plan, cap,
                                            ordered=False), F32_SUM_RTOL),
        summary=sname == "giga" and f64,
        extra={"gathered_sum_ms": lambda: g.sum(-1)})]


def packet_inputs(lanes: int, N: int, seed: int, ties: bool = False):
    """Per-lane float32 vectors (lane 0 up) and N packets: tx rates and
    32-bit hashes over the full range (int32 bits, as the kernels read
    them).  `ties`: one queue and one weight for every lane, so that
    jsq_route's hashed tie-break alone decides among the lanes up."""
    import numpy as np
    import torch
    from repro_torch.kernels.jsq_route import hash32

    rng = np.random.default_rng(seed)

    def f(a):
        return torch.tensor(a, dtype=torch.float32, device="cuda")

    q = rng.uniform(0.0, 1.2, lanes)
    q[rng.random(lanes) < 0.2] = 0.5             # equal queues: ties
    mask = (rng.random(lanes) > 0.2).astype(np.float64)
    mask[0] = 1.0
    h = torch.tensor(rng.integers(0, 1 << 32, N), device="cuda")
    w = rng.uniform(0.25, 1.0, lanes)
    if ties:
        q[:], w[:] = 0.5, 0.5
    return (f(q), f(mask), f(w), f(rng.uniform(0.0, 0.6, N)),
            hash32("pkt_hash", h))


def packet_cases(seed: int):
    """jsq_route and plb_select at the PACKET_SHAPES, equal to their
    plain versions index for index."""
    import torch
    from repro_torch.kernels import jsq_route, plb_select, ref

    out = []
    for (lanes, N), ties in (*((s, False) for s in
                               PACKET_SHAPES["jsq_route"]),
                             (PACKET_SHAPES["jsq_route"][0], True)):
        q, up, w, _, h = packet_inputs(lanes, N, seed + N + 2 * ties,
                                       ties=ties)
        out.append(case(
            "jsq_route", "ties" if ties else "", f"{lanes}x{N}",
            torch.float32,
            lambda q=q, up=up, w=w, h=h: jsq_route.jsq_route(q, up, w, h),
            lambda q=q, up=up, w=w, h=h: ref.jsq_route_ref(q, up, w, h),
            3 * lanes * 4 + 2 * N * 4,
            N * lanes * FLOPS_PER_ELEM["jsq_route"],
            summary=N == 4096 and not ties))
    for lanes, N in PACKET_SHAPES["plb_select"]:
        ra, el, lq, tx, h = packet_inputs(lanes, N, seed + N + 1)
        args = (ra, el, lq, tx, h)
        out.append(case(
            "plb_select", "", f"{lanes}x{N}", torch.float32,
            lambda a=args: plb_select.plb_select(*a),
            lambda a=args: ref.plb_select_ref(*a),
            3 * lanes * 4 + 3 * N * 4,
            N * lanes * FLOPS_PER_ELEM["plb_select"], summary=N == 4096))
    return out


def max_errors(got, want):
    """(max |a-b|, max |a-b| / |b| over normal |b|) across outputs."""
    import torch
    if isinstance(want, torch.Tensor):
        got, want = (got,), (want,)
    abs_err, rel_err = 0.0, 0.0
    for g, w in zip(got, want):
        if not w.is_floating_point():            # indices
            abs_err = max(abs_err, float((g.long() - w.long()).abs().max()))
            continue
        d = (g - w).abs()
        abs_err = max(abs_err, float(d.max()))
        tiny = torch.finfo(w.dtype).tiny
        rel = d / w.abs().clamp_min(tiny)
        rel_err = max(rel_err, float(rel[w.abs() >= tiny].max())
                      if bool((w.abs() >= tiny).any()) else 0.0)
    return abs_err, rel_err


def all_cases():
    import torch
    cases = []
    for sname, shape in SHAPES.items():
        for dtype in (torch.float32, torch.float64):
            cases += kernel_cases(sname, shape, dtype, seed=len(cases))
    for sname in ECMP_SHAPES:
        F, plan, cap = ecmp_plan(sname)
        for dtype in (torch.float32, torch.float64):
            cases += ecmp_cases(sname, plan, cap, F, dtype, seed=len(cases))
    cases += packet_cases(seed=len(cases))
    # cases added after the first ones, so that their seeds do not move:
    # queue_update as a slot's grouped launch, plane_split on 4 planes
    for sname, shape in SHAPES.items():
        for dtype in (torch.float32, torch.float64):
            cases.append(queue_slot_case(sname, shape, dtype,
                                         seed=len(cases)))
    for sname, shape in PLANE_SHAPES.items():
        for dtype in (torch.float32, torch.float64):
            cases += plane_split_cases(
                sname, *plane_inputs(shape["F"], shape["P"], dtype,
                                     seed=len(cases)), dtype)
    return cases


def kernel_phase(report: dict) -> dict:
    """Every kernel vs its plain version; returns the per-kernel summary
    row (the giga float64 shape for the slot kernels, 4096 packets for
    the per-packet ones)."""
    import torch
    from repro_torch.kernels import build

    rows, summary = [], {}
    for c in all_cases():
        kernel, mode, sname, dname = (c[k] for k in
                                      ("kernel", "mode", "shape", "dtype"))
        what = f"{kernel}{'[' + mode + ']' if mode else ''} {sname} {dname}"
        got, want = c["run"](), c["plain"]()
        torch.cuda.synchronize()
        abs_err, rel_err = max_errors(got, want)
        if c["rtol"] is not None:
            if rel_err > c["rtol"]:
                fail(f"{what}: rel err {rel_err:.3g} > {c['rtol']}")
        elif abs_err != 0.0:
            fail(f"{what}: max abs err {abs_err:.3g}, expected bit-equal")
        row = dict(kernel=kernel, mode=mode, shape=sname, dtype=dname,
                   max_abs_err=abs_err, max_rel_err=rel_err,
                   bytes=c["bytes"], ops=c["ops"])
        if c["loose"] is not None:
            plain, rtol = c["loose"]
            _, loose_rel = max_errors(got, plain())
            if loose_rel > rtol:
                fail(f"{what}: rel err {loose_rel:.3g} > {rtol} against "
                     "the default plain version")
            row["default_plain_rel_err"] = loose_rel
        if mode not in ("dcqcn", "agg", "swlb"):
            ms, plain_ms = graph_ms(c["run"]), graph_ms(c["plain"])
            bytes_ms = c["bytes"] / HBM_BYTES_PER_S * 1e3
            ops_ms = c["ops"] / PEAK_FLOPS[dname] * 1e3
            row.update(ms=ms, plain_ms=plain_ms,
                       bound_ms=max(bytes_ms, ops_ms),
                       bound_by="bytes" if bytes_ms >= ops_ms
                       else "operations")
            row.update({k: graph_ms(fn) for k, fn in c["extra"].items()})
            print(f"kernel {what}: ms={ms:.6f} plain_ms={plain_ms:.6f} "
                  f"bound_ms={row['bound_ms']:.6f} ({row['bound_by']}) "
                  + "".join(f"{k}={row[k]:.6f} " for k in c["extra"])
                  + f"max_abs_err={abs_err:.3g} max_rel_err={rel_err:.3g}"
                  + (f" default_plain_rel_err="
                     f"{row['default_plain_rel_err']:.3g}"
                     if "default_plain_rel_err" in row else ""),
                  flush=True)
        if c["summary"]:
            summary[kernel] = row
        rows.append(row)
    for row in rows:
        s = summary[row["kernel"]]
        s["max_abs_err_all"] = max(s.get("max_abs_err_all", 0.0),
                                   row["max_abs_err"])
    report["kernels"] = rows
    report["launch_floor_ms"] = launch_floor_ms()
    build.reset_launches()
    return summary


def launch_floor_ms() -> float:
    """What one launch costs on this card: `bottleneck` on a single
    float64 element, in the harness that times the kernels."""
    import torch
    from repro_torch.kernels import link_load
    one = torch.ones(1, dtype=torch.float64, device="cuda")
    ms = graph_ms(lambda: link_load.bottleneck(one, one))
    print(f"launch floor: bottleneck on one element ms={ms:.6f} (graph "
          "of 20 calls; no kernel's bound)", flush=True)
    return ms


def sync_phase() -> None:
    """Neither slot loop waits for the device, under AR/WAR or ECMP: the
    eager loop, and the replays of the captured one (its capture, which
    synchronises on entry, runs before the check)."""
    import torch
    from repro_torch.netsim import engine
    from repro_torch.scenarios import compile_scenario

    for routing in (None, "ecmp"):
        c = compile_scenario(scenario("fig11_degraded_leaf", routing)
                             .with_sim(slots=24))
        cfg, _, ops = engine.prepare(c, "cuda", torch.float64)
        loop = engine.slot_loop(cfg, ops)
        loop.capture()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eager = engine._simulate(cfg, ops, _eager=True)
            loop.replay()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        captured = engine._results(cfg, loop.carry, loop.totals)
        if not all(bool(o.isfinite().all()) for o in eager + captured
                   if o.is_floating_point()):
            fail("sync phase: non-finite output")
        if not all(torch.equal(a, b) for a, b in zip(captured, eager)):
            fail("sync phase: the captured loop differs from the eager one")
        print(f"sync: {cfg.routing} eager slot loop and captured replays "
              "ran with sync debug mode 'error'", flush=True)


def check_launches(what: str, counts: dict, want: dict,
                   total: dict) -> None:
    """`counts` (every kernel's launches in one run of a path) must be
    `want` exactly, zero for kernels the path does not run; they add to
    `total`."""
    from repro_torch.kernels import build
    want = {k: want.get(k, 0) for k in build.KERNELS}
    if counts != want:
        fail(f"{what}: launches {counts}, expected {want}")
    for k, n in counts.items():
        total[k] = total.get(k, 0) + n


def slot_launches(routing: str, slots: int) -> dict:
    return {k: slots * n for k, n in PER_SLOT[routing].items()}


def assert_parity(spec, c, ref, got) -> None:
    """`tests/test_jx_parity.py::_assert_parity`'s contract."""
    import numpy as np
    from repro_torch.scenarios import distill_metrics
    np.testing.assert_allclose(got.mean_goodput, ref.mean_goodput,
                               atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(got.completion_slot, ref.completion_slot)
    np.testing.assert_allclose(got.total_goodput, ref.total_goodput,
                               atol=TOL * len(ref.mean_goodput), rtol=TOL)
    np.testing.assert_allclose(got.util_up_last, ref.util_up_last,
                               atol=TOL, rtol=TOL)
    assert got.groups == ref.groups
    np.testing.assert_array_equal(got.group_of, ref.group_of)
    m_ref, m_got = (distill_metrics(spec, c, r) for r in (ref, got))
    for t in m_ref.tenant_mean:
        for field in ("tenant_mean", "tenant_p01", "tenant_p99"):
            a, b = getattr(m_got, field)[t], getattr(m_ref, field)[t]
            if abs(a - b) > TOL:
                fail(f"{spec.name}: {field}[{t}] {a} vs {b}")
    if abs(m_got.isolation_index - m_ref.isolation_index) > TOL:
        fail(f"{spec.name}: isolation_index")
    if m_got.recovery_slots != m_ref.recovery_slots:
        fail(f"{spec.name}: recovery_slots {m_got.recovery_slots} vs "
             f"{m_ref.recovery_slots}")


def assert_golden(name: str, m, golden: dict) -> None:
    """Distilled metrics vs the NumPy engine's golden snapshot."""
    import math
    want = golden[name]
    got = {"mean_goodput": m.mean_goodput, "tenant_mean": m.tenant_mean,
           "tenant_p01": m.tenant_p01, "tenant_p99": m.tenant_p99,
           "isolation_index": m.isolation_index,
           "recovery_slots": [list(r) for r in m.recovery_slots],
           "completion_tail": (None if math.isnan(m.completion_tail)
                               else m.completion_tail),
           "symmetry_cv": m.symmetry_cv,
           "symmetry_uniform": m.symmetry_uniform}

    def close(a, b, path):
        if isinstance(b, dict):
            if set(a) != set(b):
                fail(f"golden {path}: keys differ")
            for k in b:
                close(a[k], b[k], f"{path}.{k}")
        elif isinstance(b, list):
            if len(a) != len(b):
                fail(f"golden {path}: length")
            for i, (x, y) in enumerate(zip(a, b)):
                close(x, y, f"{path}[{i}]")
        elif isinstance(b, float) and not isinstance(b, bool):
            if abs(a - b) > TOL:
                fail(f"golden {path}: {a} vs {b}")
        elif a != b:
            fail(f"golden {path}: {a!r} vs {b!r}")

    close(got, want, name)


def registry_phase(report: dict, total: dict) -> None:
    import torch
    from repro_torch.kernels import build
    from repro_torch.scenarios import compile_scenario, distill_metrics

    golden = json.loads((ROOT / "tests/golden/scenarios.json").read_text())
    report["registry"] = []
    for name, routing in REGISTRY:
        spec, what = scenario(name, routing), label(name, routing)
        c = compile_scenario(spec)
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        gpu = c.run(device="cuda")               # float64 parity mode
        wall = time.perf_counter() - t0
        check_launches(what, dict(build.LAUNCHES),
                       slot_launches(spec.sim.routing, spec.sim.slots),
                       total)
        cpu = compile_scenario(spec).run(device="cpu")
        assert_parity(spec, c, cpu, gpu)
        m = distill_metrics(spec, c, gpu)
        # the golden rows are the registry's own specs
        if routing is None:
            assert_golden(name, m, golden)
        report["registry"].append(dict(
            scenario=what, slots=spec.sim.slots, flows=len(c.flows),
            wall_s=wall, mean_goodput=m.mean_goodput))
        print(f"registry {what}: {spec.sim.slots} slots, {len(c.flows)} "
              f"flows, GPU f64 captured {wall:.3f} s; parity with CPU "
              "plain path"
              f"{' and golden metrics' if routing is None else ''}: ok; "
              f"mean_goodput={m.mean_goodput!r}", flush=True)


def assert_contained_fork(spec, c, ref, got, fork_frac=0.05) -> dict:
    """`tests/test_jx_parity.py::_assert_parity_chaotic`'s contract."""
    import numpy as np
    from repro_torch.scenarios import distill_metrics
    r, j = np.asarray(ref.mean_goodput), np.asarray(got.mean_goodput)
    forked = ~np.isclose(j, r, atol=TOL, rtol=TOL)
    stats = dict(forked_frac=float(forked.mean()),
                 max_abs_diff=float(np.abs(j - r).max()),
                 completion_diff_frac=float(np.mean(
                     got.completion_slot != ref.completion_slot)))
    if forked.mean() > fork_frac:
        fail(f"{forked.sum()}/{forked.size} flows forked")
    if np.abs(j - r).max() > 0.05 or abs(j.mean() - r.mean()) > 1e-3:
        fail("giga: goodput spread")
    if stats["completion_diff_frac"] > fork_frac:
        fail("giga: completion slots")
    np.testing.assert_allclose(got.total_goodput, ref.total_goodput,
                               rtol=2e-2, atol=1e-3 * len(r))
    util_diff = np.abs(np.asarray(got.util_up_last)
                       - np.asarray(ref.util_up_last))
    if not ((util_diff > TOL).mean() <= 3 * fork_frac
            and np.quantile(util_diff, 0.99) <= 0.01
            and util_diff.mean() <= 1e-3):
        fail("giga: util spread")
    assert got.groups == ref.groups
    m_ref, m_got = (distill_metrics(spec, c, x) for x in (ref, got))
    for t in m_ref.tenant_mean:
        if not (abs(m_got.tenant_mean[t] - m_ref.tenant_mean[t]) <= 1e-3
                and abs(m_got.tenant_p01[t] - m_ref.tenant_p01[t]) <= 2e-2
                and abs(m_got.tenant_p99[t] - m_ref.tenant_p99[t]) <= 2e-2):
            fail(f"giga: tenant {t} metrics")
    if abs(m_got.isolation_index - m_ref.isolation_index) > 1e-2:
        fail("giga: isolation_index")
    for (s_j, k_j, n_j), (s_r, k_r, n_r) in zip(m_got.recovery_slots,
                                                m_ref.recovery_slots):
        if (s_j, k_j) != (s_r, k_r) or abs(n_j - n_r) > 2:
            fail("giga: recovery_slots")
    return stats


def loop_walls(c, dtype, runs: int = 3) -> dict:
    """Host prep, then `runs` eager and `runs` captured slot loops of one
    prepared run, in turns (eager, captured, captured, eager, ...), each
    held bit-equal to the first eager run; walls in seconds, each ending
    in a synchronize.  A captured run is its capture (slot 0 eagerly,
    then one graph per capacity segment) and its replays of slots
    1..T-1."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.netsim import engine

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cfg, _, ops = engine.prepare(c, "cuda", dtype)
    torch.cuda.synchronize()
    out = dict(prep_s=time.perf_counter() - t0, eager_s=[], capture_s=[],
               replay_s=[], graphs=0)
    want = None
    order = [k % 4 in (1, 2) for k in range(2 * runs)]
    for captured in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if captured:
            loop = engine.slot_loop(cfg, ops)
            loop.capture()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            loop.replay()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            res = engine._results(cfg, loop.carry, loop.totals)
            out["capture_s"].append(t1 - t0)
            out["replay_s"].append(t2 - t1)
            out["graphs"] = len(loop.graphs)
            del loop
        else:
            res = engine._simulate(cfg, ops, _eager=True)
            torch.cuda.synchronize()
            out["eager_s"].append(time.perf_counter() - t0)
        res = [r.clone() for r in res]
        if want is None:
            want = res
        elif not all(torch.equal(a, b) for a, b in zip(res, want)):
            fail(f"{c.spec.name} {dtype}: a "
                 f"{'captured' if captured else 'eager'} loop differs "
                 "from the eager one")
    build.reset_launches()
    out["results"] = want
    return out


def scale_phase(report: dict, total: dict) -> None:
    """The giga point under AR and under its own ECMP, float32 and
    float64, through the entry point (captured slots); each run held bit
    for bit to an eager loop of its dtype, the loop timed apart from the
    host prep; each float64 run against the CPU plain path, the ECMP one
    also against the golden row."""
    import numpy as np
    import torch
    from repro_torch.kernels import build
    from repro_torch.scenarios import compile_scenario, distill_metrics

    golden = json.loads((ROOT / "tests/golden/scenarios.json").read_text())
    report["scale"] = {}
    for routing in ("ar", None):
        spec = scenario("giga_fabric_storage", routing)
        what = label("giga_fabric_storage", spec.sim.routing)
        out = report["scale"][what] = {}
        runs = {}
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype).split(".")[1]
            c = compile_scenario(spec)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            build.reset_launches()
            t0 = time.perf_counter()
            res = c.run(device="cuda", dtype=dtype)
            wall = time.perf_counter() - t0
            counts = dict(build.LAUNCHES)
            check_launches(f"{what} {dname}", counts,
                           slot_launches(spec.sim.routing, spec.sim.slots),
                           total)
            if res.mean_goodput.shape != (len(c.flows),) or not np.isfinite(
                    res.mean_goodput).all():
                fail(f"{what} {dname}: bad mean_goodput")
            mem = torch.cuda.max_memory_allocated()
            per_slot = sum(counts.values()) / spec.sim.slots
            walls = loop_walls(c, dtype)
            eager = [o.cpu().numpy() for o in walls.pop("results")]
            if not (np.array_equal(res.mean_goodput, eager[0])
                    and np.array_equal(res.completion_slot, eager[1])
                    and np.array_equal(res.total_goodput,
                                       eager[2][::spec.sim.record_every])
                    and np.array_equal(res.util_up_last, eager[3])):
                fail(f"{what} {dname}: the captured run differs from the "
                     "eager loop")
            runs[dname] = (c, res)
            T = spec.sim.slots
            out[dname] = dict(
                wall_s=wall, slots_per_s=T / wall,
                kernel_launches_per_slot=per_slot,
                max_memory_allocated=mem, flows=len(c.flows),
                mean_goodput=float(res.mean_goodput.mean()), **walls)
            print(f"scale {what} {dname}: {len(c.flows)} flows x {T} "
                  f"slots through the entry point (captured), wall "
                  f"{wall:.3f} s (host prep included), {T / wall:.2f} "
                  f"slots/s, {per_slot:g} hand-written kernel "
                  f"launches/slot, max_memory_allocated "
                  f"{mem / 2**20:.1f} MiB, mean goodput "
                  f"{res.mean_goodput.mean()!r}; bit-equal to the eager "
                  "loop", flush=True)
            print(f"scale {what} {dname} loop: host prep "
                  f"{walls['prep_s']:.3f} s; eager "
                  + ", ".join(f"{w / T * 1e3:.3f}" for w in walls["eager_s"])
                  + " ms/slot; captured: capture (slot 0 and "
                  f"{walls['graphs']} graph(s)) "
                  + ", ".join(f"{w * 1e3:.1f}" for w in walls["capture_s"])
                  + " ms, replays "
                  + ", ".join(f"{w / (T - 1) * 1e3:.3f}"
                              for w in walls["replay_s"])
                  + " ms/slot", flush=True)
        t0 = time.perf_counter()
        cpu = compile_scenario(spec).run(device="cpu")
        cpu_wall = time.perf_counter() - t0
        c64, gpu64 = runs["float64"]
        stats = assert_contained_fork(spec, c64, cpu, gpu64)
        if routing is None:
            assert_golden(spec.name, distill_metrics(spec, c64, gpu64),
                          golden)
        f32_diff = float(np.abs(runs["float32"][1].mean_goodput
                                - gpu64.mean_goodput).max())
        out["parity"] = dict(cpu_wall_s=cpu_wall,
                             f32_vs_f64_max_abs=f32_diff, **stats)
        print(f"scale {what} parity: GPU f64 vs CPU plain path "
              f"({cpu_wall:.1f} s): {stats}"
              f"{'; golden metrics: ok' if routing is None else ''}; "
              f"f32 vs f64 max |diff| {f32_diff:.3g}", flush=True)


def packet_phase(report: dict, total: dict) -> None:
    """The per-packet path through its entry points
    (`repro_torch.kernels.ops`): PACKET_BATCHES batches of 4096 packets
    routed to switch ports by jsq_route and to NIC planes by plb_select,
    and one more jsq_route batch over ports that all score the same,
    each batch equal to the plain versions and never on a down port or
    an ineligible plane."""
    import torch
    from repro_torch.kernels import build, ops, ref

    (ports, n), (planes, _) = (PACKET_SHAPES[k][0]
                               for k in ("jsq_route", "plb_select"))
    batches = [(packet_inputs(ports, n, 1000 + i),
                packet_inputs(planes, n, 2000 + i))
               for i in range(PACKET_BATCHES)]
    tq, tup, tw, _, th = packet_inputs(ports, n, 3000, ties=True)
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    outs = [(ops.jsq_route(q, up, w, h),
             ops.plb_select(ra, el, lq, tx, hp))
            for (q, up, w, _, h), (ra, el, lq, tx, hp) in batches]
    tie_port = ops.jsq_route(tq, tup, tw, th)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_launches("packets", dict(build.LAUNCHES),
                   {"jsq_route": PACKET_BATCHES + 1,
                    "plb_select": PACKET_BATCHES}, total)
    if not torch.equal(tie_port, ref.jsq_route_ref(tq, tup, tw, th)) or \
            bool((tup[tie_port.long()] == 0).any()):
        fail("packets: the batch of equal port scores differs from the "
             "plain version or went to a down port")
    for ((q, up, w, _, h), (ra, el, lq, tx, hp)), (port, plane) in zip(
            batches, outs):
        if not (torch.equal(port, ref.jsq_route_ref(q, up, w, h))
                and torch.equal(plane,
                                ref.plb_select_ref(ra, el, lq, tx, hp))):
            fail("packets: a batch differs from the plain versions")
        if bool((up[port.long()] == 0).any()) or \
                bool((el[plane.long()] == 0).any()):
            fail("packets: a packet went to a down port or plane")
    report["packets"] = dict(batches=PACKET_BATCHES, packets=n,
                             ports=ports, planes=planes, wall_s=wall)
    print(f"packets: {PACKET_BATCHES} batches of {n} packets through "
          f"ops.jsq_route ({ports} ports) and ops.plb_select ({planes} "
          f"planes), and one of equal port scores through ops.jsq_route, "
          f"in {wall * 1e3:.3f} ms; equal to the plain versions",
          flush=True)


def event_ms(fn, repeats: int = 3) -> float:
    """Median device time of one `fn()` call between CUDA events, after
    a warm-up call; for calls too large to capture 20 times in a graph
    (the plain attention builds (heads, 4096, 4096) float32 scores)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def attn_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """Query-key pairs that the masks keep (the attention's real work):
    query i sees keys max(0, i - window + 1)..(i if causal else Sk - 1)."""
    import numpy as np
    i = np.arange(Sq, dtype=np.int64)
    lo = np.maximum(0, i - window + 1) if window > 0 else np.zeros_like(i)
    hi = np.minimum(i, Sk - 1) if causal else np.full_like(i, Sk - 1)
    return int(np.maximum(0, hi - lo + 1).sum())


def model_cases(seed: int) -> list:
    """The model_kernels cases, inputs on the card from a seeded
    generator, in main-path order: four prefills through
    `ops.flash_attention_bshd`, one decode, then the int8 codec."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import int8_codec, ops, ref

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def prefill(name, cfg, dtype):
        S, D, window = PREFILL_S, cfg["D"], cfg["window"]
        q = randn(1, S, cfg["Hq"], D, dtype=dtype)
        k, v = (randn(1, S, cfg["Hkv"], D, dtype=dtype) for _ in range(2))
        pos = torch.arange(S, device="cuda")
        mask = None if not window else (
            (pos[:, None] >= pos[None, :])
            & (pos[:, None] - pos[None, :] < window))
        dname = str(dtype).split(".")[1]
        return dict(
            kernel="flash_attention", what=f"{name} {dname}", dtype=dname,
            run=lambda: ops.flash_attention_bshd(q, k, v, causal=True,
                                                 window=window),
            plain=lambda: ref.flash_attention_bshd_ref(
                q, k, v, causal=True, window=window),
            library=lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask, is_causal=mask is None, enable_gqa=True),
            bytes=(2 * q.numel() + 2 * k.numel()) * q.element_size(),
            ops=4 * D * cfg["Hq"] * attn_pairs(S, S, True, window),
            tol=ATTN_TOL[dname],
            summary=name.startswith("llama") and dtype == torch.bfloat16)

    cases = [prefill("llama3-8b prefill", LLAMA, torch.bfloat16),
             prefill("llama3-8b prefill", LLAMA, torch.float32),
             prefill("gemma3-12b local", GEMMA, torch.bfloat16),
             prefill("gemma3-12b local", GEMMA, torch.float32)]

    B, S, H, D = DECODE_B, DECODE_S, LLAMA["Hq"], LLAMA["D"]
    q = randn(B, H, 1, D, dtype=torch.bfloat16)
    k, v = (randn(B, H, S, D, dtype=torch.bfloat16) for _ in range(2))
    lens = torch.tensor(np.linspace(1, S, B).round().astype(np.int32),
                        device="cuda")
    valid = (torch.arange(S, device="cuda")[None, None, None, :]
             < lens[:, None, None, None])
    keys = int(lens.sum())
    cases.append(dict(
        kernel="decode_attention", what=f"llama3-8b decode B={B} S={S}",
        dtype="bfloat16",
        run=lambda: ops.decode_attention(q, k, v, lens),
        plain=lambda: ref.decode_attention_ref(q, k, v, lens),
        library=lambda: F.scaled_dot_product_attention(q, k, v,
                                                       attn_mask=valid),
        bytes=(2 * q.numel() + 2 * H * D * keys) * q.element_size() + 4 * B,
        ops=4 * D * H * keys, tol=ATTN_TOL["bfloat16"], summary=True))

    R, C = CODEC_SHAPE
    grad = randn(R, C) * 1e-3
    noise = torch.rand((R, C), generator=gen, device="cuda") - 0.5
    # the decode reads the plain version's codes, which the encode
    # kernel must equal bit for bit
    codes, scale = ref.int8_encode_ref(grad, noise)
    # the f32 gradient (the summary case), the same in bf16, and an odd
    # row length whose rows take element loads
    for x, nz in ((grad, noise), (grad.to(torch.bfloat16), noise),
                  (grad[:, :CODEC_ODD_C].contiguous(),
                   noise[:, :CODEC_ODD_C].contiguous())):
        instance, width = int8_codec.encode_instance(x, nz)
        dname = str(x.dtype).split(".")[1]
        cases.append(dict(
            kernel="int8_encode",
            what=f"int8_encode {R}x{x.shape[1]} {dname} ({instance}, "
                 f"{width} a load)", dtype=dname,
            run=lambda x=x, nz=nz: ops.int8_encode(x, nz),
            plain=lambda x=x, nz=nz: ref.int8_encode_ref(x, nz),
            library=None, bytes=x.numel() * (x.element_size() + 4 + 1)
            + R * 4, ops=CODEC_FLOPS["int8_encode"] * x.numel(), tol=None,
            summary=x is grad))
    cases.append(dict(
        kernel="int8_decode", what=f"int8_decode {R}x{C}", dtype="float32",
        run=lambda: ops.int8_decode(codes, scale),
        plain=lambda: ref.int8_decode_ref(codes, scale),
        library=lambda: codes * scale,
        bytes=R * C * (1 + 4) + R * 4,
        ops=CODEC_FLOPS["int8_decode"] * R * C, tol=None, summary=True))
    return cases


def model_phase(report: dict, total: dict, summary: dict) -> None:
    """The attention and codec entry points of `repro_torch.kernels.ops`
    at full model widths: one main-path run (launches counted), then
    each kernel against its plain version on the same tensors (attention
    within ATTN_TOL, the codec bit for bit) and timed beside the plain
    version, one PyTorch call and the bound."""
    import torch
    from repro_torch.kernels import build

    # the plain versions' float32 einsums run in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = model_cases(seed=14)
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    outs = [c["run"]() for c in cases]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_launches("model_kernels", dict(build.LAUNCHES), MODEL_LAUNCHES,
                   total)
    rows = []
    for c, got in zip(cases, outs):
        want = c["plain"]()
        torch.cuda.synchronize()
        what = c["what"]
        if c["tol"] is None:                     # the codec: bit for bit
            for g, w in zip(*((x,) if isinstance(x, torch.Tensor) else x
                              for x in (got, want))):
                if g.shape != w.shape or g.dtype != w.dtype or not \
                        torch.equal(g.view(torch.uint8),
                                    w.view(torch.uint8)):
                    fail(f"{what}: differs from the plain version")
            err = 0.0
        else:
            if got.shape != want.shape or got.dtype != want.dtype or not \
                    bool(got.isfinite().all()):
                fail(f"{what}: shape, dtype or non-finite output")
            err = float((got.float() - want.float()).abs().max())
            if not err <= c["tol"]:
                fail(f"{what}: max abs err {err:.3g} > {c['tol']}")
        del got, want
        ms = graph_ms(c["run"], reps=5)
        plain_ms = event_ms(c["plain"])
        library_ms = (None if c["library"] is None
                      else graph_ms(c["library"], reps=5))
        bytes_ms = c["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = c["ops"] / PEAK_FLOPS[c["dtype"]] * 1e3
        row = dict(kernel=c["kernel"], case=what, dtype=c["dtype"],
                   max_abs_err=err, tol=c["tol"], bytes=c["bytes"],
                   ops=c["ops"], ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        attn = ""
        if c["kernel"] == "flash_attention":
            row.update(tflops=c["ops"] / ms / 1e9,
                       sdpa_ratio=ms / library_ms)
            attn = (f"tflops={row['tflops']:.1f} "
                    f"ms/sdpa_ms={row['sdpa_ratio']:.3f} ")
        print(f"model {what}: ms={ms:.6f} plain_ms={plain_ms:.6f} "
              f"library_ms="
              f"{'none' if library_ms is None else f'{library_ms:.6f}'} "
              f"bound_ms={row['bound_ms']:.6f} ({row['bound_by']}) "
              + attn + f"max_abs_err={err:.3g} (bound "
              f"{'bit-equal' if c['tol'] is None else c['tol']})",
              flush=True)
        rows.append(row)
        if c["summary"]:
            summary[c["kernel"]] = dict(row)
    for row in rows:
        s = summary[row["kernel"]]
        s["max_abs_err_all"] = max(s.get("max_abs_err_all", 0.0),
                                   row["max_abs_err"])
    report["model_kernels"] = dict(rows=rows, main_path_wall_s=wall)
    print(f"model_kernels: main path (4 prefills, 1 decode, 3 encodes, "
          f"1 decode) in {wall * 1e3:.3f} ms of host wall; every kernel "
          "within its bound of the plain version", flush=True)
    del cases, outs
    build.reset_launches()
    torch.cuda.empty_cache()


def profile_phase(report: dict) -> None:
    """Where a giga slot's time goes: `torch.profiler` over the slot loop
    (12 slots, host prep excluded) under AR and under ECMP, in float64
    and float32, eager and captured (the captured loop's replays of
    slots 1..11; its capture runs before the profiler starts).  Device
    busy share = summed kernel time / loop wall.  Prints "not measured"
    when the profiler records no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.netsim import engine
    from repro_torch.scenarios import compile_scenario

    slots = 12
    report["profile"] = {}

    def loop_run(cfg, ops, captured):
        """A callable that runs the loop (for the captured loop: its
        replays, the capture done here), and the slots it runs."""
        if not captured:
            return (lambda: engine._simulate(cfg, ops, _eager=True)), slots
        loop = engine.slot_loop(cfg, ops)
        loop.capture()
        return loop.replay, slots - 1

    for routing in ("ar", "ecmp"):
        c = compile_scenario(scenario("giga_fabric_storage", routing)
                             .with_sim(slots=slots))
        for dtype in (torch.float64, torch.float32):
            dname = str(dtype).split(".")[1]
            cfg, _, ops = engine.prepare(c, "cuda", dtype)
            for captured in (False, True):
                kind = "captured" if captured else "eager"
                what = f"{label('giga_fabric_storage', routing)} {dname} " \
                       f"{kind}"
                run, n = loop_run(cfg, ops, captured)
                run()                            # warm-up
                torch.cuda.synchronize()
                run, n = loop_run(cfg, ops, captured)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                plain_wall = time.perf_counter() - t0
                run, n = loop_run(cfg, ops, captured)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    run()
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                del run
                kernels = [e for e in prof.key_averages()
                           if e.device_type == DeviceType.CUDA]
                busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
                top = sorted(kernels,
                             key=lambda e: -e.self_device_time_total)[:8]
                out = report["profile"][what] = dict(
                    scenario=what, slots=n, loop_wall_s=plain_wall,
                    profiled_wall_s=wall, device_busy_s=busy_s,
                    launches_per_slot=sum(e.count for e in kernels) / n,
                    top=[dict(name=e.key[:120],
                              ms=e.self_device_time_total / 1e3,
                              count=e.count) for e in top])
                if busy_s == 0.0:
                    print(f"profile {what}: device time not measured "
                          "(profiler saw no device activity)", flush=True)
                    continue
                print(f"profile {what} loop: "
                      f"{plain_wall / n * 1e3:.3f} ms/slot unprofiled, "
                      f"{wall / n * 1e3:.3f} ms/slot profiled, device busy "
                      f"{busy_s / plain_wall:.1%} of the unprofiled wall "
                      f"and {busy_s / wall:.1%} of the profiled one "
                      f"({busy_s / n * 1e3:.3f} ms/slot), "
                      f"{out['launches_per_slot']:.0f} kernels/slot",
                      flush=True)
                for e in top[:5]:
                    print(f"  {e.self_device_time_total / 1e3 / n:.4f} "
                          f"ms/slot x{e.count / n:g} {e.key[:90]}",
                          flush=True)


def main(argv=None) -> int:
    import argparse
    import torch
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--report", type=Path, default=None,
                        help="also write the full report as JSON here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    build.library()
    print(f"build: nvcc {build.build_seconds:.2f} s (both sources), "
          f"library loaded after "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    print(f"build: {sass_check()}", flush=True)

    report = {"nvidia_smi": smi, "device": torch.cuda.get_device_name(0)}
    summary = kernel_phase(report)
    sync_phase()
    total: dict = {}
    registry_phase(report, total)
    scale_phase(report, total)
    packet_phase(report, total)
    model_phase(report, total, summary)
    profile_phase(report)
    idle = [k for k in build.KERNELS if not total.get(k)]
    if idle:
        fail(f"kernels never launched on the main paths: {idle}")

    kernels = [dict(
        name=k, route="cuda",
        source=str(build.source(k).relative_to(ROOT)), replaces=REPLACES[k],
        launches=total[k], max_abs_err=summary[k]["max_abs_err_all"],
        ms=summary[k]["ms"], plain_ms=summary[k]["plain_ms"],
        bound_ms=summary[k]["bound_ms"], bound_by=summary[k]["bound_by"],
        library_ms=summary[k].get("library_ms"), status="ok")
        for k in build.KERNELS]
    report["summary"] = kernels
    report["wall_s"] = time.perf_counter() - t0
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(report, indent=1))
    print(f"total: {report['wall_s']:.1f} s after the start of the build",
          flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
