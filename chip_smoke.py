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
            bf16 ones, HMMA (mma.sync, 3xTF32) in the float32 ones, and
            HMMA in both dtypes' backward dK/dV and dQ kernels (fatal if
            one has none; "not measured" without cuobjdump).
  bwd       the flash backward kernel at BWD_CELLS (spx-100m's train
            shape, llama3-8b's and gemma3-12b's prefill cells) against
            its plain version, two launches bit-equal, timed beside it,
            SDPA's backward and the bound (10 D flops a kept pair),
            with the rate of the work it does (14 D a kept pair, 18 D
            at head_dim 192 and 256) and its delta, dK/dV and dQ
            kernels' times apart (torch.profiler; first of the phases,
            as a profile of them after the others saw none).
  kernels   each of the eight kernels against its plain PyTorch version
            on the same GPU tensors: the five AR/WAR slot kernels at the
            fig9 and giga AR shapes (bottleneck on one pair of links and
            as a slot's grouped launch of four and of two pairs;
            queue_update on one link array and as a slot's grouped
            launch of its up and down links; plane_split also on 4
            planes, fig12's flow and giga's flow count),
            bucket_load_bottleneck on the engine's own ECMP plans of
            fig11, the giga point and the giga fat tree, and over a lane
            axis on LANES seeds' plans of the giga point and of the
            giga fat tree (bit-equal to the plain version and to the
            single-lane launches, timed beside them), the giga fat
            tree's pair_fractions (32 cores), bottleneck as its slot's
            group of six pairs and queue_update as its group of four
            entries, all in float32 and float64, and
            segment_sum (sparse aggregation's flow-ordered sum; not a
            TPU kernel) on the giga point's own plans: access, ECMP
            links, the AR pair plan, a slot's grouped launch, LANES
            seeds' link plans and a fold over chunks of SEG_CHUNK
            flows, timed beside `index_add_` (which keeps no order),
            the per-packet jsq_route and plb_select at the
            `kernels_bench.py` shapes plus a block tail (jsq_route
            also with every port scoring the same); CUDA-event
            times of kernel and plain version (each captured in a CUDA
            graph of 20 calls, so host launch overhead is excluded)
            beside the least time the card needs for the bytes moved or
            the operations done; and the launch floor, `bottleneck` on
            one element in the same harness.
  sync      the AR, WAR and ECMP slot loops on both fabrics, under
            failure reaction and with a training-step schedule (its
            phase boundaries and its flap), under sparse aggregation
            and in flow chunks (SYNC_SPARSE), and a traced batch of
            three points, eager
            and the replays of the captured one, run with CUDA sync
            debugging set to "error": nothing in them makes the host
            wait (the capture, which synchronises on entry, runs
            before).
  registry  the leaf-spine fig9_victim_noise, fig11_degraded_leaf and
            fig12_plane_flap under their own routing (AR/WAR), and
            fig12_plane_flap and cascading_spine_loss under ECMP; the
            fat-tree bisection_fat_tree, ft_cross_pod_all2all and
            ft_core_failure_resiliency (the last also under ECMP); the
            failure-reaction reroute_random_failures, poisson_flap_storm
            and reroute_random_failures_ft; each through
            `compile_scenario(...).run(device="cuda")` in float64 (the
            captured slot loop), held against the CPU plain path (1e-5,
            exact completion slots, equal distilled rows, the blackhole
            series within 1e-5) and, for the registry's own specs,
            against `tests/golden/scenarios.json` (1e-5); every kernel
            must have launched `PER_SLOT[kind, routing]` times per slot,
            replays included.
  scale     giga_fabric_storage (4096 hosts, 102,400 flows, 8 random
            link kills, 60 slots) under AR and under its own ECMP, the
            same on a 3-tier fat tree of equal bisection (giga_fat_tree,
            GIGA_FAT_TREE) under WAR and ECMP, each in float32 and
            float64, and giga_fabric_storage under the registry's
            failure reaction (backup failover after 2 slots) in
            float64, on the GPU through the entry point (captured); each
            run bit-equal to an eager loop of its dtype, and the loop
            timed apart from the host prep over 3 eager and 3 captured
            runs in turns (capture and replays apart); each float64 run
            is held against the CPU plain path with the contained-fork
            contract used for giga-scale parity (the reaction run's
            blackhole series within 1e-5), and the leaf-spine ECMP one
            against the golden row (1e-5).
            Each giga run takes the engine's own aggregation mode
            (sparse at 4,096 hosts); the ECMP point runs once more
            forced dense (REPRO_JX_AGG=dense), so the dense path and
            bucket_load_bottleneck stay driven at giga.
  sparse    the giga point under AR and its own ECMP, f64 and f32,
            under its own mode (sparse) and forced dense: bit-equal to
            each other, each captured loop bit-equal to its eager loop,
            with the entry point's wall, replays a slot, the device's
            busy share and device launches a slot (torch.profiler),
            hand-written launches a slot and peak memory; the ECMP f64
            point in chunks of SEG_CHUNK flows (7, a tail of 4,096),
            bit-equal to one pass; a megabatch of 3 giga seeds sparse
            and in chunks, each row equal to its point alone; and
            `giga_beyond` (GIGA_BEYOND: 409,600 flows, ECMP, f64, 60
            slots) sparse and forced dense, bit-equal, its first
            BEYOND_CPU_SLOTS slots against the CPU path.
  compact   the int8 compact carry (COMPACT_RUNS): the giga point under
            its own ECMP and under AR in float32, wide and with
            REPRO_JX_COMPACT=1, bit-equal in every output; the compact
            probe counter is int8 and a float64 run's int32; replays a
            slot and peak memory of both.
  trace     fig12_plane_flap at 600 slots traced through the entry
            point in float64, against the CPU path (host_bw, util and
            queue within 1e-5, ecn and eligible equal) and the paper's
            signature (straggler ranks (0,), bi-modal share 0.25); the
            giga point recording every TRACE_EVERY slots, its captured
            loop bit-equal to the eager one with the records, and its
            wall a slot with and without the trace.
  batch     `engine.run_compiled_batch` over BATCH_SEEDS seeds of
            BATCH_POINT (each lane equal to its single run on the card,
            points/s against the single runs), `megabatch.run_megabatch`
            over the GRID (rows equal to their single runs and within
            parity of the CPU path, captured loops per group), and
            LANES seeds of the giga point under ECMP batched against one
            at a time (prep, capture, loop, peak memory); 5 hand-written
            launches a slot whatever the lanes; two batches of one
            structure (ALIAS_BATCHES) dispatched before either is
            finalized, the second rebinding the first's cached loop,
            each equal to its batch run alone.
  schedule  the registry's training-step schedules (train_step_baseline,
            train_step_flap, train_step_flap_moe) under their own AR and
            the two flaps also under ECMP and WAR, in float64 through
            the entry point, each held to the CPU plain path (the
            registry contract, step times exactly), the registry's own
            specs to the golden rows, the flaps to the study's signature
            (step 1 >= 1.2x step 0, step 2 <= 1.1x), with their graphs,
            capture and replay walls; SCHEDULE_TWICE run twice in one
            process, the second run from the graph cache (0 graphs, 0 s
            of capture, bit-equal), both capture walls printed; then
            GIGA_TRAIN at full width on
            the giga leaf-spine (llama3-8b over 4,096 ranks under AR in
            float64 and float32 and under ECMP, phi3.5-moe over 512
            ranks under AR): compile and host-prep walls, graphs and
            their capture wall, replays a slot, the device's busy
            share of the first GIGA_TRAIN_PROFILE_SLOTS slots' replays
            (torch.profiler), peak memory, hand-written launches a slot
            (5) and the step times; each float64 run's first
            GIGA_TRAIN_CPU_SLOTS slots against the CPU plain path under
            the contained-fork contract.
  sweep     the Experiment API (`repro_torch.experiments`): (a) every
            registered experiment (93 points) through
            `run_experiment(..., dispatch="megabatch")` on the card in
            float64, each row equal to its point run alone through
            `run_point` (floats within 1e-12, `extra` included),
            topo_kind_resiliency and reroute_reaction also within 1e-5
            of the CPU path, train_comms_resiliency's flaps against the
            study's signature; points/s batched and one at a time,
            loops, graphs, the walls of host prep, capture, loop and
            finalize, the host prep the pipeline overlapped with a loop,
            peak memory; the same again in the same process with no run
            cache, every loop from the graph cache (0 graphs, 0 s of
            capture, rows bit-equal), the first pass's hits and what the
            cache holds, and once more without the cache
            (GRAPH_CACHE_ENTRIES = 0) for its peak; (b) the same again
            from the run cache (93 hits,
            no slot loop, equal rows), then one corrupted entry (only it
            recomputed); (c) GIGA_GRID, 4 giga seeds x ECMP/AR (8
            points, 60 slots, two sub-batches of 4 lanes), each row
            equal to its point alone, with the same walls, peak memory,
            points/s against one at a time, and the same pipeline with
            the host prep on a worker thread, in turns.
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
  serve     the model forward and the serving engine
            (`repro_torch.train.ServeEngine`, SERVE_RUNS): llama3-8b at
            full width (32 layers, d_model 4096, GQA 32/8, head_dim 128,
            vocab 128,256; 8.03 B float32 parameters drawn on the card
            from a seed) serving 6 requests of 64-512 prompt tokens and
            16 new tokens through 4 slots, in bfloat16 and again with
            float32 activations, and gemma3-12b at full width cut to its
            first period (5 local layers of window 1024 and a global
            one, head_dim 256, vocab 262,144; prompts of 2,048 and 1,500
            tokens, so the rings wrap); every standard-attention layer
            launches flash_attention once an admission and
            decode_attention once a step (asserted), and every prefill's
            and step's logits are held, teacher-forced, to the same
            engine on the plain attention versions (SERVE_RUNS' tol);
            prefill and decode walls, tokens/s, peak memory and a
            profiled decode step; the reduced config of each family
            (SERVE_REDUCED: MoE, SSM, hybrid, MLA, a vision frontend) at
            head_dim 64 in float32, its CUDA forward against the CPU
            forward within ATTN_TOL; `decode_attention_bshd` at the
            serve run's shapes against its plain version and SDPA.
  train     the training path (`repro_torch.train.Trainer`,
            TRAIN_RUN): spx-100m at full width and depth (12 layers,
            d_model 768, GQA 12/4, head_dim 64, vocab 32,768, 126 M
            float32 parameters drawn on the card) trains 20 steps of
            8 x 1,024 tokens with the bf16 weight cast, plane 2 failing
            at step 5 and healing at step 12 and a checkpoint at step
            10; each step launches flash_attention and
            flash_attention_bwd once a layer (asserted), every
            flash_attention_bwd call of one step is held to
            `ref.flash_attention_bwd_ref` on its own inputs (BWD_TOL of
            each gradient's largest magnitude), the loss is finite and
            falls (the weights before and after the run on the first
            step's batch; a batch no step trains on is printed, not
            held: on uniform tokens it moves by noise alone), planes up
            and the recovery record equal a
            CPU `FailoverController`'s, the step-10 checkpoint restores
            bit-equal and steps 10-19 run again bit-equal to the first
            run; median step time, tokens/s,
            peak memory and the device's busy share of a profiled step.
            llama3-8b at full width cut to TRAIN_LLAMA_LAYERS layers
            (remat "full": two forward launches a layer a step) trains
            3 steps of 1 x 2,048 tokens (peak memory).  One float32
            step of spx-100m through the kernels against the same step
            on the plain attention versions (loss 1e-4, grad norm 1e-3
            relative; bf16's difference printed beside it).
  dp        data parallelism at world 1 over an NCCL process group
            (a `file://` store in a temporary directory; its mesh from
            `launch.mesh.make_mesh_for(1, 1)`; no fallback): the train
            run's step-1 gradients through `plane_allreduce` in each
            mode (DP_PLANES, the Trainer's key for that step): psum and
            rs_ag bit-equal to the gradients, rs_ag_int8 one
            int8_encode and one int8_decode launch a compressed chunk
            (asserted), each held to its plain version on its own
            inputs bit for bit, every element within one code step of
            its gradient row; each mode's wall (CUDA events, median of
            DP_REPEATS calls; one call profiled: the device's busy
            share) and the codec kernels at every chunk shape against
            their plain versions and the bound; spx-100m's step
            over the world-1 mesh bit-equal to the step without one;
            then llama3-8b at full width cut as TRAIN_LLAMA under remat
            "full", "dots" and "kv" (REMAT_RUNS): TRAIN_LLAMA's 3 steps
            each (step ms, the first a warm-up; peak memory;
            flash_attention twice a layer a step, asserted), then every
            recomputed flash forward launch bit-equal
            to one of the first forward's, and the first batch's
            gradients against "full"'s (bit-equal, else within
            BWD_TOL; printed which).  A run of more ranks needs a
            machine with more cards: NCCL refuses two ranks on one
            device; the CPU tests carry 2, 4 and 8 ranks over gloo.
  tp        tensor parallelism and FSDP at world 1 over an NCCL process
            group (`launch.mesh.make_mesh_for(1, 1)`: data 1, model 1;
            contexts from `launch.specs.make_ctx`, FSDP's over "data"
            with `make_rules("data")`), so every TP and FSDP collective
            runs on the card as a copy and the rank holds `shard_params`
            of the weights: phi3.5-moe at full width cut to TP_MOE's 2
            layers (bf16 activations) takes a forward loss over 2,048
            tokens (MoE "a2a" mode) and serves two 512-token prompts
            with 16 greedy decode steps through `ServeEngine` at batch
            2; deepseek-v2 (MLA) at full width cut to its dense prefix
            layer and one MoE layer (TP_MLA: d_model 5,120, 128 heads,
            q_lora 1,536, kv_lora 512, 160 experts top-6 plus 2 shared,
            vocab 102,400; 5.36 B float32 parameters) the same;
            mamba2-780m at full width and depth (TP_SSM: 48 layers,
            d_model 1,536, 48 SSM heads of 64, state 128) takes the
            first batch's gradients through `make_grad_fn` and two
            steps of 1 x 1,024 tokens through `make_train_step`, then
            the same serving and a decode step of each run under
            torch.profiler (the device's busy share, top kernels);
            llama3-8b at full width cut to 2 layers (remat "full")
            takes the first batch's gradients and two steps under TP
            and again under FSDP (FSDP_LLAMA); each run bit-equal to the
            same run without a mesh (loss and aux; logits and tokens;
            gradients, parameters, AdamW state and metrics), every
            flash forward, decode and flash backward launch held to its
            plain version (MLA and SSM layers launch none, asserted);
            loss, step, prefill and decode walls, peak memory and the
            collective calls a step.  A run of more ranks waits for a
            machine with more cards, as DP's does.
  profile   torch.profiler over 12 giga slots under AR and under ECMP,
            float64 and float32, and in float64 over giga_fat_tree under
            WAR and ECMP and over the giga point under failure reaction,
            eager and captured (the replays): the device busy share and
            the kernels that take the device time.

Each phase from `registry` to `packets` starts from an empty graph
cache (`netsim.graph.clear_graph_cache`), and every peak-memory
reading from one (`reset_peak`), so first runs capture and peaks are
those of the runs measured.

Prints the card's name and power limit first, a `{"kernels": [...]}`
line before the last, and `{"ok": true, "device": {...}}` last.  On an
NVIDIA H100 80GB HBM3 at 700 W the whole script took 611.6 s with the
build before the tp phase carried MLA, SSM and FSDP (that phase 26.3 s),
and 830.4 s after, on a host whose dp phase ran psum at 55.9 ms a call
against 8.2 ms on an earlier one (the tp phase 94.9 s, within 90 s of
its 26.3); the limit is 1,200 s.
`--report PATH` also writes the full report (every kernel row, the
registry, scale, packet and profile results) as JSON.  Run from
anywhere but a checkout of the repo (no `src/repro_torch` beside it),
it exits 2 and prints no result, as it does without a GPU.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import re
import subprocess
import sys
import time
from contextlib import contextmanager
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
            ("cascading_spine_loss", "ecmp"), ("bisection_fat_tree", None),
            ("ft_cross_pod_all2all", None),
            ("ft_core_failure_resiliency", None),
            ("ft_core_failure_resiliency", "ecmp"),
            ("reroute_random_failures", None), ("poisson_flap_storm", None),
            ("reroute_random_failures_ft", None))
# hand-written kernel launches per slot on each (fabric, routing) path
# (bottleneck: one grouped launch scales every link of a slot, both
# stages of a fat tree included; queue_update: one grouped launch
# integrates its up and down links, of both stages on a fat tree)
AR_SLOT = {"plane_split": 1, "pair_fractions": 1, "bottleneck": 1,
           "queue_update": 1, "nic_update": 1}
ECMP_SLOT = {"plane_split": 1, "bucket_load_bottleneck": 1,
             "bottleneck": 1, "queue_update": 1, "nic_update": 1}
PER_SLOT = {(kind, routing): ECMP_SLOT if routing == "ecmp" else AR_SLOT
            for kind in ("leaf_spine", "fat_tree")
            for routing in ("ar", "war", "ecmp")}
# under sparse aggregation one segment_sum launch sums a slot's access,
# pair (AR/WAR) or link (ECMP, in place of bucket_load_bottleneck) loads
# and scales the access links (and under ECMP the fabric links: no
# bottleneck launch there; AR/WAR scale their fabric links in one)
SPARSE_SLOT = {"plane_split": 1, "segment_sum": 1, "queue_update": 1,
               "nic_update": 1}
# the giga point on a 3-tier fat tree of the same bisection per plane:
# 16 pods of 16 leaves with 16 aggs on 1.0 links, and 32 cores on 8.0
# pod links (16 leaves x 16 aggs x 1.0 = 32 cores x 8.0 a pod)
GIGA_FAT_TREE = dict(kind="fat_tree", n_pods=16, n_aggs=16, n_cores=32,
                     link_cap=1.0, core_link_cap=8.0)
# beyond giga: giga_fabric_storage's spec on 512 leaves x 32 hosts, 32
# spines and 4 planes (16,384 hosts, storage fanout 25: 409,600 flows),
# the size sparse aggregation exists for
GIGA_BEYOND = dict(n_leaves=512, hosts_per_leaf=32, n_spines=32,
                   n_planes=4)
BEYOND_CPU_SLOTS = 10
# training-step schedules at full width on the giga leaf-spine: a model
# at its published dims (reduced=False) over dp x tp=8 x pp=2 ranks, two
# steps, with rank 0 losing plane 1 across step 1's gradient-sync window
# (`flap`, [start, stop)); the windows are plan_schedule's at `slot_us`
# (llama3-8b: fwd 14, bwd 28, sync 800, period 844; phi3.5-moe: 139,
# 278, 406, period 825)
GIGA_TRAIN = {
    "giga_train_llama3_8b": dict(model="llama3-8b", dp=256, slot_us=100.0,
                                 slots=1696, flap=(886, 1686)),
    "giga_train_phi35_moe": dict(model="phi3.5-moe-42b-a6.6b", dp=32,
                                 slot_us=1000.0, slots=1658,
                                 flap=(1242, 1648))}
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
    # not a TPU kernel: XLA's segment_sum (segment_load, and
    # segment_load_chunk at :151) in the reference
    "segment_sum": "src/repro/kernels/link_load.py:141",
    "flash_attention_bwd": "src/repro/kernels/flash_attention.py:26 (its "
                           "gradient; reference: autodiff of "
                           "models/attention.py:62)",
}
# fabric shapes the main path hands the kernels
SHAPES = {"fig9": dict(F=2496, P=1, L=8, S=8, H=64),
          "giga": dict(F=102400, P=2, L=256, S=16, H=4096)}
# the giga fat tree's: L leaves, A aggs a pod, J cores, pods, H hosts
FAT_TREE_SHAPE = dict(P=2, L=256, A=16, J=32, pods=16, H=4096)
# further (flows, planes) of plane_split, so that every instance of the
# planes the registry uses (P = 1, 2, 4) runs on the card: fig12's
# single flow on 4 planes, and 4 planes at giga's flow count
PLANE_SHAPES = {"fig12": dict(F=1, P=4), "giga x4": dict(F=102400, P=4)}
# scenarios whose ECMP plans the bucket_load_bottleneck cases use
ECMP_SHAPES = {"fig11": "fig11_degraded_leaf", "giga": "giga_fabric_storage",
               "giga fat tree": "giga_fat_tree"}
# lanes of the lane-axis bucket_load_bottleneck cases and of the giga
# batch (seeds 0..LANES-1 of one point)
LANES = 4
# flows a chunk of the segment_sum fold case and of the sparse phase's
# chunked giga run (102,400 flows: 7 chunks, a tail of 4,096)
SEG_CHUNK = 16384
# the trace phase: fig12's plane flap at full length (600 slots) must
# give the paper's signature; the giga point records every TRACE_EVERY
# slots
TRACE_EVERY = 10
# the batch phase: seeds of one registry point in one batch, and the
# megabatch grid (two flow buckets: 60 -> 64 and 30 -> 32 flows; the
# second scenario's points traced)
BATCH_POINT = ("fig11_degraded_leaf", "ecmp")
# two batches of one structure (their lanes' seeds), outstanding together
ALIAS_BATCHES = ("reroute_random_failures", 120, ((0, 1), (2, 3)))
BATCH_SEEDS = 16
GRID = dict(names=("flap_during_incast", "staggered_incast_bursts"),
            routings=("ar", "war", "ecmp"), nics=("spx", "dcqcn"),
            seeds=(0, 1, 2, 3), traced="staggered_incast_bursts")
# the sweep phase: every registered experiment at its registered size;
# the fat-tree and reaction studies also on the CPU path; a grid of
# giga seeds x routing; rows held to their points run alone within
# SWEEP_RTOL; the training-step study's rows also to its signature
SWEEP_CPU = ("topo_kind_resiliency", "reroute_reaction")
SWEEP_RTOL = 1e-12
GIGA_GRID = dict(seeds=(0, 1, 2, 3), routings=("ecmp", "ar"))
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
                  "nic_update": 20, "jsq_route": 11, "plb_select": 14,
                  "segment_sum": 1}
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
    """The port's registry spec, or one of the giga variants this script
    builds (`giga_fat_tree`, `giga_fabric_storage_reroute`, `giga_beyond`
    and the GIGA_TRAIN schedules), with `routing` overridden if given."""
    from repro_torch.scenarios import get_scenario
    from repro_torch.scenarios.spec import (FaultSpec, ScenarioSpec,
                                            ScheduleSpec, SimSpec,
                                            TenantSpec, WorkloadSpec)
    if name in GIGA_TRAIN:
        g = GIGA_TRAIN[name]
        start, stop = g["flap"]
        spec = ScenarioSpec(
            name=name,
            description=f"{g['model']} at its published dims, dp "
                        f"{g['dp']} x tp 8 x pp 2, on the giga leaf-spine; "
                        "rank 0 loses plane 1 across step 1's sync window",
            topo=get_scenario("giga_fabric_storage").topo,
            tenants=(TenantSpec("main"),),
            workloads=(WorkloadSpec("schedule", schedule=ScheduleSpec(
                model=g["model"], dp=g["dp"], tp=8, pp=2, steps=2,
                microbatches=8, tokens_per_rank=8192, line_rate_gbps=400.0,
                reduced=False)),),
            faults=(FaultSpec("access_kill", start_slot=start,
                              stop_slot=stop, plane=1, host=0),),
            sim=SimSpec(slots=g["slots"], slot_us=g["slot_us"], seed=21))
    elif name == "giga_fat_tree":
        spec = get_scenario("giga_fabric_storage")
        spec = dataclasses.replace(
            spec, name=name,
            topo=dataclasses.replace(spec.topo, **GIGA_FAT_TREE))
    elif name == "giga_beyond":
        spec = get_scenario("giga_fabric_storage")
        spec = dataclasses.replace(
            spec, name=name,
            topo=dataclasses.replace(spec.topo, **GIGA_BEYOND))
    elif name == "giga_fabric_storage_reroute":
        # the registry's failure reaction: backup failover after 2 slots
        spec = dataclasses.replace(
            get_scenario("giga_fabric_storage"), name=name,
            reaction=get_scenario("reroute_random_failures").reaction)
    else:
        spec = get_scenario(name)
    return spec if routing is None else spec.with_sim(routing=routing)


def label(name: str, routing=None) -> str:
    return name if routing is None else f"{name}[{routing}]"


def first_slots(c, slots: int):
    """The compiled scenario `c` run for its first `slots` slots only:
    its spec's horizon, its demand timeline and its fault transitions cut
    there.  A training-step schedule is laid out for its whole horizon
    (`plan_schedule` refuses a shorter one), so its flows stay as they
    are and the steps past the cut never start."""
    pm = None if c.phase_mult is None else c.phase_mult[:slots]
    return dataclasses.replace(
        c, spec=c.spec.with_sim(slots=slots),
        cfg=dataclasses.replace(c.cfg, slots=slots), phase_mult=pm,
        fault_slots=tuple(f for f in c.fault_slots if f[0] < slots))


def fail(msg: str) -> None:
    raise AssertionError(msg)


def reset_peak() -> None:
    """Empty the graph cache, then restart the peak-memory count, so a
    peak is that of the runs measured from a cold cache (as every run
    was before the cache), not of entries that earlier runs left."""
    import torch
    from repro_torch.netsim import graph
    graph.clear_graph_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


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
         rtol=None, loose=None, summary=False, extra=None,
         width=None, same=None, plain_events=False) -> dict:
    """One kernel-vs-plain comparison.  The kernel must equal `plain`
    bit for bit unless `rtol` is set (then: relative error); `loose` is
    a further (plain call, rtol) the result must meet; `same` a further
    call whose result it must equal bit for bit; `summary` marks the
    case reported in the `{"kernels": [...]}` line; `extra` names
    further calls to time beside the kernel; `width` is an ECMP plan's
    padded bucket width, printed beside its time; `plain_events` times
    the plain version between CUDA events (`event_ms`) where it reads
    the device on the host and cannot be captured."""
    return dict(kernel=kernel, mode=mode, shape=shape,
                dtype=str(dtype).split(".")[1], run=run, plain=plain,
                bytes=nbytes, ops=ops, rtol=rtol, loose=loose,
                summary=summary, extra=extra or {}, width=width, same=same,
                plain_events=plain_events)


# flash_attention kernels (forward, and the backward's dK/dV and dQ)
# and the tensor-core instruction each must hold in its SASS: wgmma
# (HGMMA) in the bf16 forward, mma.sync (HMMA) in the others; the
# mangled template arguments before the head_dim
SASS_MMA = {"bf16": ("flash_attention_wgmma_kernel", "HGMMA", ""),
            "float32": ("flash_attention_tf32_kernel", "HMMA", ""),
            "bf16 dK/dV": ("flash_bwd_dkdv_kernel", "HMMA",
                           "13__nv_bfloat16"),
            "bf16 dQ": ("flash_bwd_dq_kernel", "HMMA", "13__nv_bfloat16"),
            "float32 dK/dV": ("flash_bwd_dkdv_kernel", "HMMA", "f"),
            "float32 dQ": ("flash_bwd_dq_kernel", "HMMA", "f")}


def sass_mma(sass: str) -> str:
    """The tensor-core instructions of each flash_attention kernel in
    `sass` (the built library as `cuobjdump -sass` lists it), by dtype
    and head_dim; fails if a kernel is missing or has none."""
    out = []
    for dname, (kernel, instr, targs) in SASS_MMA.items():
        counts, head_dim = {}, None      # head_dim -> instruction lines
        for line in sass.splitlines():
            if "Function :" in line:
                m = re.search(kernel + "I" + targs + r"Li(\d+)E", line)
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


def fat_tree_cases(dtype, seed: int) -> list:
    """The fat-tree slot's widened groups and its path split, at the
    giga fat tree's shapes (FAT_TREE_SHAPE), inputs drawn from numpy with
    `seed`: pair_fractions over 32 cores, bottleneck as the slot's
    launch of six pairs (stage A up and down, stage B up and down, both
    access directions) and queue_update as its launch of four entries
    (both stages, both directions)."""
    import numpy as np
    import torch
    from repro_torch.kernels import jsq_route, link_load, queue_ecn, ref

    rng = np.random.default_rng(seed)
    P, L, A, J, pods, H = (FAT_TREE_SHAPE[k]
                           for k in ("P", "L", "A", "J", "pods", "H"))
    isz = torch.empty((), dtype=dtype).element_size()

    def f(*sh, hi=1.0, zero_frac=0.0):
        a = rng.uniform(0.0, hi, sh)
        if zero_frac:
            a[rng.random(sh) < zero_frac] = 0.0
        return torch.tensor(a, dtype=dtype, device="cuda")

    links = ((P, L, A), (P, A, L), (P, pods, J), (P, pods, J))
    q, cap = f(P, L, L, J, hi=20.0), f(P, L, L, J, zero_frac=0.1)
    w = cap * f(P, L, L, J)
    pairs = tuple((f(*sh, zero_frac=0.1), f(*sh, hi=2.0))
                  for sh in links + ((H, P), (H, P)))
    entries = tuple((f(*sh, hi=70.0), f(*sh, hi=2.0), f(*sh, zero_frac=0.1))
                    for sh in links)
    n_pair = P * L * L * J
    n_b = sum(c.numel() for c, _ in pairs)
    n_q = sum(e[0].numel() for e in entries)
    fl = FLOPS_PER_ELEM
    what = "giga fat tree"
    return [
        case("pair_fractions", "", what, dtype,
             lambda: jsq_route.pair_fractions(q, cap, w, nbins=16,
                                              temperature=0.25),
             lambda: ref.pair_score_softmax_ref(q, cap, w, nbins=16,
                                                temperature=0.25),
             4 * n_pair * isz, n_pair * fl["pair_fractions"],
             rtol=1e-12 if dtype == torch.float64 else 1e-6),
        case("bottleneck", "slot x6", what, dtype,
             lambda: link_load.bottleneck_many(pairs),
             lambda: tuple(ref.bottleneck_ref(c, ld) for c, ld in pairs),
             3 * n_b * isz, n_b * fl["bottleneck"]),
        case("queue_update", "slot x4", what, dtype,
             lambda: sum(queue_ecn.queue_update_many(entries, q_cap=64.0),
                         ()),
             lambda: sum((ref.queue_update_ref(*e, q_cap=64.0)
                          for e in entries), ()),
             5 * n_q * isz, n_q * fl["queue_update"])]


def ecmp_plan(sname: str):
    """(ECMP link-bucket plan, stacked link capacities) of the last
    capacity segment of `ECMP_SHAPES[sname]` under ECMP, from the
    port's own host prep with dense aggregation forced (the giga shapes
    run sparse by their own mode), on the card."""
    import torch
    from repro_torch.netsim import engine
    from repro_torch.scenarios import compile_scenario
    c = compile_scenario(scenario(ECMP_SHAPES[sname], "ecmp"))
    with agg_env("dense"):
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
        extra={"gathered_sum_ms": lambda: g.sum(-1)},
        width=C)]


def lane_plans(sname: str, lanes: int = LANES):
    """(flows, (B, P, R, C) plans, (B, P, R) capacities) of the last
    capacity segment of `lanes` seeds of `ECMP_SHAPES[sname]` under
    ECMP, as `engine.prepare_batch` stacks them for one batched slot
    (dense aggregation forced)."""
    import torch
    from repro_torch.netsim import engine
    from repro_torch.scenarios import compile_scenario
    points = [compile_scenario(scenario(ECMP_SHAPES[sname], "ecmp")
                               .with_sim(seed=s)) for s in range(lanes)]
    with agg_env("dense"):
        _, _, fas, ops = engine.prepare_batch(points, "cuda", torch.float64)
    return len(fas[0]), ops.ecmp_load[-1], ops.link_cap[-1]


def lane_ecmp_cases(sname: str, plan, cap64, F: int, dtype, seed: int):
    """bucket_load_bottleneck over a lane axis (B seeds' plans in one
    launch): bit-equal to the plain version of the batch (ordered) and
    to B single-lane launches; timed beside one single-lane launch and
    the B single-lane launches."""
    import numpy as np
    import torch
    from repro_torch.kernels import link_load, ref

    rng = np.random.default_rng(seed)
    B, P, R, C = plan.shape
    rate = rng.uniform(0.0, 1.0, (B, F, P))
    rate[rng.random((B, F, P)) < 0.1] = 0.0
    rate = torch.tensor(rate, dtype=dtype, device="cuda")
    cap = cap64.to(dtype)
    isz = rate.element_size()

    def one(b):
        return link_load.bucket_load_bottleneck(rate[b], plan[b], cap[b])

    def singles():
        outs = [one(b) for b in range(B)]
        return tuple(torch.stack(o) for o in zip(*outs))

    return [case(
        "bucket_load_bottleneck", f"{B} lanes", sname, dtype,
        lambda: link_load.bucket_load_bottleneck(rate, plan, cap),
        lambda: ref.load_bottleneck_ref(rate, plan, cap, ordered=True),
        plan.numel() * 4 + rate.numel() * isz + 3 * B * P * R * isz,
        int((plan < F).sum()) + 4 * B * P * R,
        extra={"one_lane_ms": lambda: one(0),
               f"{B}_single_lane_launches_ms": singles},
        width=C, same=singles)]


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


def segment_plans():
    """The giga point's sparse plans from the port's own host prep, on
    the card: the access plan (src host x plane: 8,192 buckets over
    204,800 entries), the ECMP link plan of the last capacity segment
    (up and down, 8,192 buckets each), the AR pair plan (plane x leaf
    pair: 131,072 buckets), the link plans of LANES seeds stacked as
    one batch's, the access plan in chunks of SEG_CHUNK flows, and the
    skewed plans of `giga_train_phi35_moe` (its AR pair plan: 1,088 of
    131,072 buckets hold 33-80 entries, the rest none; its access plan:
    1,024 of 8,192 buckets hold 66)."""
    import numpy as np
    import torch
    from repro_torch.netsim import engine
    from repro_torch.scenarios import compile_scenario

    def last(plan):
        return plan._replace(offsets=plan.offsets[-1],
                             entries=plan.entries[-1])

    with agg_env("sparse"):
        _, fa, ops = engine.prepare(compile_scenario(
            scenario("giga_fabric_storage")), "cuda", torch.float64)
        _, _, ops_ar = engine.prepare(compile_scenario(
            scenario("giga_fabric_storage", "ar")), "cuda", torch.float64)
        points = [compile_scenario(scenario("giga_fabric_storage")
                                   .with_sim(seed=s)) for s in range(LANES)]
        _, _, _, bops = engine.prepare_batch(points, "cuda", torch.float64)
    _, fa_moe, ops_moe = engine.prepare(compile_scenario(
        scenario("giga_train_phi35_moe")), "cuda", torch.float64)
    F, P = len(fa), ops.up.shape[1]
    keys = fa.src[:, None] * P + np.arange(P)[None, :]
    nc = -(-F // SEG_CHUNK)
    chunked = engine._csr([(np.arange(F), keys)],
                          ops.sparse.src.offsets.numel() - 1, SEG_CHUNK, nc)
    return dict(F=F, P=P, access=ops.sparse.src, dst=ops.sparse.dst,
                link=last(ops.sparse.link), pair=ops_ar.sparse.pair,
                lanes=last(bops.sparse.link),
                fold=chunked._replace(
                    offsets=torch.as_tensor(chunked.offsets, device="cuda"),
                    entries=torch.as_tensor(chunked.entries, device="cuda")),
                chunks=nc, moe=dict(F=len(fa_moe), P=ops_moe.up.shape[1],
                                    pair=ops_moe.sparse.pair,
                                    access=ops_moe.sparse.src))


def bucket_of(plan, n_vals: int, families: int = 1):
    """Each value's bucket under a one-family plan (`families` > 1:
    the plan's entries family after family, each family listing every
    value once): the keys an `index_add_` takes, one (n_vals,) index
    per family."""
    import torch
    counts = (plan.offsets[1:] - plan.offsets[:-1]).long()
    bucket = torch.repeat_interleave(
        torch.arange(counts.numel(), device=counts.device), counts)
    out = []
    for f in range(families):
        sel = slice(f * n_vals, (f + 1) * n_vals)
        key = torch.empty(n_vals, dtype=torch.long, device=counts.device)
        key[plan.entries[sel].long()] = bucket[sel]
        out.append(key)
    return out


def segment_cases(plans: dict, dtype, seed: int) -> list:
    """segment_sum at the giga shapes, bit-equal to its plain version:
    the access plan alone (the summary row: the library call is one
    `index_add_` over the same values and keys, which keeps no order),
    the ECMP link plan and the pair plan alone, a slot's grouped launch
    (both access sums and the link sums), the same launch with the
    bottleneck epilogue (access caps on both access sums, link caps on
    the link sums; against `ref.bottleneck_ref` of the plain sums),
    LANES seeds' link plans in one launch, a fold over chunks of
    SEG_CHUNK flows (a tail included) equal to one call, and the skewed
    pair and access plans of `giga_train_phi35_moe`."""
    import numpy as np
    import torch
    from repro_torch.kernels import link_load, ref
    from repro_torch.netsim import engine

    rng = np.random.default_rng(seed)
    F, P = plans["F"], plans["P"]
    isz = torch.empty((), dtype=dtype).element_size()

    def rates(*lead):
        a = rng.uniform(0.0, 1.0, lead + (F, P))
        a[rng.random(lead + (F, P)) < 0.1] = 0.0
        return torch.tensor(a, dtype=dtype, device="cuda")

    offered, fabric, batch = rates(), rates(), rates(LANES)

    def nbytes(items):
        """Each plan's offsets and entries and each value read once,
        each sum written once."""
        n, seen = 0, set()
        for v, p in items:
            K = p.offsets.numel() - 1
            n += 4 * (K + 1 + p.entries.numel()) + K * isz
            if id(v) not in seen:
                seen.add(id(v))
                n += v.numel() * isz
        return n

    def plain(items):
        return tuple(ref.segment_sum_ref(v, p.offsets, p.entries)
                     for v, p in items)

    def library(v, keys, K):
        """One `index_add_` a family (unordered: a yardstick)."""
        flat = v.reshape(-1)
        return lambda: [v.new_zeros(K).index_add_(0, k, flat)
                        for k in keys]

    out = []
    moe = plans["moe"]
    F_moe, P_moe = moe["F"], moe["P"]
    a = rng.uniform(0.0, 1.0, (F_moe, P_moe))
    moe_rate = torch.tensor(a, dtype=dtype, device="cuda")
    singles = {"access": (offered, plans["access"], 1),
               "ecmp links": (fabric, plans["link"], 2),
               "pair": (fabric, plans["pair"], 1),
               "train_phi35_moe pair": (moe_rate, moe["pair"], 1),
               "train_phi35_moe access": (moe_rate, moe["access"], 1)}
    for name, (v, plan, fam) in singles.items():
        items = ((v, plan),)
        K = (plan.offsets.numel() - 1) // fam          # buckets a family
        keys = [k - f * K for f, k in enumerate(bucket_of(
            plan, v.numel(), fam))]
        out.append(case(
            "segment_sum", "", f"giga {name}", dtype,
            lambda items=items: link_load.segment_sum_many(items),
            lambda items=items: plain(items), nbytes(items),
            int(plan.entries.numel()),
            summary=name == "access" and dtype == torch.float64,
            extra={"library_ms": library(v, keys, K)}, plain_events=True))
    slot = ((offered, plans["access"]), (offered, plans["dst"]),
            (fabric, plans["link"]))
    out.append(case(
        "segment_sum", "slot x3", "giga ecmp", dtype,
        lambda: link_load.segment_sum_many(slot), lambda: plain(slot),
        nbytes(slot), sum(int(p.entries.numel()) for _, p in slot),
        plain_events=True))
    # the slot's launch with the bottleneck epilogue: each bucket's
    # scale min(1, cap / max(sum, eps)) beside its sum
    acc_cap = torch.tensor(rng.uniform(0.0, 4.0, plans["access"].offsets
                                       .numel() - 1), dtype=dtype,
                           device="cuda")
    link_cap = torch.tensor(rng.uniform(0.0, 8.0, plans["link"].offsets
                                        .numel() - 1), dtype=dtype,
                            device="cuda")
    caps = (acc_cap, acc_cap, link_cap)

    def scaled():
        sums, scales = link_load.segment_sum_many(slot, caps=caps)
        return sums + scales

    def scaled_plain():
        sums = plain(slot)
        return sums + tuple(ref.bottleneck_ref(c, s)
                            for c, s in zip(caps, sums))

    K_all = sum(int(p.offsets.numel()) - 1 for _, p in slot)
    out.append(case(
        "segment_sum", "slot x3 scaled", "giga ecmp", dtype, scaled,
        scaled_plain, nbytes(slot) + (acc_cap.numel() + link_cap.numel()
                                      + K_all) * isz,
        sum(int(p.entries.numel()) for _, p in slot)
        + K_all * FLOPS_PER_ELEM["bottleneck"], plain_events=True))
    lanes = ((batch, plans["lanes"]),)
    out.append(case(
        "segment_sum", f"{LANES} lanes", "giga ecmp links", dtype,
        lambda: link_load.segment_sum_many(lanes), lambda: plain(lanes),
        nbytes(lanes), int(plans["lanes"].entries.numel()),
        plain_events=True))
    nc, fold = plans["chunks"], plans["fold"]

    def folded():
        acc = None
        for c in range(nc):
            acc = link_load.segment_sum(
                offered[c * SEG_CHUNK:(c + 1) * SEG_CHUNK],
                engine._chunk_plan(fold, c, nc), acc=acc)
        return acc

    K = plans["access"].offsets.numel() - 1
    out.append(case(
        "segment_sum", f"fold of {nc} chunks", "giga access", dtype,
        folded, lambda: plain(((offered, plans["access"]),))[0],
        F * P * isz + 4 * (fold.offsets.numel() + fold.entries.numel())
        + (2 * nc - 1) * K * isz, int(fold.entries.numel()),
        plain_events=True))
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
    for sname in ("fig11", "giga"):
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
    # the giga fat tree's widened groups, path split and ECMP plan
    F, plan, cap = ecmp_plan("giga fat tree")
    for dtype in (torch.float32, torch.float64):
        cases += fat_tree_cases(dtype, seed=len(cases))
        cases += ecmp_cases("giga fat tree", plan, cap, F, dtype,
                            seed=len(cases))
    # bucket_load_bottleneck over a lane axis: LANES seeds' plans of the
    # giga point and of the giga fat tree in one launch
    for sname in ("giga", "giga fat tree"):
        F, plan, cap = lane_plans(sname)
        for dtype in (torch.float32, torch.float64):
            cases += lane_ecmp_cases(sname, plan, cap, F, dtype,
                                     seed=len(cases))
    # the flow-ordered segment sum of sparse aggregation
    plans = segment_plans()
    for dtype in (torch.float32, torch.float64):
        cases += segment_cases(plans, dtype, seed=len(cases))
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
                   bytes=c["bytes"], ops=c["ops"], width=c["width"])
        if c["same"] is not None:
            other, _ = max_errors(got, c["same"]())
            if other != 0.0:
                fail(f"{what}: max abs err {other:.3g} against the "
                     "single-lane launches, expected bit-equal")
        if c["loose"] is not None:
            plain, rtol = c["loose"]
            _, loose_rel = max_errors(got, plain())
            if loose_rel > rtol:
                fail(f"{what}: rel err {loose_rel:.3g} > {rtol} against "
                     "the default plain version")
            row["default_plain_rel_err"] = loose_rel
        if mode not in ("dcqcn", "agg", "swlb"):
            ms = graph_ms(c["run"])
            plain_ms = (event_ms(c["plain"]) if c["plain_events"]
                        else graph_ms(c["plain"]))
            bytes_ms = c["bytes"] / HBM_BYTES_PER_S * 1e3
            ops_ms = c["ops"] / PEAK_FLOPS[dname] * 1e3
            row.update(ms=ms, plain_ms=plain_ms,
                       bound_ms=max(bytes_ms, ops_ms),
                       bound_by="bytes" if bytes_ms >= ops_ms
                       else "operations")
            row.update({k: graph_ms(fn) for k, fn in c["extra"].items()})
            print(f"kernel {what}: ms={ms:.6f} plain_ms={plain_ms:.6f} "
                  f"bound_ms={row['bound_ms']:.6f} ({row['bound_by']}) "
                  + (f"plan_width={c['width']} " if c["width"] else "")
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


# (scenario, routing, slots) the sync phase runs: AR/WAR and ECMP on
# both fabrics, a reaction run past its fault and its detection, and
# the training-step schedules past their phase boundaries and the flap
# (a schedule's run cut to its first slots, `first_slots`)
SYNC_CASES = (("fig11_degraded_leaf", None, 24),
              ("fig11_degraded_leaf", "ecmp", 24),
              ("ft_core_failure_resiliency", None, 110),
              ("ft_core_failure_resiliency", "ecmp", 110),
              ("reroute_random_failures_ft", None, 110),
              ("reroute_random_failures", "war", 110),
              ("train_step_flap", None, 130),
              ("train_step_flap_moe", "ecmp", 250))
# (scenario, routing, slots, flow chunk) the sync phase runs under sparse
# aggregation: one pass on a leaf-spine under ECMP, and a fat tree under
# WAR in chunks of 17 flows (64 flows: 4 chunks, a tail)
SYNC_SPARSE = (("fig11_degraded_leaf", "ecmp", 24, None),
               ("ft_core_failure_resiliency", "war", 110, 17))


def sync_loop(name: str, routing, slots: int) -> None:
    """One SYNC_CASES run: its eager loop and the replays of its captured
    one under CUDA sync debug mode "error", equal to each other."""
    import torch
    from repro_torch.netsim import engine
    from repro_torch.scenarios import compile_scenario

    spec = scenario(name, routing)
    if any(w.kind == "schedule" for w in spec.workloads):
        c = first_slots(compile_scenario(spec), slots)
    else:
        c = compile_scenario(spec.with_sim(slots=slots))
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
    captured = engine._results(cfg, loop.carry, *loop.series)
    if not all(bool(o.isfinite().all()) for o in eager + captured
               if o.is_floating_point()):
        fail("sync phase: non-finite output")
    if not all(torch.equal(a, b) for a, b in zip(captured, eager,
                                                 strict=True)):
        fail("sync phase: the captured loop differs from the eager one")
    mode = "" if cfg.agg_mode == "dense" else f", {cfg.agg_mode}" + (
        f" in chunks of {cfg.flow_chunk}" if cfg.flow_chunk else "")
    print(f"sync: {label(name, routing)} ({cfg.kind}, {cfg.routing}"
          f"{', reaction' if cfg.react else ''}"
          f"{', schedule' if cfg.n_phases else ''}{mode}, "
          f"{len(loop.graphs)} graph(s)): eager slot loop and captured "
          "replays ran with sync debug mode 'error'", flush=True)


def sync_phase() -> None:
    """No slot loop waits for the device, on either fabric, under AR/WAR
    or ECMP, with or without failure reaction, under sparse aggregation
    and in flow chunks: the eager loop, and the replays of the captured
    one (its capture, which synchronises on entry, runs before the
    check)."""
    import torch
    from repro_torch.netsim import engine
    from repro_torch.scenarios import compile_scenario

    for name, routing, slots in SYNC_CASES:
        sync_loop(name, routing, slots)
    for name, routing, slots, chunk in SYNC_SPARSE:
        with agg_env("sparse", chunk):
            sync_loop(name, routing, slots)
    # a batch over a lane axis with a trace: its record rows come from a
    # device table, never from the host
    from repro_torch.trace import TraceSpec
    trace = TraceSpec(enabled=True, every=3)
    points = [compile_scenario(scenario("reroute_random_failures", "war")
                               .with_sim(slots=110, seed=s, trace=trace))
              for s in range(3)]
    cfg, trace, _, ops = engine.prepare_batch(points, "cuda", torch.float64)
    loop = engine.slot_loop(cfg, ops, trace=trace)
    loop.capture()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager = engine._simulate(cfg, ops, trace=trace, _eager=True)
        loop.replay()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    captured = engine._loop_results(cfg, loop)
    if not all(torch.equal(a, b) for a, b in zip(captured, eager,
                                                 strict=True)):
        fail("sync phase: the captured batch differs from the eager one")
    print(f"sync: a batch of {len(points)} traced reroute_random_failures"
          f"[war] points ({len(loop.graphs)} graph(s)): eager slot loop and "
          "captured replays ran with sync debug mode 'error'", flush=True)


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


def slot_launches(kind: str, routing: str, slots: int,
                  agg_mode: str = "dense", chunks: int = 0,
                  host_bw: bool = False) -> dict:
    """Hand-written launches of `slots` slots of one path: PER_SLOT under
    dense aggregation; under sparse SPARSE_SLOT (with pair_fractions and
    bottleneck under AR/WAR, and one more segment_sum for a trace's
    host_bw); in
    `chunks` chunks the plane split twice a chunk and segment_sum and
    nic_update once a chunk."""
    if agg_mode == "dense":
        per = PER_SLOT[kind, routing]
    else:
        per = dict(SPARSE_SLOT)
        if routing != "ecmp":
            per.update(pair_fractions=1, bottleneck=1)
        if chunks:
            per.update(plane_split=2 * chunks, segment_sum=chunks,
                       nic_update=chunks)
        per["segment_sum"] += int(host_bw)
    return {k: slots * n for k, n in per.items()}


def run_launches(c, slots=None, trace=None, dtype=None) -> dict:
    """`slot_launches` of compiled scenario `c` (its first `slots`
    slots) on the path the engine picks for it now: its aggregation
    mode and flow chunks (`engine._prepared`, which reads the
    REPRO_JX_AGG / REPRO_JX_FLOW_CHUNK overrides)."""
    import torch
    from repro_torch.netsim import engine
    cfg, fa, *_ = engine._prepared(c, dtype or torch.float64)
    chunks = -(-len(fa) // cfg.flow_chunk) if cfg.flow_chunk else 0
    host_bw = trace is not None and trace.enabled and \
        "host_bw" in trace.active_fields()
    return slot_launches(cfg.kind, cfg.routing,
                         cfg.slots if slots is None else slots, cfg.agg_mode,
                         chunks, host_bw and cfg.agg_mode == "sparse")


@contextmanager
def agg_env(mode=None, chunk=None, compact=None):
    """The block with REPRO_JX_AGG set to `mode`, REPRO_JX_FLOW_CHUNK to
    `chunk` and REPRO_JX_COMPACT to 1 when `compact` (None: unset, the
    engine's own choice), restored after."""
    import os
    want = {"REPRO_JX_AGG": mode, "REPRO_JX_FLOW_CHUNK":
            None if chunk is None else str(chunk),
            "REPRO_JX_COMPACT": "1" if compact else None}
    prev = {k: os.environ.get(k) for k in want}
    try:
        for k, v in want.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


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
    assert_blackholes(spec, c, ref, got)


def assert_blackholes(spec, c, ref, got) -> None:
    """Under failure reaction: the per-slot blackhole series within 1e-5,
    `reaction_slots` equal and `blackholed_bytes` within 1e-5; without
    one, no series on either side."""
    import numpy as np
    from repro_torch.scenarios import distill_metrics
    if (ref.blackhole_timeline is None) != (got.blackhole_timeline is None):
        fail(f"{spec.name}: a blackhole series on one side only")
    if ref.blackhole_timeline is None:
        return
    np.testing.assert_allclose(got.blackhole_timeline,
                               ref.blackhole_timeline, atol=TOL, rtol=TOL)
    m_ref, m_got = (distill_metrics(spec, c, r) for r in (ref, got))
    if m_got.reaction_slots != m_ref.reaction_slots or \
            abs(m_got.blackholed_bytes - m_ref.blackholed_bytes) > TOL:
        fail(f"{spec.name}: reaction columns {m_got.blackholed_bytes}, "
             f"{m_got.reaction_slots} vs {m_ref.blackholed_bytes}, "
             f"{m_ref.reaction_slots}")


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
                       slot_launches(spec.topo.kind, spec.sim.routing,
                                     spec.sim.slots), total)
        cpu = compile_scenario(spec).run(device="cpu")
        assert_parity(spec, c, cpu, gpu)
        m = distill_metrics(spec, c, gpu)
        # the golden rows are the registry's own specs
        if routing is None:
            assert_golden(name, m, golden)
        report["registry"].append(dict(
            scenario=what, kind=spec.topo.kind, slots=spec.sim.slots,
            flows=len(c.flows), wall_s=wall, mean_goodput=m.mean_goodput,
            blackholed_bytes=m.blackholed_bytes,
            reaction_slots=m.reaction_slots))
        react = (f"; blackholed_bytes={m.blackholed_bytes!r} "
                 f"reaction_slots={m.reaction_slots}"
                 if gpu.blackhole_timeline is not None else "")
        print(f"registry {what}: {spec.topo.kind}, {spec.sim.slots} "
              f"slots, {len(c.flows)} flows, GPU f64 captured {wall:.3f} "
              "s; parity with CPU plain path"
              f"{' and golden metrics' if routing is None else ''}: ok; "
              f"mean_goodput={m.mean_goodput!r}{react}", flush=True)


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


def loop_walls(c, dtype, runs: int = 3, trace=None) -> dict:
    """Host prep, then `runs` eager and `runs` captured slot loops of one
    prepared run, in turns (eager, captured, captured, eager, ...), each
    held bit-equal to the first eager run (with `trace`, its records
    too); walls in seconds, each ending in a synchronize.  A captured
    run is its capture (slot 0 eagerly, then one graph per capacity
    segment) and its replays of slots 1..T-1."""
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
            loop = engine.slot_loop(cfg, ops, trace=trace)
            loop.capture()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            loop.replay()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            res = engine._loop_results(cfg, loop)
            out["capture_s"].append(t1 - t0)
            out["replay_s"].append(t2 - t1)
            out["graphs"] = len(loop.graphs)
            del loop
        else:
            res = engine._simulate(cfg, ops, trace=trace, _eager=True)
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


# the scale phase's runs: (scenario, routing, dtypes); the giga point
# on its leaf-spine under AR and its own ECMP, on a fat tree of equal
# bisection under WAR and ECMP, and under the registry's reaction
SCALE_RUNS = (("giga_fabric_storage", "ar", ("float32", "float64"), None),
              ("giga_fabric_storage", None, ("float32", "float64"), None),
              ("giga_fat_tree", "war", ("float32", "float64"), None),
              ("giga_fat_tree", "ecmp", ("float32", "float64"), None),
              ("giga_fabric_storage_reroute", None, ("float64",), None),
              ("giga_fabric_storage", None, ("float64",), "dense"))


def scale_phase(report: dict, total: dict) -> None:
    """The giga runs of SCALE_RUNS through the entry point (captured
    slots); each run held bit for bit to an eager loop of its dtype, the
    loop timed apart from the host prep; each float64 run against the
    CPU plain path under the contained-fork contract (a reaction run's
    blackhole series within 1e-5), the leaf-spine ECMP one also against
    the golden row."""
    golden = json.loads((ROOT / "tests/golden/scenarios.json").read_text())
    report["scale"] = {}
    for name, routing, dnames, mode in SCALE_RUNS:
        with agg_env(mode):
            scale_run(report, total, golden, name, routing, dnames, mode)


def scale_run(report: dict, total: dict, golden: dict, name: str, routing,
              dnames, mode) -> None:
    """One SCALE_RUNS entry (`mode` "dense": dense aggregation forced on
    both paths, in the caller's `agg_env`)."""
    import numpy as np
    import torch
    from repro_torch.kernels import build
    from repro_torch.netsim import engine
    from repro_torch.scenarios import compile_scenario, distill_metrics
    spec = scenario(name, routing)
    what = label(name, spec.sim.routing) + (f" {mode}" if mode else "")
    out = report["scale"][what] = {}
    runs = {}
    for dname in dnames:
        dtype = getattr(torch, dname)
        c = compile_scenario(spec)
        reset_peak()
        build.reset_launches()
        t0 = time.perf_counter()
        res = c.run(device="cuda", dtype=dtype)
        wall = time.perf_counter() - t0
        counts = dict(build.LAUNCHES)
        check_launches(f"{what} {dname}", counts,
                       run_launches(c, dtype=dtype), total)
        agg = engine._prepared(c, dtype)[0].agg_mode
        if res.mean_goodput.shape != (len(c.flows),) or not np.isfinite(
                res.mean_goodput).all():
            fail(f"{what} {dname}: bad mean_goodput")
        mem = torch.cuda.max_memory_allocated()
        per_slot = sum(counts.values()) / spec.sim.slots
        walls = loop_walls(c, dtype)
        eager = [o.cpu().numpy() for o in walls.pop("results")]
        got = [res.mean_goodput, res.completion_slot, res.total_goodput,
               res.util_up_last] + ([res.blackhole_timeline]
                                    if res.blackhole_timeline is not None
                                    else [])
        eager[2] = eager[2][::spec.sim.record_every]
        if len(got) != len(eager) or not all(
                np.array_equal(a, b) for a, b in zip(got, eager)):
            fail(f"{what} {dname}: the captured run differs from the "
                 "eager loop")
        runs[dname] = (c, res)
        T = spec.sim.slots
        react = ""
        if res.blackhole_timeline is not None:
            m = distill_metrics(spec, c, res)
            react = (f", blackholed_bytes {m.blackholed_bytes!r}, "
                     f"reaction_slots {m.reaction_slots}")
        out[dname] = dict(
            wall_s=wall, slots_per_s=T / wall,
            kernel_launches_per_slot=per_slot,
            max_memory_allocated=mem, flows=len(c.flows), agg_mode=agg,
            mean_goodput=float(res.mean_goodput.mean()), **walls)
        print(f"scale {what} {dname}: {spec.topo.kind}, {agg}, "
              f"{len(c.flows)} flows x {T} slots through the entry "
              f"point (captured), wall {wall:.3f} s (host prep "
              f"included), {T / wall:.2f} slots/s, {per_slot:g} "
              "hand-written kernel launches/slot, max_memory_allocated "
              f"{mem / 2**20:.1f} MiB, mean goodput "
              f"{res.mean_goodput.mean()!r}{react}; bit-equal to the "
              "eager loop", flush=True)
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
    assert_blackholes(spec, c64, cpu, gpu64)
    if name == "giga_fabric_storage" and routing is None:
        assert_golden(spec.name, distill_metrics(spec, c64, gpu64),
                      golden)
    parity = dict(cpu_wall_s=cpu_wall, **stats)
    notes = [f"GPU f64 vs CPU plain path ({cpu_wall:.1f} s): {stats}"]
    if cpu.blackhole_timeline is not None:
        notes.append("blackhole series: ok")
    if name == "giga_fabric_storage" and routing is None:
        notes.append("golden metrics: ok")
    if "float32" in runs:
        parity["f32_vs_f64_max_abs"] = float(np.abs(
            runs["float32"][1].mean_goodput
            - gpu64.mean_goodput).max())
        notes.append("f32 vs f64 max |diff| "
                     f"{parity['f32_vs_f64_max_abs']:.3g}")
    out["parity"] = parity
    print(f"scale {what} parity: " + "; ".join(notes), flush=True)


def replay_profile(cfg, ops) -> dict:
    """A captured loop of `cfg`/`ops` replayed twice (after its capture):
    once timed to a synchronize, once under torch.profiler.  Returns the
    replays' wall a slot, the device's busy time a slot and its share of
    the wall (None when the profiler sees no device activity) and the
    device kernels a slot (every launch: hand-written and PyTorch's),
    and the timed loop's results."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.netsim import engine

    n = cfg.slots - 1
    loop = engine.slot_loop(cfg, ops)
    loop.capture()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop.replay()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    results = engine._loop_results(cfg, loop)
    again = engine.slot_loop(cfg, ops)
    again.capture()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        again.replay()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    return dict(replay_ms_per_slot=wall / n * 1e3,
                busy_ms_per_slot=busy / n * 1e3 if busy else None,
                busy_share=busy / wall if busy else None,
                device_launches_per_slot=(sum(e.count for e in kernels) / n
                                          if busy else None),
                graphs=len(loop.graphs), results=results)


def sparse_run(c, dtype, what: str, total: dict) -> tuple:
    """Compiled scenario `c` through the entry point in `dtype` on the
    path the engine picks (in the caller's `agg_env`), its launches
    held to `run_launches`; then its captured loop against its eager
    loop bit for bit, with `replay_profile`'s numbers.  Returns (row,
    result)."""
    import numpy as np
    import torch
    from repro_torch.kernels import build
    from repro_torch.netsim import engine

    reset_peak()
    build.reset_launches()
    t0 = time.perf_counter()
    res = c.run(device="cuda", dtype=dtype)
    wall = time.perf_counter() - t0
    counts = dict(build.LAUNCHES)
    check_launches(what, counts, run_launches(c, dtype=dtype), total)
    mem = torch.cuda.max_memory_allocated()
    T = c.cfg.slots
    if res.mean_goodput.shape != (len(c.flows),) or not np.isfinite(
            res.mean_goodput).all():
        fail(f"{what}: bad mean_goodput")
    cfg, _, ops = engine.prepare(c, "cuda", dtype)
    eager = engine._simulate(cfg, ops, _eager=True)
    prof = replay_profile(cfg, ops)
    if not all(torch.equal(a, b) for a, b in zip(prof.pop("results"), eager,
                                                 strict=True)):
        fail(f"{what}: the captured loop differs from the eager one")
    build.reset_launches()
    row = dict(agg_mode=cfg.agg_mode, flow_chunk=cfg.flow_chunk,
               wall_s=wall, flows=len(c.flows), max_memory_allocated=mem,
               hand_written_launches_per_slot=sum(counts.values()) / T,
               **prof)
    return row, res


def fmt_run(row: dict) -> str:
    busy = ("device busy not measured" if row["busy_share"] is None else
            f"device busy {row['busy_ms_per_slot']:.3f} ms/slot "
            f"({row['busy_share']:.1%}), "
            f"{row['device_launches_per_slot']:.1f} device launches/slot")
    return (f"{row['agg_mode']}"
            + (f" in chunks of {row['flow_chunk']}" if row["flow_chunk"]
               else "")
            + f": entry point {row['wall_s']:.3f} s, replays "
            f"{row['replay_ms_per_slot']:.3f} ms/slot, {busy}, "
            f"{row['hand_written_launches_per_slot']:g} hand-written "
            f"launches/slot, peak {row['max_memory_allocated'] / 2**20:.1f} "
            "MiB; captured equals eager")


def same_results(what: str, got, want, flows: bool = True) -> None:
    """Two results of one point bit for bit (`flows`: the per-flow
    outputs too)."""
    import numpy as np
    fields = (("mean_goodput", "completion_slot") if flows else ()) + (
        "total_goodput", "util_up_last", "blackhole_timeline")
    for f in fields:
        a, b = getattr(got, f), getattr(want, f)
        if (a is None) != (b is None) or (
                a is not None and not np.array_equal(a, b)):
            fail(f"{what}: {f} differs")


def sparse_phase(report: dict, total: dict) -> None:
    """Sparse aggregation and flow chunks at giga scale (see the module
    docstring): the giga point under its own mode against itself forced
    dense, chunked against one pass, a megabatch of giga seeds against
    its points alone, and the beyond-giga point."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.netsim import megabatch
    from repro_torch.scenarios import compile_scenario

    t_phase = time.perf_counter()
    out = report["sparse"] = {}
    # (a) the giga point under its own mode (sparse) and forced dense
    one_pass = {}
    for routing in ("ecmp", "ar"):
        for dname in ("float64", "float32"):
            dtype = getattr(torch, dname)
            res = {}
            for mode in ("dense", None):
                with agg_env(mode):
                    c = compile_scenario(scenario("giga_fabric_storage",
                                                  routing))
                    what = f"sparse giga[{routing}] {dname} " \
                           f"{mode or 'own mode'}"
                    row, res[mode] = sparse_run(c, dtype, what, total)
                out[what] = row
                print(f"{what}: {fmt_run(row)}", flush=True)
            if out[f"sparse giga[{routing}] {dname} own mode"][
                    "agg_mode"] != "sparse":
                fail("giga_fabric_storage does not run sparse")
            same_results(f"sparse giga[{routing}] {dname}", res[None],
                         res["dense"])
            one_pass[routing, dname] = res[None]
            print(f"sparse giga[{routing}] {dname}: sparse equals dense bit "
                  "for bit", flush=True)
    # (b) chunks of SEG_CHUNK flows against one pass
    with agg_env(None, SEG_CHUNK):
        c = compile_scenario(scenario("giga_fabric_storage"))
        what = "sparse giga[ecmp] float64 chunked"
        row, res = sparse_run(c, torch.float64, what, total)
    out[what] = row
    same_results(what, res, one_pass["ecmp", "float64"])
    print(f"{what}: {fmt_run(row)}; equals one pass bit for bit",
          flush=True)
    # (c) a megabatch of giga seeds, under sparse and in chunks
    for chunk in (None, SEG_CHUNK):
        with agg_env(None, chunk):
            points = [compile_scenario(scenario("giga_fabric_storage")
                                       .with_sim(seed=s)) for s in range(3)]
            T = points[0].cfg.slots
            bucket = megabatch._bucket(len(points[0].flows),
                                       megabatch.FLOW_BUCKET_MIN)
            n = -(-bucket // chunk) if chunk else 0
            reset_peak()
            build.reset_launches()
            t0 = time.perf_counter()
            rows = megabatch.run_megabatch(points, device="cuda")
            wall = time.perf_counter() - t0
            what = "sparse giga megabatch" + (f" in chunks of {chunk}"
                                              if chunk else "")
            check_launches(what, dict(build.LAUNCHES), slot_launches(
                "leaf_spine", "ecmp", T, "sparse", n), total)
            mem = torch.cuda.max_memory_allocated()
            for c, r in zip(points, rows):
                lane_equal(f"{what} seed {c.cfg.seed}", r,
                           c.run(device="cuda"))
        out[what] = dict(points=len(points), wall_s=wall,
                         max_memory_allocated=mem, chunks=n)
        print(f"{what}: {len(points)} seeds in one loop ({n or 1} chunk(s) "
              f"a slot over the {bucket}-flow bucket) in {wall:.3f} s, peak "
              f"{mem / 2**20:.1f} MiB; every row equal to its point alone",
              flush=True)
    # (d) beyond giga: 409,600 flows under ECMP, sparse, and forced dense
    res = {}
    for mode in (None, "dense"):
        with agg_env(mode):
            c = compile_scenario(scenario("giga_beyond"))
            what = f"sparse beyond giga {mode or 'own mode'}"
            row, res[mode] = sparse_run(c, torch.float64, what, total)
            if mode is None:
                cut = first_slots(c, BEYOND_CPU_SLOTS)
                gpu = cut.run(device="cuda")
                t0 = time.perf_counter()
                cpu = cut.run(device="cpu")
                row["cpu_first_slots_s"] = time.perf_counter() - t0
                assert_parity(cut.spec, cut, cpu, gpu)
                build.reset_launches()
        out[what] = row
        print(f"{what}: {len(c.flows)} flows x {c.cfg.slots} slots, "
              f"{fmt_run(row)}"
              + ("" if mode else f"; its first {BEYOND_CPU_SLOTS} slots "
                 f"equal to the CPU path ({row['cpu_first_slots_s']:.1f} s)"),
              flush=True)
    same_results("sparse beyond giga", res[None], res["dense"])
    print("sparse beyond giga: sparse equals dense bit for bit; peak "
          f"{out['sparse beyond giga own mode']['max_memory_allocated'] / 2**20:.1f}"
          f" MiB sparse, "
          f"{out['sparse beyond giga dense']['max_memory_allocated'] / 2**20:.1f}"
          " MiB dense", flush=True)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"sparse: phase wall {out['wall_s']:.1f} s", flush=True)


# the schedule phase: the registry's training-step schedules at their own
# size (the flaps also under ECMP and WAR), then GIGA_TRAIN at full width
COMPACT_RUNS = ("giga_fabric_storage", (None, "ar"))
COMPACT_REPEATS = 3


def compact_phase(report: dict, total: dict) -> None:
    """The int8 compact carry at giga scale: the giga point under its own
    ECMP and under AR in float32 through `_simulate` (captured, from an
    empty graph cache), wide and with REPRO_JX_COMPACT=1, bit-equal in
    every output; the compact run's probe counter is int8, a float64
    run's under the same setting int32; each first run's peak memory,
    then COMPACT_REPEATS runs of each from the graph cache in turns
    (wide, compact, compact, wide, ...), their replays a slot (CUDA
    events; the first run's too)."""
    import statistics
    import torch
    from repro_torch.kernels import build
    from repro_torch.netsim import engine
    from repro_torch.scenarios import compile_scenario

    def run(cfg, ops) -> tuple:
        timing: dict = {}
        got = engine._simulate(cfg, ops, timing=timing)
        torch.cuda.synchronize()
        start, end = timing["events"]
        slots = cfg.slots - (0 if timing["cached"] else 1)
        return got, start.elapsed_time(end) / slots

    name, routings = COMPACT_RUNS
    out = report["compact"] = {}
    for routing in routings:
        c = compile_scenario(scenario(name, routing))
        what = label(name, c.spec.sim.routing)
        T = c.spec.sim.slots
        rows, res = {}, {}
        for compact in (False, True):
            with agg_env(compact=compact):
                reset_peak()
                build.reset_launches()
                cfg, _, ops = engine.prepare(c, "cuda", torch.float32)
                dt = engine.init_carry(ops.fb, cfg).nic.probe_miss.dtype
                if cfg.compact_carry != compact or dt != (
                        torch.int8 if compact else torch.int32):
                    fail(f"compact {what}: compact_carry "
                         f"{cfg.compact_carry}, probe counter {dt}")
                got, ms = run(cfg, ops)
                check_launches(f"compact {what} {compact}",
                               dict(build.LAUNCHES),
                               run_launches(c, dtype=torch.float32), total)
                rows[compact] = dict(
                    first_ms_per_slot=ms, ms_per_slot=[],
                    max_memory_allocated=torch.cuda.max_memory_allocated(),
                    probe_miss_dtype=str(dt))
                res[compact] = [r.cpu() for r in got]
                del got, ops
                if compact:
                    cfg64, _, ops64 = engine.prepare(c, "cuda",
                                                     torch.float64)
                    dt64 = engine.init_carry(ops64.fb,
                                             cfg64).nic.probe_miss.dtype
                    if not cfg64.compact_carry or dt64 != torch.int32:
                        fail(f"compact {what} float64: probe counter "
                             f"{dt64}")
                    del ops64
        if not all(torch.equal(a, b) for a, b in zip(res[True], res[False],
                                                     strict=True)):
            fail(f"compact {what}: the compact float32 run differs from "
                 "the wide one")
        # both prepared again (each peak above is its run's alone) and
        # run once, so every timed run below comes from the cache
        prepared = {}
        for compact in (False, True):
            with agg_env(compact=compact):
                prepared[compact] = engine.prepare(c, "cuda",
                                                   torch.float32)[::2]
            run(*prepared[compact])
        order = [k % 4 in (1, 2) for k in range(2 * COMPACT_REPEATS)]
        for compact in order:
            got, ms = run(*prepared[compact])
            rows[compact]["ms_per_slot"].append(ms)
            if not all(torch.equal(a.cpu(), b) for a, b in
                       zip(got, res[compact])):
                fail(f"compact {what} {compact}: a run from the graph "
                     "cache differs from the first")
        build.reset_launches()
        del prepared
        out[what] = rows

        def fmt(r):
            return (f"{statistics.median(r['ms_per_slot']):.4f} ms/slot "
                    f"(runs {', '.join(f'{x:.4f}' for x in r['ms_per_slot'])};"
                    f" first {r['first_ms_per_slot']:.4f}), peak "
                    f"{r['max_memory_allocated'] / 2**20:.1f} MiB")
        print(f"compact {what} float32, {T} slots: wide {fmt(rows[False])}; "
              f"compact (int8 probe counter) {fmt(rows[True])}; bit-equal; "
              "float64 keeps an int32 counter", flush=True)


# the registry schedule run twice in one process: the second run's loop
# comes from the graph cache
SCHEDULE_TWICE = ("train_step_flap", None)
SCHEDULE_RUNS = (("train_step_baseline", None), ("train_step_flap", None),
                 ("train_step_flap_moe", None), ("train_step_flap", "ecmp"),
                 ("train_step_flap", "war"), ("train_step_flap_moe", "ecmp"),
                 ("train_step_flap_moe", "war"))
GIGA_TRAIN_RUNS = (("giga_train_llama3_8b", None, ("float64", "float32")),
                   ("giga_train_llama3_8b", "ecmp", ("float64",)),
                   ("giga_train_phi35_moe", None, ("float64",)))
# the full-width runs' CPU parity: the first slots of the same spec
# (llama3-8b's fwd->bwd boundary at 14 and bwd->sync at 42); the
# device's busy share is profiled over fewer (reading a profile of
# every kernel takes longer than the slots it covers)
GIGA_TRAIN_CPU_SLOTS = 60
GIGA_TRAIN_PROFILE_SLOTS = 20


def step_signature(what: str, st) -> str:
    """The study's signature on a flapped run: step 1 at least 1.2x step
    0, step 2 at most 1.1x."""
    if not (st[1] >= 1.2 * st[0] and st[2] <= 1.1 * st[0]):
        fail(f"{what}: step times {list(st)} miss the signature (step 1 "
             ">= 1.2x step 0, step 2 <= 1.1x)")
    return (f"signature ok (step 1 {st[1] / st[0]:.3f}x, step 2 "
            f"{st[2] / st[0]:.3f}x)")


def device_busy_s(run) -> float:
    """Summed kernel time of one `run()` under torch.profiler (0.0 when
    the profiler records no device activity)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e6


def schedule_twice(what: str, c) -> list:
    """Compiled schedule `c` run twice through `_simulate` (host prep
    each time) from an empty graph cache: the first run captures, the
    second takes its loop from the cache, captures 0 graphs and equals
    the first bit for bit.  Returns each run's walls."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.netsim import engine, graph

    graph.clear_graph_cache()
    runs, outs = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        engine.reset_dispatch_stats()
        timing: dict = {}
        t0 = time.perf_counter()
        cfg, _, ops = engine.prepare(c, "cuda", torch.float64)
        t1 = time.perf_counter()
        outs.append(engine._simulate(cfg, ops, trace=c.cfg.trace,
                                     timing=timing))
        torch.cuda.synchronize()
        start, end = timing["events"]
        runs.append(dict(prep_s=t1 - t0, bind_s=timing["bind_s"],
                         capture_s=timing["capture_s"],
                         cached=timing["cached"],
                         graphs=engine.dispatch_stats()["graphs"],
                         loop_s=start.elapsed_time(end) / 1e3,
                         wall_s=time.perf_counter() - t0))
    build.reset_launches()
    if runs[0]["cached"] or not runs[0]["graphs"] or not runs[1]["cached"] \
            or runs[1]["graphs"] or runs[1]["capture_s"] != 0.0:
        fail(f"schedule {what} twice: {runs}")
    if not all(torch.equal(a, b) for a, b in zip(*outs, strict=True)):
        fail(f"schedule {what}: the second run differs from the first")
    print(f"schedule {what} twice: first run {runs[0]['graphs']} graphs, "
          f"capture {runs[0]['capture_s'] * 1e3:.1f} ms, loop "
          f"{runs[0]['loop_s'] * 1e3:.1f} ms, wall {runs[0]['wall_s']:.3f} "
          f"s; second run from the graph cache: 0 graphs, capture "
          f"{runs[1]['capture_s'] * 1e3:.1f} ms (rebinding "
          f"{runs[1]['bind_s'] * 1e3:.1f} ms), loop "
          f"{runs[1]['loop_s'] * 1e3:.1f} ms, wall {runs[1]['wall_s']:.3f} "
          "s; bit-equal", flush=True)
    return runs


def schedule_phase(report: dict, total: dict) -> None:
    """Training-step schedules on the card (see the module docstring):
    the registry's three at their own size in float64, each against the
    CPU path, the golden row and the study's signature; then GIGA_TRAIN
    at full width, timed by layer, each float64 run held to the CPU path
    over its first GIGA_TRAIN_CPU_SLOTS slots."""
    import numpy as np
    import torch
    from repro_torch.kernels import build
    from repro_torch.netsim import engine, graph
    from repro_torch.scenarios import compile_scenario, distill_metrics

    t_phase = time.perf_counter()
    golden = json.loads((ROOT / "tests/golden/scenarios.json").read_text())
    out = report["schedule"] = {}
    for name, routing in SCHEDULE_RUNS:
        spec, what = scenario(name, routing), label(name, routing)
        c = compile_scenario(spec)
        graph.clear_graph_cache()                # captured, as before
        torch.cuda.synchronize()
        build.reset_launches()
        engine.reset_dispatch_stats()
        t0 = time.perf_counter()
        gpu = c.run(device="cuda")               # float64, captured
        wall = time.perf_counter() - t0
        graphs = engine.dispatch_stats()["graphs"]
        check_launches(what, dict(build.LAUNCHES),
                       slot_launches(spec.topo.kind, spec.sim.routing,
                                     spec.sim.slots), total)
        cpu = compile_scenario(spec).run(device="cpu")
        assert_parity(spec, c, cpu, gpu)
        if routing is None:
            assert_golden(name, distill_metrics(spec, c, gpu), golden)
        T = spec.sim.slots
        st = c.schedules[0].step_times(gpu.completion_slot, T)
        if not np.array_equal(st, c.schedules[0].step_times(
                cpu.completion_slot, T)):
            fail(f"{what}: step times differ from the CPU path")
        sig = step_signature(what, st) if "flap" in name else "baseline"
        walls = loop_walls(c, torch.float64, runs=1)
        walls.pop("results")
        if walls.pop("graphs") != graphs:
            fail(f"{what}: {graphs} graphs through the entry point")
        out[what] = dict(slots=T, flows=len(c.flows), wall_s=wall,
                         graphs=graphs, step_times=st.tolist(), **walls)
        print(f"schedule {what}: {len(c.flows)} flows x {T} slots, GPU f64 "
              f"captured {wall:.3f} s ({graphs} graphs: capture "
              f"{walls['capture_s'][0] * 1e3:.1f} ms, replays "
              f"{walls['replay_s'][0] / (T - 1) * 1e3:.3f} ms/slot, eager "
              f"{walls['eager_s'][0] / T * 1e3:.3f} ms/slot); step times "
              f"{st.tolist()} equal to the CPU path; parity"
              f"{' and golden metrics' if routing is None else ''}: ok; "
              f"{sig}", flush=True)
        if (name, routing) == SCHEDULE_TWICE:
            out[what]["twice"] = schedule_twice(what, c)

    for name, routing, dnames in GIGA_TRAIN_RUNS:
        spec = scenario(name, routing)
        what = label(name, spec.sim.routing)
        T = spec.sim.slots
        for dname in dnames:
            dtype = getattr(torch, dname)
            t0 = time.perf_counter()
            c = compile_scenario(spec)
            compile_s = time.perf_counter() - t0
            # run_compiled's steps, each timed: host prep, capture (slot 0
            # eagerly, then one graph a segment), replays
            reset_peak()
            build.reset_launches()
            t0 = time.perf_counter()
            cfg, fa, ops = engine.prepare(c, "cuda", dtype)
            torch.cuda.synchronize()
            prep_s = time.perf_counter() - t0
            loop = engine.slot_loop(cfg, ops)
            t0 = time.perf_counter()
            loop.capture()
            torch.cuda.synchronize()
            capture_s = time.perf_counter() - t0
            graphs = len(loop.graphs)
            t0 = time.perf_counter()
            loop.replay()
            torch.cuda.synchronize()
            replay_s = time.perf_counter() - t0
            wall = prep_s + capture_s + replay_s
            res = engine._wrap(cfg, fa, engine._loop_results(cfg, loop),
                               ops.fb.src.device)
            peak = torch.cuda.max_memory_allocated()
            counts = dict(build.LAUNCHES)
            check_launches(f"{what} {dname}", counts,
                           run_launches(c, T, dtype=dtype), total)
            per_slot = sum(counts.values()) / T
            if not np.isfinite(res.mean_goodput).all():
                fail(f"{what} {dname}: non-finite goodput")
            del loop, ops
            # the kernels' share of the replays' wall over the first
            # slots
            cut = first_slots(c, GIGA_TRAIN_PROFILE_SLOTS)
            ccfg, _, cops = engine.prepare(cut, "cuda", dtype)
            walls = []
            for profiled in (False, True):
                loop = engine.slot_loop(ccfg, cops)
                loop.capture()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if profiled:
                    busy_s = device_busy_s(loop.replay)
                else:
                    loop.replay()
                    torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            del loop, cops
            build.reset_launches()
            st = c.schedules[0].step_times(res.completion_slot, T)
            busy = ("not measured" if busy_s == 0.0 else
                    f"{busy_s / walls[0]:.1%}")
            row = out[f"{what} {dname}"] = dict(
                slots=T, flows=len(c.flows), compile_s=compile_s,
                wall_s=wall, prep_s=prep_s, graphs=graphs,
                capture_s=capture_s, replay_ms_per_slot=replay_s / (T - 1)
                * 1e3, first_slots_replay_s=walls[0],
                first_slots_profiled_s=walls[1], device_busy_s=busy_s,
                max_memory_allocated=peak,
                kernel_launches_per_slot=per_slot, step_times=st.tolist())
            print(f"schedule {what} {dname}: {len(c.flows)} flows x {T} "
                  f"slots; compile {compile_s:.3f} s; run {wall:.3f} s: host "
                  f"prep {prep_s:.3f} s, {graphs} graphs captured in "
                  f"{capture_s:.3f} s, "
                  f"replays {row['replay_ms_per_slot']:.3f} ms/slot (device "
                  f"busy over the first {GIGA_TRAIN_PROFILE_SLOTS} slots' "
                  f"replays: {busy}), peak {peak / 2**20:.1f} MiB, "
                  f"{per_slot:g} hand-written launches/slot; step times "
                  f"{st.tolist()}", flush=True)
            if dname != "float64":
                continue
            cut = first_slots(c, GIGA_TRAIN_CPU_SLOTS)
            build.reset_launches()
            gpu = cut.run(device="cuda")
            check_launches(f"{what} first slots", dict(build.LAUNCHES),
                           run_launches(cut), total)
            t0 = time.perf_counter()
            cpu = cut.run(device="cpu")
            cpu_s = time.perf_counter() - t0
            stats = assert_contained_fork(cut.spec, cut, cpu, gpu)
            row["parity"] = dict(cpu_wall_s=cpu_s, **stats)
            print(f"schedule {what} {dname} parity: its first "
                  f"{GIGA_TRAIN_CPU_SLOTS} slots against the CPU plain path "
                  f"({cpu_s:.1f} s): {stats}", flush=True)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"schedule: phase wall {out['wall_s']:.1f} s", flush=True)


def trace_phase(report: dict, total: dict) -> None:
    """Trace capture on the card: fig12_plane_flap at 600 slots, traced
    in float64 through the entry point, against the CPU path (host_bw,
    util and queue within 1e-5, ecn and eligible equal) and the paper's
    signature (straggler ranks (0,), bi-modal share 0.25); then the
    giga point recording every TRACE_EVERY slots, its captured loop
    bit-equal to the eager one, records included, 6 hand-written
    launches a slot (under sparse aggregation the trace's host_bw is a
    second segment_sum), and its wall a slot with and without the trace
    (in turns: off, on, on, off)."""
    import numpy as np
    import torch
    from repro_torch.kernels import build
    from repro_torch.netsim import engine
    from repro_torch.scenarios import compile_scenario, distill_metrics
    from repro_torch.trace import TraceSpec, trace_summary

    out = report["trace"] = {}
    spec = scenario("fig12_plane_flap").with_sim(
        trace=TraceSpec(enabled=True))
    c = compile_scenario(spec)
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    gpu = c.run(device="cuda")
    wall = time.perf_counter() - t0
    check_launches("trace fig12", dict(build.LAUNCHES),
                   slot_launches(spec.topo.kind, spec.sim.routing,
                                 spec.sim.slots), total)
    cpu = compile_scenario(spec).run(device="cpu")
    assert_parity(spec, c, cpu, gpu)
    errs = {}
    for k in cpu.trace:
        if gpu.trace[k].shape != cpu.trace[k].shape:
            fail(f"trace fig12 {k}: shape {gpu.trace[k].shape} vs "
                 f"{cpu.trace[k].shape}")
        errs[k] = float(np.abs(np.asarray(gpu.trace[k], np.float64)
                               - np.asarray(cpu.trace[k], np.float64)).max())
        if errs[k] > (TOL if k in ("host_bw", "util", "queue") else 0.0):
            fail(f"trace fig12 {k}: max |GPU - CPU| {errs[k]:.3g}")
    summ = trace_summary(gpu.trace, spec.topo.access_cap,
                         spec.topo.n_planes)
    m = distill_metrics(spec, c, gpu)
    if summ["straggler_ranks"] != (0,) or summ["bimodal_frac"] != 0.25 or \
            m.straggler_ranks != (0,) or m.bimodal_frac != 0.25:
        fail(f"trace fig12: signature {summ}")
    out["fig12"] = dict(wall_s=wall, max_abs_err_vs_cpu=errs,
                        straggler_ranks=list(summ["straggler_ranks"]),
                        bimodal_frac=summ["bimodal_frac"],
                        hft_transient_drops=summ["hft_transient_drops"],
                        port_classes=summ["port_classes"])
    print(f"trace fig12_plane_flap: {spec.sim.slots} slots, every field "
          f"recorded, GPU f64 captured {wall:.3f} s; vs CPU path max |diff| "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items() if k != "slot")
          + f"; straggler_ranks {summ['straggler_ranks']}, bimodal_frac "
          f"{summ['bimodal_frac']!r}, port classes {summ['port_classes']}",
          flush=True)

    trace = TraceSpec(enabled=True, every=TRACE_EVERY)
    spec = scenario("giga_fabric_storage").with_sim(trace=trace)
    c = compile_scenario(spec)
    reset_peak()
    build.reset_launches()
    t0 = time.perf_counter()
    res = c.run(device="cuda")
    wall = time.perf_counter() - t0
    mem = torch.cuda.max_memory_allocated()
    counts = dict(build.LAUNCHES)
    check_launches("trace giga", counts, run_launches(c, trace=trace), total)
    n_rec = len(range(0, spec.sim.slots, TRACE_EVERY))
    for k in trace.active_fields():
        if res.trace[k].shape[0] != n_rec or not np.isfinite(
                np.asarray(res.trace[k], np.float64)).all():
            fail(f"trace giga {k}: bad record")
    walls = {False: [], True: []}
    for traced in (False, True, True, False):
        w = loop_walls(compile_scenario(spec), torch.float64, runs=1,
                       trace=trace if traced else None)
        w.pop("results")
        walls[traced].append(w)
    T = spec.sim.slots

    def per_slot(ws):
        return [x["replay_s"][0] / (T - 1) * 1e3 for x in ws]

    out["giga"] = dict(every=TRACE_EVERY, wall_s=wall,
                       max_memory_allocated=mem,
                       replay_ms_per_slot_off=per_slot(walls[False]),
                       replay_ms_per_slot_on=per_slot(walls[True]),
                       eager_ms_per_slot_on=[x["eager_s"][0] / T * 1e3
                                             for x in walls[True]])
    print(f"trace giga_fabric_storage[ecmp] float64 every {TRACE_EVERY}: "
          f"{n_rec} records of every field through the entry point "
          f"(captured), wall {wall:.3f} s (host prep included), "
          f"max_memory_allocated {mem / 2**20:.1f} MiB, "
          f"{sum(counts.values()) / T:g} hand-written kernel launches/slot "
          f"({engine._prepared(c)[0].agg_mode}); captured equals eager "
          "with the records; "
          "replays "
          + ", ".join(f"{x:.3f}" for x in per_slot(walls[False]))
          + " ms/slot without the trace, "
          + ", ".join(f"{x:.3f}" for x in per_slot(walls[True]))
          + " ms/slot with it", flush=True)


def lane_equal(what: str, got, want) -> None:
    """A batch lane against the same point run alone: per-flow outputs,
    the last utilization and the trace bit for bit, the series within
    1e-12 relative (one sum a slot over the lane's flows, whose
    reduction tree may differ with the batch's shape)."""
    import numpy as np
    for f in ("mean_goodput", "completion_slot", "util_up_last"):
        if not np.array_equal(getattr(got, f), getattr(want, f)):
            fail(f"{what}: {f} differs from the single run")
    for f in ("total_goodput", "blackhole_timeline"):
        a, b = getattr(got, f), getattr(want, f)
        if (a is None) != (b is None) or (b is not None and not np.allclose(
                a, b, rtol=1e-12, atol=0)):
            fail(f"{what}: {f} beyond 1e-12 of the single run")
    if (got.trace is None) != (want.trace is None) or any(
            not np.array_equal(got.trace[k], want.trace[k])
            for k in (want.trace or {})):
        fail(f"{what}: trace differs from the single run")


def batch_phase(report: dict, total: dict) -> None:
    """Batched points on the card.  (a) `run_compiled_batch` over
    BATCH_SEEDS seeds of BATCH_POINT in float64, each lane equal to its
    single run on the card (`lane_equal`), timed against the single runs
    one at a time.  (b) `run_megabatch` over the GRID (two flow buckets x
    routing x NIC x seeds, one scenario's points traced), each row equal to
    its single run on the card and within the parity contract of the CPU
    path, with the captured loops of each group.  (c) LANES seeds of the
    giga point under ECMP in float64, batched against one at a time:
    wall (prep, capture, loop), peak memory and hand-written launches a
    slot, each lane equal to its single run.  (d) ALIAS_BATCHES: two
    batches of one structure dispatched before either is finalized, the
    second rebinding the first's loop in the graph cache, each equal to
    its batch run alone."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.netsim import engine, graph, megabatch
    from repro_torch.scenarios import compile_scenario
    from repro_torch.trace import TraceSpec

    out = report["batch"] = {}
    # (a) one registry point's seeds
    name, routing = BATCH_POINT
    points = [compile_scenario(scenario(name, routing).with_sim(seed=s))
              for s in range(BATCH_SEEDS)]
    spec = points[0].spec
    torch.cuda.synchronize()
    engine.reset_dispatch_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    got = engine.run_compiled_batch(points, device="cuda")
    batch_s = time.perf_counter() - t0
    check_launches(f"batch {label(name, routing)}", dict(build.LAUNCHES),
                   slot_launches(spec.topo.kind, spec.sim.routing,
                                 spec.sim.slots), total)
    graphs = engine.dispatch_stats()["graphs"]
    t0 = time.perf_counter()
    single = [c.run(device="cuda") for c in points]
    single_s = time.perf_counter() - t0
    for s, (g, w) in enumerate(zip(got, single)):
        lane_equal(f"batch {label(name, routing)} seed {s}", g, w)
    out["seeds"] = dict(scenario=label(name, routing), points=BATCH_SEEDS,
                        slots=spec.sim.slots, flows=len(points[0].flows),
                        batch_s=batch_s, single_s=single_s, graphs=graphs,
                        points_per_s=BATCH_SEEDS / batch_s,
                        single_points_per_s=BATCH_SEEDS / single_s)
    print(f"batch {label(name, routing)}: {BATCH_SEEDS} seeds x "
          f"{spec.sim.slots} slots in one batch (f64, {graphs} graph(s)) "
          f"{batch_s:.3f} s, {BATCH_SEEDS / batch_s:.2f} points/s; one at "
          f"a time {single_s:.3f} s, {BATCH_SEEDS / single_s:.2f} points/s"
          f" ({single_s / batch_s:.2f}x); 5 hand-written kernel launches/"
          "slot; every lane equal to its single run", flush=True)

    # (b) a megabatch grid
    grid = []
    for name in GRID["names"]:
        for routing in GRID["routings"]:
            for nic in GRID["nics"]:
                for seed in GRID["seeds"]:
                    sp = scenario(name, routing).with_sim(nic=nic, seed=seed)
                    if name == GRID["traced"]:
                        sp = sp.with_sim(trace=TraceSpec(enabled=True))
                    grid.append(compile_scenario(sp))
    caches, planned = megabatch.plan_megabatch(grid)
    torch.cuda.synchronize()
    engine.reset_dispatch_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    rows, loops = [None] * len(grid), []
    for group in planned:
        before = engine.dispatch_stats()["loops"]
        for idxs, handle in megabatch.dispatch_planned(group, caches,
                                                       "cuda"):
            for i, r in zip(idxs, megabatch.finalize_group(handle)):
                rows[i] = r
        loops.append(engine.dispatch_stats()["loops"] - before)
    mega_s = time.perf_counter() - t0
    # one loop a (group, routing, NIC) sub-batch, each PER_SLOT a slot
    want: dict = {}
    for _, routing, _ in {(megabatch._struct_key(c), c.spec.sim.routing,
                           c.spec.sim.nic) for c in grid}:
        for k, n in slot_launches("leaf_spine", routing,
                                  grid[0].spec.sim.slots).items():
            want[k] = want.get(k, 0) + n
    check_launches("megabatch", dict(build.LAUNCHES), want, total)
    t0 = time.perf_counter()
    single = [c.run(device="cuda") for c in grid]
    single_s = time.perf_counter() - t0
    for c, g, w in zip(grid, rows, single):
        what = f"megabatch {c.spec.name}[{c.spec.sim.routing}, " \
               f"{c.spec.sim.nic}] seed {c.spec.sim.seed}"
        lane_equal(what, g, w)
        assert_parity(c.spec, c, c.run(device="cpu"), g)
        if g.trace is not None and any(
                g.trace[f].shape[1] != len(c.flows)
                for f in ("ecn", "eligible")):
            fail(f"{what}: flow-axis trace fields not stripped")
    out["megabatch"] = dict(points=len(grid), groups=len(planned),
                            loops_per_group=loops, wall_s=mega_s,
                            single_s=single_s)
    print(f"megabatch: {len(grid)} points ({len(GRID['names'])} scenarios "
          f"in 2 flow buckets x ar/war/ecmp x spx/dcqcn x "
          f"{len(GRID['seeds'])} seeds, {GRID['traced']} traced) in "
          f"{len(planned)} groups, captured loops per group "
          f"{loops}, {mega_s:.3f} s ({len(grid) / mega_s:.2f} points/s; one "
          f"at a time {single_s:.3f} s); every row equal to its single run "
          "and within parity of the CPU path", flush=True)

    # (c) the giga point's seeds, batched against one at a time
    points = [compile_scenario(scenario("giga_fabric_storage")
                               .with_sim(seed=s)) for s in range(LANES)]
    T = points[0].spec.sim.slots

    def timed(prep):
        """prep() -> (cfg, trace, fas, ops); then capture and replays,
        each timed to a synchronize; returns walls, results, memory."""
        reset_peak()
        build.reset_launches()
        t0 = time.perf_counter()
        cfg, trace, fas, ops = prep()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loop = engine.slot_loop(cfg, ops, trace=trace)
        loop.capture()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        loop.replay()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        outs = engine._loop_results(cfg, loop)
        if len(fas) == 1 and ops.fb.demand.dim() == 1:      # one point
            res = [engine._wrap(cfg, fas[0], outs, torch.device("cuda"))]
        else:
            res = engine.finalize_batch(engine.BatchHandle(
                cfg, trace, fas, outs, torch.device("cuda")))
        counts = dict(build.LAUNCHES)
        return dict(prep_s=t1 - t0, capture_s=t2 - t1, loop_s=t3 - t2,
                    graphs=len(loop.graphs),
                    max_memory_allocated=torch.cuda.max_memory_allocated(),
                    launches_per_slot=sum(counts.values()) / T), res, counts

    def one(c):
        def prep():
            cfg, fa, ops = engine.prepare(c, "cuda", torch.float64)
            return cfg, None, [fa], ops
        return prep

    walls = {"batched": [], "single": []}
    for batched in (True, False, False, True):
        if batched:
            w, res, counts = timed(lambda: engine.prepare_batch(
                points, "cuda", torch.float64))
            check_launches("batch giga", counts,
                           run_launches(points[0], T), total)
            walls["batched"].append(w)
            batch_res = res
        else:
            ws, single = [], []
            for c in points:
                w, [r], counts = timed(one(c))
                check_launches("batch giga single", counts,
                               run_launches(c, T), total)
                ws.append(w)
                single.append(r)
            walls["single"].append({k: sum(w[k] for w in ws) for k in
                                    ("prep_s", "capture_s", "loop_s")}
                                   | {"max_memory_allocated": max(
                                       w["max_memory_allocated"]
                                       for w in ws)})
    for s, (g, w) in enumerate(zip(batch_res, single)):
        lane_equal(f"batch giga seed {s}", g, w)
    out["giga"] = dict(lanes=LANES, slots=T, **walls)

    def fmt(w):
        return (f"prep {w['prep_s']:.3f} s, capture {w['capture_s'] * 1e3:.1f}"
                f" ms, loop {w['loop_s'] / (T - 1) * 1e3:.3f} ms/slot, "
                f"{w['prep_s'] + w['capture_s'] + w['loop_s']:.3f} s in all, "
                f"peak {w['max_memory_allocated'] / 2**20:.1f} MiB")
    print(f"batch giga_fabric_storage[ecmp] float64, {LANES} seeds: "
          "batched (" + "; ".join(fmt(w) for w in walls["batched"])
          + f"; {walls['batched'][0]['launches_per_slot']:g} hand-written "
          "kernel launches/slot); one at a time, summed over the seeds ("
          + "; ".join(fmt(w) for w in walls["single"]) + "); every lane "
          "equal to its single run", flush=True)

    # (d) two batches of one structure outstanding together
    name, slots, seeds = ALIAS_BATCHES
    batches = [[compile_scenario(scenario(name).with_sim(slots=slots,
                                                         seed=s))
                for s in lane_seeds] for lane_seeds in seeds]
    alone = []
    for pts in batches:
        graph.clear_graph_cache()
        alone.append(engine.run_compiled_batch(pts, "cuda"))
    graph.clear_graph_cache()
    handles = [engine.dispatch_compiled_batch(pts, "cuda")
               for pts in batches]
    hits = graph.graph_cache_stats()["hits"]
    if hits != len(batches) - 1:
        fail(f"batch outstanding: {hits} graph-cache hits")
    for k, (h, want) in enumerate(zip(handles, alone)):
        for s, (g, w) in enumerate(zip(engine.finalize_batch(h), want)):
            same_results(f"batch outstanding {k} lane {s}", g, w)
    out["outstanding"] = dict(scenario=name, slots=slots, batches=seeds,
                              hits=hits)
    print(f"batch outstanding: {len(batches)} batches of {name} "
          f"({slots} slots, seeds {seeds}) dispatched before either was "
          f"finalized, the second rebinding the first's loop ({hits} "
          "graph-cache hit): each lane equal to its batch run alone",
          flush=True)


def rows_equal(what: str, got, want, tol: float) -> None:
    """Two distilled rows field by field, `extra` included: floats
    within `tol` (relative, or absolute below 1; NaN equal to NaN),
    dicts and sequences item by item, everything else exactly."""
    import math

    def close(g, w, path):
        if isinstance(w, float):
            if not ((math.isnan(g) and math.isnan(w))
                    or math.isclose(g, w, rel_tol=tol, abs_tol=tol)):
                fail(f"{what}: {path} {g!r} vs {w!r}")
        elif isinstance(w, dict):
            if g.keys() != w.keys():
                fail(f"{what}: {path} keys {sorted(g)} vs {sorted(w)}")
            for k in w:
                close(g[k], w[k], f"{path}.{k}")
        elif isinstance(w, (list, tuple)):
            if len(g) != len(w):
                fail(f"{what}: {path} length {len(g)} vs {len(w)}")
            for i, (a, b) in enumerate(zip(g, w)):
                close(a, b, f"{path}[{i}]")
        elif g != w:
            fail(f"{what}: {path} {g!r} vs {w!r}")

    close(got.to_dict(), want.to_dict(), "row")


def sweep_launches(specs) -> tuple:
    """Launches and slot loops a megabatch of `specs` must make: one loop
    a (structure, flow bucket, routing, NIC) sub-batch (points with and
    without a schedule share one), each `PER_SLOT[kind, routing]` a
    slot, whether the loop is captured or comes from the graph cache
    (a replay counts what its capture recorded, slot 0 included)."""
    from repro_torch.netsim import megabatch
    from repro_torch.scenarios import compile_scenario
    want: dict = {}
    loops = set()
    for sp in specs:
        c = compile_scenario(sp)
        cfg, trace = megabatch._sub_key(c)
        key = (megabatch._struct_key(c), cfg, trace)
        if key not in loops:
            loops.add(key)
            for k, n in slot_launches(cfg.kind, cfg.routing, cfg.slots,
                                      cfg.agg_mode).items():
                want[k] = want.get(k, 0) + n
    return want, len(loops)


def sweep_walls(flights) -> dict:
    """The executor's walls summed over executions, its loops and
    graphs, and each loop's capture wall."""
    from repro_torch.experiments.execute import WALLS
    walls = {k: sum(fl["walls"][k] for fl in flights) for k in WALLS}
    walls["loops"] = sum(fl["dispatch_stats"]["loops"] for fl in flights)
    walls["graphs"] = sum(fl["dispatch_stats"]["graphs"] for fl in flights)
    walls["capture_ms"] = [lp["capture_s"] * 1e3 for fl in flights
                           for lp in fl["pipeline"]["loops"]]
    return walls


def fmt_walls(w: dict) -> str:
    caps = w["capture_ms"]
    return (f"{w['loops']} loops, {w['graphs']} graphs; compile "
            f"{w['compile_s']:.3f} s, host prep {w['prep_s']:.3f} s "
            f"(overlapped with a loop: {w['overlap_s']:.3f} s), operands "
            f"{w['operands_s']:.3f} s, capture {w['capture_s']:.3f} s "
            f"({min(caps):.1f}-{max(caps):.1f} ms a loop), loop "
            f"{w['loop_s']:.3f} s on the device (replays queued in "
            f"{w['replay_s']:.3f} s), finalize {w['finalize_s']:.3f} s")


def threaded_megabatch(specs, derive=None) -> tuple:
    """The executor's megabatch pipeline with each next sub-batch's host
    prep on a worker thread (which makes no CUDA call), started before
    the current sub-batch's operands and capture: the alternative to the
    executor's inline prep, timed beside it.  Returns (rows, wall)."""
    from concurrent.futures import ThreadPoolExecutor
    import torch
    from repro_torch.netsim import megabatch
    from repro_torch.scenarios import compile_scenario, distill_metrics
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    compiled = [compile_scenario(sp) for sp in specs]
    caches, planned = megabatch.plan_megabatch(compiled)
    preps = (prep for group in planned
             for prep in megabatch.prepare_planned(group, caches))
    rows = [None] * len(specs)
    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(next, preps, None)
        while (prep := fut.result()) is not None:
            fut = pool.submit(next, preps, None)
            idxs, handle = megabatch.dispatch_prepared(prep, caches, "cuda",
                                                       torch.float64)
            for i, r in zip(idxs, megabatch.finalize_group(handle)):
                m = distill_metrics(specs[i], compiled[i], r)
                if derive is not None:
                    m.extra.update(derive(specs[i], compiled[i], r))
                rows[i] = m
    return rows, time.perf_counter() - t0


def library_pass(exps, want: dict, n_loops: int, what: str,
                 total: dict) -> tuple:
    """The library once more through `run_experiment` (megabatch, no run
    cache), its launches held to `want` and its loops to `n_loops`.
    Returns (rows by experiment, wall, walls, peak memory)."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.experiments import run_experiment
    from repro_torch.netsim import engine
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine.reset_dispatch_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    sets = [run_experiment(exp, device="cuda", dispatch="megabatch")
            for exp in exps]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check_launches(what, dict(build.LAUNCHES), want, total)
    if engine.dispatch_stats()["loops"] != n_loops:
        fail(f"{what}: {engine.dispatch_stats()} for {n_loops} sub-batches")
    return ({exp.name: rs.to_metrics() for exp, rs in zip(exps, sets)}, wall,
            sweep_walls([rs.flight["executions"][0] for rs in sets]), peak)


def library_again(exps, rows: dict, want: dict, n_loops: int, cold_s: float,
                  cold: dict, cold_peak: int, total: dict) -> dict:
    """After the library's first pass (from an empty graph cache, its
    rows `rows`, wall `cold_s`, walls `cold`): the graph cache's hits in
    that pass and what it holds; a second pass in the same process, no
    run cache, which must capture 0 graphs (0.0 s of capture) and equal
    the first bit for bit; the device memory the entries hold; then a
    pass without the cache (`GRAPH_CACHE_ENTRIES` = 0), equal too, for
    its peak beside the first's."""
    import torch
    from repro_torch.netsim import graph

    first = graph.graph_cache_stats()
    warm, warm_s, w, warm_peak = library_pass(exps, want, n_loops,
                                              "sweep library again", total)
    if w["graphs"] or w["capture_s"] != 0.0:
        fail(f"sweep library again: {w['graphs']} graphs, capture "
             f"{w['capture_s']} s")
    for exp in exps:
        for i, (g, r) in enumerate(zip(warm[exp.name], rows[exp.name])):
            rows_equal(f"sweep library again {exp.name} point {i}", g, r,
                       0.0)
    held = graph.graph_cache_stats()
    torch.cuda.synchronize()
    alloc, reserved = torch.cuda.memory_allocated(), \
        torch.cuda.memory_reserved()
    graph.clear_graph_cache()
    torch.cuda.empty_cache()
    alloc -= torch.cuda.memory_allocated()
    reserved -= torch.cuda.memory_reserved()
    bound = graph.GRAPH_CACHE_ENTRIES
    graph.GRAPH_CACHE_ENTRIES = 0
    try:
        off, off_s, o, off_peak = library_pass(
            exps, want, n_loops, "sweep library without the cache", total)
    finally:
        graph.GRAPH_CACHE_ENTRIES = bound
    for exp in exps:
        for i, (g, r) in enumerate(zip(off[exp.name], rows[exp.name])):
            rows_equal(f"sweep library without the cache {exp.name} point "
                       f"{i}", g, r, 0.0)
    mib = 2**20
    print(f"sweep graph cache: first pass {cold_s:.3f} s ({cold['loops']} "
          f"loops, {cold['graphs']} graphs, capture {cold['capture_s']:.3f} "
          f"s, {first['hits']} hits within the pass), peak "
          f"{cold_peak / mib:.1f} MiB; second pass {warm_s:.3f} s "
          f"({fmt_walls(w)}), peak {warm_peak / mib:.1f} MiB, every row "
          f"bit-equal to the first pass; the cache then held "
          f"{held['entries']} entries, {held['bytes'] / mib:.1f} MiB of "
          f"buffers (bound {bound} entries, "
          f"{graph.GRAPH_CACHE_BYTES / mib:.0f} MiB), releasing "
          f"{alloc / mib:.1f} MiB allocated and {reserved / mib:.1f} MiB "
          f"reserved; without the cache {off_s:.3f} s (capture "
          f"{o['capture_s']:.3f} s, loop {o['loop_s']:.3f} s), peak "
          f"{off_peak / mib:.1f} MiB, rows bit-equal", flush=True)
    return dict(first_hits=first["hits"], first_entries=first["entries"],
                second_s=warm_s, second=w, second_peak=warm_peak,
                entries=held["entries"], bytes=held["bytes"],
                released_allocated=alloc, released_reserved=reserved,
                bound_entries=bound, bound_bytes=graph.GRAPH_CACHE_BYTES,
                without_s=off_s, without=o, without_peak=off_peak)


def sweep_phase(report: dict, total: dict) -> None:
    """The Experiment API on the card (see the module docstring):
    (a) the library, (b) the run cache, (c) the giga grid."""
    import shutil
    import torch
    from repro_torch.experiments import (Axis, Experiment, RunCache,
                                         engine_salt, get_experiment,
                                         list_experiments, product,
                                         run_experiment, spec_key)
    from repro_torch.kernels import build
    from repro_torch.netsim import engine, graph
    from repro_torch.scenarios import compile_scenario, run_point

    out = report["sweep"] = {}
    cache_dir = ROOT / "build" / "sweep_cache"
    shutil.rmtree(cache_dir, ignore_errors=True)
    exps = [get_experiment(n) for n in list_experiments()]
    points = {exp.name: exp.points() for exp in exps}
    n_points = sum(map(len, points.values()))
    want: dict = {}
    n_loops = 0
    for exp in exps:
        w, n = sweep_launches([p.spec for p in points[exp.name]])
        n_loops += n
        for k, v in w.items():
            want[k] = want.get(k, 0) + v

    # (a) the library at its registered sizes
    reset_peak()
    engine.reset_dispatch_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    sets = [run_experiment(exp, device="cuda", dispatch="megabatch",
                           cache=str(cache_dir)) for exp in exps]
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check_launches("sweep library", dict(build.LAUNCHES), want, total)
    if engine.dispatch_stats()["loops"] != n_loops or \
            any(rs.cache_hits for rs in sets):
        fail(f"sweep library: {engine.dispatch_stats()} for {n_loops} "
             "sub-batches, or a cache hit in a cold cache")
    walls = sweep_walls([rs.flight["executions"][0] for rs in sets])
    rows = {exp.name: rs.to_metrics() for exp, rs in zip(exps, sets)}
    out["graph_cache"] = library_again(exps, rows, want, n_loops,
                                       batch_s, walls, peak, total)
    single_s = 0.0
    for exp in exps:
        for p, got in zip(points[exp.name], rows[exp.name]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            alone = run_point(p.spec, "cuda", derive=exp.derive)
            single_s += time.perf_counter() - t0
            rows_equal(f"sweep {exp.name} point {p.index}", got, alone,
                       SWEEP_RTOL)
            if exp.name == "train_comms_resiliency" and \
                    "flap" in got.scenario:
                step_signature(f"sweep {exp.name} {got.scenario}",
                               got.extra["step_time_slots"])
    for exp in exps:
        if exp.name in SWEEP_CPU:
            cpu = run_experiment(exp, device="cpu").to_metrics()
            for i, (g, c) in enumerate(zip(rows[exp.name], cpu)):
                rows_equal(f"sweep {exp.name} point {i} (CPU)", g, c, TOL)
    n_cpu = sum(len(points[n]) for n in SWEEP_CPU)
    out["library"] = dict(experiments=len(exps), points=n_points,
                          batch_s=batch_s, single_s=single_s,
                          points_per_s=n_points / batch_s,
                          single_points_per_s=n_points / single_s,
                          max_memory_allocated=peak, **walls)
    print(f"sweep library: {len(exps)} experiments, {n_points} points "
          f"through run_experiment (megabatch, f64) in {batch_s:.3f} s, "
          f"{n_points / batch_s:.2f} points/s; one at a time (run_point) "
          f"{single_s:.3f} s, {n_points / single_s:.2f} points/s "
          f"({single_s / batch_s:.2f}x); {fmt_walls(walls)}; peak "
          f"{peak / 2**20:.1f} MiB; every row equal to its point alone "
          f"(1e-12), the {n_cpu} fat-tree and reaction points to the CPU "
          "path (1e-5)", flush=True)

    # (b) the same from the run cache, then one corrupted entry
    engine.reset_dispatch_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    again = [run_experiment(exp, device="cuda", cache=str(cache_dir))
             for exp in exps]
    cached_s = time.perf_counter() - t0
    hits = sum(rs.cache_hits for rs in again)
    if hits != n_points or engine.dispatch_stats()["loops"]:
        fail(f"sweep cache: {hits} hits of {n_points}, "
             f"{engine.dispatch_stats()}")
    check_launches("sweep cache", dict(build.LAUNCHES), {}, total)
    for exp, rs in zip(exps, again):
        for i, (g, w) in enumerate(zip(rs.to_metrics(), rows[exp.name])):
            rows_equal(f"sweep cache {exp.name} point {i}", g, w, 0.0)
    exp = get_experiment("fig9_isolation")
    victim = points[exp.name][1]
    salt = engine_salt(torch.device("cuda"), torch.float64) + \
        exp.cache_salt()
    Path(RunCache(str(cache_dir)).path_for(
        spec_key(victim.spec, salt))).write_text("{corrupt")
    engine.reset_dispatch_stats()
    build.reset_launches()
    rs = run_experiment(exp, device="cuda", cache=str(cache_dir))
    if (rs.cache_hits, rs.cache_misses) != (len(points[exp.name]) - 1, 1) \
            or engine.dispatch_stats()["loops"] != 1:
        fail(f"sweep corrupt entry: {rs.cache_hits} hits, "
             f"{rs.cache_misses} misses, {engine.dispatch_stats()}")
    check_launches("sweep corrupt entry", dict(build.LAUNCHES),
                   sweep_launches([victim.spec])[0], total)
    for i, (g, w) in enumerate(zip(rs.to_metrics(), rows[exp.name])):
        rows_equal(f"sweep corrupt entry point {i}", g, w, SWEEP_RTOL)
    shutil.rmtree(cache_dir)
    out["cache"] = dict(hits=hits, wall_s=cached_s, recomputed=1)
    print(f"sweep cache: {hits} of {n_points} points from the run cache in "
          f"{cached_s:.3f} s, 0 slot loops, rows equal; one corrupted "
          "entry recomputed alone (1 loop)", flush=True)

    # (c) a giga grid: seeds x routing, two sub-batches of 4 lanes
    exp = Experiment(name="giga_grid", base="giga_fabric_storage",
                     axes=product(Axis("seed", GIGA_GRID["seeds"]),
                                  Axis("sim.routing",
                                       GIGA_GRID["routings"])))
    specs = [p.spec for p in exp.points()]
    T = specs[0].sim.slots
    want = {}
    for routing in GIGA_GRID["routings"]:
        c = compile_scenario(next(sp for sp in specs
                                  if sp.sim.routing == routing))
        for k, n in run_launches(c, T).items():
            want[k] = want.get(k, 0) + n
    runs = []
    for threaded in (False, True, True, False):
        reset_peak()
        engine.reset_dispatch_stats()
        build.reset_launches()
        if threaded:
            got, wall = threaded_megabatch(specs)
            runs.append(dict(threaded=True, wall_s=wall))
        else:
            t0 = time.perf_counter()
            rs = run_experiment(exp, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = rs.to_metrics()
            w = sweep_walls(rs.flight["executions"])
            runs.append(dict(threaded=False, wall_s=wall, **w))
        runs[-1]["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        check_launches(f"sweep giga grid{' (threaded)' * threaded}",
                       dict(build.LAUNCHES), want, total)
        if engine.dispatch_stats()["loops"] != len(GIGA_GRID["routings"]):
            fail(f"sweep giga grid: {engine.dispatch_stats()}")
        if runs[0] is runs[-1]:
            first = got
        for i, (g, w) in enumerate(zip(got, first)):
            rows_equal(f"sweep giga grid run {len(runs)} point {i}", g, w,
                       0.0)
    single_s = 0.0
    for sp, g in zip(specs, first):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        alone = run_point(sp, "cuda")
        single_s += time.perf_counter() - t0
        rows_equal(f"sweep giga grid {sp.sim.routing} seed {sp.sim.seed}",
                   g, alone, SWEEP_RTOL)
    out["giga_grid"] = dict(points=len(specs), slots=T, runs=runs,
                            single_s=single_s)
    inline = [r for r in runs if not r["threaded"]]
    print(f"sweep giga grid: {len(specs)} points (giga_fabric_storage, "
          f"{len(GIGA_GRID['seeds'])} seeds x ecmp/ar, {T} slots, f64) "
          "through run_experiment: "
          + "; ".join(f"{r['wall_s']:.3f} s ({len(specs) / r['wall_s']:.2f}"
                      f" points/s; {fmt_walls(r)}; peak "
                      f"{r['max_memory_allocated'] / 2**20:.1f} MiB)"
                      for r in inline)
          + "; host prep on a worker thread: "
          + ", ".join(f"{r['wall_s']:.3f} s (peak "
                      f"{r['max_memory_allocated'] / 2**20:.1f} MiB)"
                      for r in runs if r["threaded"])
          + f"; one at a time {single_s:.3f} s "
          f"({len(specs) / single_s:.2f} points/s); every row equal to its "
          "point alone", flush=True)


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


# the serve phase: ServeEngine over random weights drawn on the card at
# the configs' published widths (configs/llama3_8b.py, configs/
# gemma3_12b.py; parameters float32); llama3-8b at its full depth,
# gemma3-12b cut to its first period (5 local layers of window 1024 and
# one global).  Prompts of these lengths, max_new tokens each; more
# requests than slots, so slots are reused.  Each run serves in the
# model's compute dtype (bfloat16) and llama3-8b once more with float32
# activations (the same weights), where the kernels' own error shows.
#
# `tol` bounds the served logits (float32) of the kernel run against the
# same engine on the plain attention versions, fed the kernel run's
# tokens: the max abs difference over every prefill and step, a dtype.
# In bfloat16 at llama3-8b's depth the difference is bfloat16's own: it
# grows with depth (0.031 at 1 layer, 0.22 at 8, 0.52 at 32; logits up
# to 4-5; `depth_sensitivity`), and the plain versions differ almost as
# much from the reference's chunked attention on the card (0.43 at 32
# layers), so its bound is over twice the largest difference measured.
# gemma3-12b's one period measured 0.0078 (logits up to 0.6), bounded
# at 0.03.  With float32 activations the kernels and the plain versions
# agree within 1.6e-3 at 32 layers, bounded at 1e-2.  (NVIDIA H100 80GB
# HBM3, 700 W; PERF.md section 6.)  The logit bound says how far the
# served path moves end to end; the kernels themselves are held call by
# call (`held_on_card`): every launch of the served run against its
# plain version on that call's own inputs, within ATTN_TOL of its dtype
# times the call's largest |v|.
SERVE_RUNS = (
    dict(arch="llama3-8b", periods=None, batch=4, max_len=1024,
         prompts=(64, 512, 200, 448, 96, 320), max_new=16, seed=28,
         tol={"bfloat16": 1.25, "float32": 1e-2}),
    dict(arch="gemma3-12b", periods=1, batch=2, max_len=2064,
         prompts=(2048, 1500), max_new=8, seed=29, tol={"bfloat16": 0.03}),
)
# every family's reduced config on the card at head_dim 64 in float32,
# held to the port's CPU forward within ATTN_TOL["float32"]
SERVE_REDUCED = ("phi3.5-moe-42b-a6.6b", "mamba2-780m", "jamba-v0.1-52b",
                 "deepseek-v2-236b", "llava-next-mistral-7b")


def _serve_cfg(spec):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(spec["arch"])
    if spec["periods"] is not None:
        cfg = dataclasses.replace(
            cfg, n_layers=cfg.n_prefix_layers
            + spec["periods"] * cfg.pattern_len)
    return cfg


def serve_engine(cfg, params, spec, forced=None, ctx=None) -> dict:
    """One `ServeEngine.run` over the spec's requests, on whatever
    attention route is in place; its prefill and decode steps are
    wrapped to time them (synchronised) and keep their logits, and with
    `forced` (a kernel run's record) each decode step takes that run's
    tokens (teacher forcing).  The record keeps the engine's last caches
    and positions for a profiled step."""
    import numpy as np
    import torch
    from repro_torch.parallel import local_ctx
    from repro_torch.train import Request, ServeEngine
    eng = ServeEngine(cfg, local_ctx() if ctx is None else ctx, params,
                      batch=spec["batch"], max_len=spec["max_len"])
    rec = dict(prefill_s=[], decode_s=[], prefill=[], decode=[], tokens=[],
               active=[])
    # the wrappers hold the engine's slot list, not the engine, so no
    # reference cycle keeps its weights and caches alive after the run
    prefill0, decode0, slots = eng._prefill, eng._decode, eng.slots

    def prefill(p, t, c):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, c = prefill0(p, t, c)
        torch.cuda.synchronize()
        rec["prefill_s"].append(time.perf_counter() - t0)
        rec["prefill"].append(logits.float().cpu())
        return logits, c

    def decode(p, t, q, c):
        if forced is not None:
            t = forced["tokens"][len(rec["tokens"])].to(t.device)
        rec["tokens"].append(t.cpu())
        rec["active"].append([r is not None for r in slots])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, c = decode0(p, t, q, c)
        torch.cuda.synchronize()
        rec["decode_s"].append(time.perf_counter() - t0)
        rec["decode"].append(logits.float().cpu())
        return logits, c

    eng._prefill, eng._decode = prefill, decode
    rng = np.random.default_rng(spec["seed"])
    reqs = [Request(i, rng.integers(0, cfg.vocab, n, dtype=np.int32),
                    spec["max_new"]) for i, n in enumerate(spec["prompts"])]
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    rec["wall_s"] = time.perf_counter() - t0
    if sorted(r.rid for r in done) != list(range(len(reqs))):
        fail(f"serve {cfg.name}: {len(done)} of {len(reqs)} requests done")
    rec["tokens_out"] = sum(len(r.out) for r in reqs)
    rec["outs"] = [r.out for r in reqs]
    rec["caches"], rec["positions"] = eng.caches, eng.positions.copy()
    return rec


def device_profile(what: str, fn) -> tuple:
    """`torch.profiler` over one synchronised `fn()`: its result, and
    the wall, the device busy time, the device kernels and those that
    take the most time, printed under `what`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in ev) / 1e3
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:8]
    out = dict(wall_ms=wall * 1e3, busy_ms=busy,
               kernels=sum(e.count for e in ev),
               top=[dict(name=e.key[:100], ms=e.self_device_time_total / 1e3,
                         count=e.count) for e in top])
    if busy == 0.0:
        print(f"  profile of {what}: device time not measured (profiler saw "
              "no device activity)", flush=True)
        return result, out
    print(f"  profile of {what}: wall {out['wall_ms']:.3f} ms (profiled), "
          f"device busy {busy:.3f} ms ({busy / out['wall_ms']:.1%}), "
          f"{out['kernels']} device kernels", flush=True)
    for t in out["top"][:6]:
        print(f"    {t['ms']:.3f} ms x{t['count']} {t['name'][:80]}",
              flush=True)
    return result, out


def decode_profile(cfg, params, rec, ctx=None, what="a decode step"
                   ) -> dict:
    """One decode step on the run's last caches (through `ctx`, no mesh
    by default), profiled (`device_profile`) after a warm-up step."""
    import torch
    from repro_torch.models import decode_step
    from repro_torch.parallel import local_ctx
    ctx = local_ctx() if ctx is None else ctx
    B = len(rec["positions"])
    toks = torch.zeros((B, 1), dtype=torch.int32, device="cuda")
    pos = torch.tensor(rec["positions"], device="cuda")
    with torch.inference_mode():
        decode_step(params, cfg, toks, pos, ctx, rec["caches"])
        return device_profile(what, lambda: decode_step(
            params, cfg, toks, pos, ctx, rec["caches"]))[1]


def serve_check(cfg, params, spec, report: dict, total: dict,
                profile_step: bool) -> None:
    """One served model in `cfg.dtype`: the kernel run (timed, launches
    counted and asserted); the same run again with every kernel call
    held to its plain version on the call's own inputs (`held_on_card`,
    fed the first run's tokens); then the plain-attention run fed those
    tokens, every prefill's and step's logits within the spec's `tol`."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.models import param_count, standard_attention_layers
    torch.cuda.reset_peak_memory_stats()
    n_attn = standard_attention_layers(cfg)
    build.reset_launches()
    kern = serve_engine(cfg, params, spec)
    counts = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    what = (f"serve {cfg.name} {cfg.dtype} ({cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, head_dim "
            f"{cfg.head_dim}, vocab {cfg.vocab})")
    admits, steps = len(kern["prefill"]), len(kern["decode"])
    check_launches(what, counts, {"flash_attention": n_attn * admits,
                                  "decode_attention": n_attn * steps},
                   total)
    prof = decode_profile(cfg, params, kern) if profile_step else None
    kern.pop("caches")
    held_tol = ATTN_TOL[cfg.dtype]
    held_err: dict = {}
    with held_on_card(held_tol, held_err):
        serve_engine(cfg, params, spec, forced=kern).pop("caches")
    if {k: n for k, (n, _, _) in held_err.items()} != {
            k: counts[k] for k in ("flash_attention", "decode_attention")}:
        fail(f"{what}: the held run checked {held_err}, the served run "
             f"launched {counts}")
    build.reset_launches()
    with plain_on_card():
        plain = serve_engine(cfg, params, spec, forced=kern)
    plain.pop("caches")
    if any(build.LAUNCHES.values()):
        fail(f"{what}: the plain run launched {dict(build.LAUNCHES)}")
    if len(plain["decode"]) != steps or len(plain["prefill"]) != admits:
        fail(f"{what}: the plain run took another schedule")
    errs = []
    for got, want in zip(kern["prefill"], plain["prefill"]):
        if got.shape != (spec["batch"], 1, cfg.vocab) or \
                not bool(got.isfinite().all()):
            fail(f"{what}: prefill logits {tuple(got.shape)} or not finite")
        errs.append(float((got - want).abs().max()))
    prefill_err = max(errs)
    agree = rows_total = 0
    for i, (got, want) in enumerate(zip(kern["decode"], plain["decode"])):
        rows = [j for j, a in enumerate(kern["active"][i]) if a]
        if not bool(got.isfinite().all()):
            fail(f"{what}: decode step {i} logits not finite")
        errs.append(float((got[rows] - want[rows]).abs().max()))
        agree += int((got[rows].argmax(-1) == want[rows].argmax(-1)).sum())
        rows_total += len(rows)
    err = max(errs)
    tol = spec["tol"][cfg.dtype]
    logit_max = max(float(x.abs().max()) for x in plain["decode"])
    decode_ms = sorted(t * 1e3 for t in kern["decode_s"])
    plain_ms = sorted(t * 1e3 for t in plain["decode_s"])
    row = dict(
        model=cfg.name, dtype=cfg.dtype, layers=cfg.n_layers,
        params=param_count(params), batch=spec["batch"],
        max_len=spec["max_len"], prompts=list(spec["prompts"]),
        max_new=spec["max_new"], admissions=admits, steps=steps,
        launches=counts, prefill_ms=[t * 1e3 for t in kern["prefill_s"]],
        decode_ms_median=decode_ms[len(decode_ms) // 2],
        decode_ms_mean=sum(decode_ms) / len(decode_ms),
        wall_s=kern["wall_s"], tokens=kern["tokens_out"],
        tokens_per_s=kern["tokens_out"] / kern["wall_s"],
        plain_prefill_ms=[t * 1e3 for t in plain["prefill_s"]],
        plain_decode_ms_median=plain_ms[len(plain_ms) // 2],
        plain_wall_s=plain["wall_s"], max_abs_err=err, tol=tol,
        prefill_max_abs_err=prefill_err, step_errs=errs,
        argmax_agree=agree, argmax_rows=rows_total, logit_max=logit_max,
        held_tol=held_tol, held={k: dict(calls=n, max_err_over_v=e,
                                         max_abs_err=a)
                                 for k, (n, e, a) in held_err.items()},
        max_memory_allocated=peak, profile=prof, outs=kern["outs"])
    report.setdefault("serve", []).append(row)
    print(f"{what}: {len(spec['prompts'])} requests (prompts "
          f"{list(spec['prompts'])}, max_new {spec['max_new']}) through "
          f"{spec['batch']} slots: {admits} admissions, {steps} decode "
          f"steps; flash_attention {counts['flash_attention']} launches "
          f"({n_attn} an admission), decode_attention "
          f"{counts['decode_attention']} ({n_attn} a step)", flush=True)
    print(f"  prefill ms by admission "
          f"{[round(t, 3) for t in row['prefill_ms']]}; decode ms a step "
          f"median {row['decode_ms_median']:.3f}, mean "
          f"{row['decode_ms_mean']:.3f}; {row['tokens']} tokens in "
          f"{row['wall_s']:.3f} s = {row['tokens_per_s']:.1f} tok/s; peak "
          f"{peak / 2**30:.2f} GiB; plain attention: prefill ms "
          f"{[round(t, 3) for t in row['plain_prefill_ms']]}, decode "
          f"median {row['plain_decode_ms_median']:.3f}, wall "
          f"{row['plain_wall_s']:.3f} s ({card()})", flush=True)
    print(f"  each kernel call held to its plain version on the call's own "
          f"inputs: " + ", ".join(
              f"{k} {n} calls, max abs err {a:.4g}, over the call's max |v| "
              f"{e:.4g}" for k, (n, e, a) in held_err.items())
          + f" (tolerance {held_tol} of max |v|)", flush=True)
    print(f"  teacher-forced against the plain attention versions: max abs "
          f"logit err {err:.4g} (prefill {prefill_err:.4g}; tolerance "
          f"{tol}; logits up to {logit_max:.3g} in magnitude), argmax "
          f"equal on {agree} of {rows_total} decode rows", flush=True)
    if not err <= tol:
        fail(f"{what}: max abs logit err {err:.4g} > {tol}")


@contextmanager
def attention_route(prefill, decode):
    """The model's standard attention through `prefill` and `decode`
    (called as `attention._prefill_attention` and
    `attention._decode_attention` are) while the block runs."""
    from repro_torch.models import attention
    saved = attention._prefill_attention, attention._decode_attention
    attention._prefill_attention, attention._decode_attention = \
        prefill, decode
    try:
        yield
    finally:
        attention._prefill_attention, attention._decode_attention = saved


def _plain_prefill(q, k, v, positions, window, cfg, ctx):
    """`ops.flash_attention_bshd`'s plain version on the kernel's
    inputs."""
    from repro_torch.kernels import ref
    return ref.flash_attention_bshd_ref(q, k, v, causal=True, window=window)


def _plain_decode(q, cache, positions, window, ctx):
    """`ops.decode_attention_bshd`'s plain version on the kernel's
    inputs."""
    from repro_torch.kernels import ref
    from repro_torch.models import attention
    return ref.decode_attention_bshd_ref(
        q, cache["k"], cache["v"],
        attention.decode_lengths(positions, cache["pos"].shape[1]))


def plain_on_card():
    """Standard attention on CUDA through the kernels' plain versions
    (`kernels/ref.py`): the yardstick a served model is held to."""
    return attention_route(_plain_prefill, _plain_decode)


def held_on_card(tol: float, worst: dict):
    """The kernels' own route, each call's output held to its plain
    version on the same inputs: `fail` where the max abs difference
    over the call's largest |v| (at least 1) passes `tol`.  Attention
    outputs are convex combinations of v rows, so `ATTN_TOL`, set for
    unit-scale inputs, scales with v: the reference's init gives
    llama3-8b v entries of about 10, where one bf16 ulp is 0.0625.
    `worst` gets (calls, max scaled err, max abs err) by kernel."""
    import torch
    from repro_torch.models import attention
    kernel_prefill = attention._prefill_attention
    kernel_decode = attention._decode_attention

    def hold(name, got, want, q, v):
        err = float((got.detach().float() - want.float()).abs().max())
        scaled = err / max(1.0, float(v.detach().abs().max()))
        if got.shape != want.shape or not scaled <= tol:
            fail(f"{name} at q {tuple(q.shape)}, v {tuple(v.shape)} on the "
                 f"served path: {tuple(got.shape)} against "
                 f"{tuple(want.shape)}, max abs err {err:.4g}, over max "
                 f"|v| {scaled:.4g} > {tol}")
        n, e, a = worst.get(name, (0, 0.0, 0.0))
        worst[name] = (n + 1, max(e, scaled), max(a, err))

    def prefill(q, k, v, positions, window, cfg, ctx):
        got = kernel_prefill(q, k, v, positions, window, cfg, ctx)
        with torch.no_grad():       # the plain version keeps no graph
            want = _plain_prefill(q, k, v, positions, window, cfg, ctx)
        hold("flash_attention", got, want, q, v)
        return got

    def decode(q, cache, positions, window, ctx):
        got = kernel_decode(q, cache, positions, window, ctx)
        hold("decode_attention", got,
             _plain_decode(q, cache, positions, window, ctx), q,
             cache["v"])
        return got

    return attention_route(prefill, decode)


def chunked_on_card():
    """Standard attention through the reference's algorithm, the port's
    `chunked_attention` (KV chunks, online softmax, P rounded to the
    model dtype), on CUDA tensors: a second plain implementation to set
    the plain versions against."""
    from repro_torch.models import attention

    def prefill(q, k, v, positions, window, cfg, ctx):
        return attention.chunked_attention(q, k, v, positions, positions,
                                           window=window,
                                           chunk=cfg.attn_chunk)

    def decode(q, cache, positions, window, ctx):
        return attention.chunked_attention(
            q, cache["k"], cache["v"], positions, cache["pos"],
            window=window, chunk=cache["k"].shape[1])

    return attention_route(prefill, decode)


def depth_sensitivity(cfg, params, report: dict) -> None:
    """How far bfloat16 logits move with the attention's summation
    order, by depth: a 4 x 512-token prefill and two decode steps of the
    first 1, 2, 4, ..., n_periods periods through the kernels against
    the plain versions, and at full depth the plain versions against the
    reference's chunked attention on the card."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.models import (decode_step, init_caches, prefill_step,
                                    tree_map)
    from repro_torch.parallel import local_ctx
    B, S = 4, 512
    toks = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, S + 2)), dtype=torch.int32, device="cuda")

    def logits(c, p):
        ctx = local_ctx()
        with torch.inference_mode():
            caches = init_caches(c, B, 1024, c.dtype, "cuda")
            lg, caches = prefill_step(p, c, toks[:, :S], ctx, caches)
            out = [lg.float()]
            for i in range(2):
                lg, caches = decode_step(
                    p, c, toks[:, S + i:S + i + 1],
                    torch.full((B,), S + i, dtype=torch.int32,
                               device="cuda"), ctx, caches)
                out.append(lg.float())
        return out

    def err(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(a, b))

    rows, n = [], 1
    while n <= cfg.n_periods:
        c = dataclasses.replace(cfg, n_layers=n * cfg.pattern_len)
        p = dict(params, period=tree_map(params["period"],
                                         lambda a: a[:n]))
        kernel = logits(c, p)
        with plain_on_card():
            rows.append((n, err(kernel, logits(c, p))))
        n *= 2
    with plain_on_card():
        plain = logits(cfg, params)
    with chunked_on_card():
        other = err(plain, logits(cfg, params))
    report["serve_depth"] = dict(kernel_vs_plain=rows,
                                 plain_vs_chunked=other)
    print(f"  bfloat16 sensitivity ({B} x {S}-token prefill and 2 decode "
          f"steps): kernel vs plain max abs logit err by periods "
          + ", ".join(f"{n}: {e:.4g}" for n, e in rows)
          + f"; plain vs the reference's chunked attention on the card at "
          f"{cfg.n_periods}: {other:.4g}", flush=True)


def serve_run(spec, report: dict, total: dict) -> None:
    """Draw the spec's weights on the card once and serve them in each
    of its dtypes (`serve_check`); the first dtype's step is profiled;
    a model at full depth also gets `depth_sensitivity`."""
    import dataclasses
    import torch
    from repro_torch.models import init_params, param_count
    cfg = _serve_cfg(spec)
    reset_peak()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        spec["seed"]), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    print(f"serve {cfg.name}: {param_count(params):,} float32 parameters "
          f"drawn on the card in {init_s:.2f} s (peak "
          f"{init_peak / 2**30:.2f} GiB)", flush=True)
    for i, dtype in enumerate(spec["tol"]):
        serve_check(dataclasses.replace(cfg, dtype=dtype), params, spec,
                    report, total, profile_step=i == 0)
        report["serve"][-1].update(init_s=init_s,
                                   init_max_memory_allocated=init_peak)
    if spec["periods"] is None:
        depth_sensitivity(cfg, params, report)
    del params
    gc.collect()
    torch.cuda.empty_cache()


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def reduced_forward(arch: str, total: dict) -> dict:
    """The reduced config at head_dim 64 in float32: prefill (40
    tokens), four decode steps and the loss on the card through the
    kernels, against the port's CPU forward on the same weights."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import (decode_step, init_caches, init_params,
                                    loss_fn, prefill_step,
                                    standard_attention_layers, tree_map)
    from repro_torch.parallel import local_ctx
    cfg = get_config(arch).reduced(head_dim=64, dtype="float32")
    cpu_p = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    rng = np.random.default_rng(3)
    B, S = 2, 40
    toks = torch.tensor(rng.integers(0, cfg.vocab, (B, S + 5)),
                        dtype=torch.int32)
    fe = None if not cfg.frontend_tokens else torch.tensor(
        rng.standard_normal((B, cfg.frontend_tokens, cfg.d_model)) * 0.02,
        dtype=torch.float32)
    outs = {}
    for dev, p in (("cpu", cpu_p),
                   ("cuda", tree_map(cpu_p, lambda a: a.to("cuda")))):
        build.reset_launches()
        caches = init_caches(cfg, B, 64, "float32", dev)
        logits, caches = prefill_step(p, cfg, toks[:, :S].to(dev),
                                      local_ctx(), caches,
                                      None if fe is None else fe.to(dev))
        out = [logits]
        for i in range(4):
            logits, caches = decode_step(
                p, cfg, toks[:, S + i:S + i + 1].to(dev),
                torch.full((B,), S + i, dtype=torch.int32, device=dev),
                local_ctx(), caches)
            out.append(logits)
        batch = {"tokens": toks[:, :S].to(dev),
                 "labels": toks[:, 1:S + 1].to(dev)}
        if fe is not None:
            batch["frontend_embeds"] = fe.to(dev)
        out.append(loss_fn(p, cfg, batch, local_ctx())[0][None])
        outs[dev] = [t.cpu() for t in out]
        if dev == "cuda":
            n = standard_attention_layers(cfg)
            check_launches(f"reduced {arch} forward", dict(build.LAUNCHES),
                           {"flash_attention": 2 * n,
                            "decode_attention": 4 * n}, total)
    err = 0.0
    for got, want in zip(outs["cuda"], outs["cpu"]):
        if got.shape != want.shape or not bool(got.isfinite().all()):
            fail(f"reduced {arch}: shape or non-finite output on the card")
        err = max(err, float(((got - want).abs()
                              / (1 + want.abs())).max()))
    tol = ATTN_TOL["float32"]
    print(f"serve reduced {arch} (head_dim 64, float32): CUDA prefill, 4 "
          f"decode steps and loss against the CPU forward, max err "
          f"{err:.3g} (|a - b| / (1 + |b|); tolerance {tol})", flush=True)
    if not err <= tol:
        fail(f"reduced {arch}: err {err:.3g} > {tol}")
    return dict(arch=arch, max_err=err)


def decode_bshd_case(report: dict) -> None:
    """`ops.decode_attention_bshd` at llama3-8b decode shapes: the serve
    run's batch of 4 over a 1024-slot ring (B, S, 8, 128), 32 query heads,
    rows of 1024, 700, 300 and 40 valid slots; against its plain version
    and SDPA (GQA, the same mask), with the bound.  Then the decode
    kernel's two instances on the model_kernels decode case's values,
    bit-equal."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(30)
    B, S, Hq, Hkv, D = 4, 1024, 32, 8, 128
    q = torch.randn((B, 1, Hq, D), generator=gen, device="cuda").to(
        torch.bfloat16)
    k, v = (torch.randn((B, S, Hkv, D), generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    lens = torch.tensor([1024, 700, 300, 40], dtype=torch.int32,
                        device="cuda")
    valid = (torch.arange(S, device="cuda")[None, None, None, :]
             < lens[:, None, None, None])
    got = ops.decode_attention_bshd(q, k, v, lens)
    want = ref.decode_attention_bshd_ref(q, k, v, lens)
    err = float((got.float() - want.float()).abs().max())
    if not err <= ATTN_TOL["bfloat16"]:
        fail(f"decode_attention_bshd: max abs err {err:.3g}")
    keys = int(lens.sum())
    nbytes = (2 * q.numel() + 2 * Hkv * D * keys) * 2 + 4 * B
    ops_n = 4 * D * Hq * keys
    bound = max(nbytes / HBM_BYTES_PER_S, ops_n / PEAK_FLOPS["bfloat16"]) \
        * 1e3
    row = dict(case=f"llama3-8b decode_attention_bshd B={B} S={S} GQA 32/8",
               ms=graph_ms(lambda: ops.decode_attention_bshd(q, k, v, lens),
                           reps=20),
               plain_ms=event_ms(lambda: ref.decode_attention_bshd_ref(
                   q, k, v, lens)),
               library_ms=graph_ms(lambda: F.scaled_dot_product_attention(
                   q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                   attn_mask=valid, enable_gqa=True), reps=20),
               bound_ms=bound, bytes=nbytes, ops=ops_n, max_abs_err=err)
    report["decode_attention_bshd"] = row
    print(f"model {row['case']}: ms={row['ms']:.6f} plain_ms="
          f"{row['plain_ms']:.6f} library_ms={row['library_ms']:.6f} "
          f"bound_ms={bound:.6f} (bytes) max_abs_err={err:.3g} (bound "
          f"{ATTN_TOL['bfloat16']})", flush=True)
    # the model_kernels decode case's (B, H, S, D) values through both
    # instances: the contiguous tensors (compile-time strides) and views
    # of head-padded buffers (run-time strides), the same bits
    B, S, H, D = DECODE_B, DECODE_S, LLAMA["Hq"], LLAMA["D"]
    q = torch.randn((B, H, 1, D), generator=gen, device="cuda").to(
        torch.bfloat16)
    k, v = (torch.randn((B, H, S, D + 8), generator=gen,
                        device="cuda").to(torch.bfloat16)[..., :D]
            for _ in range(2))
    lens = torch.tensor(np.linspace(1, S, B).round().astype(np.int32),
                        device="cuda")
    strided = ops.decode_attention_bshd(q.transpose(1, 2), k.transpose(1, 2),
                                        v.transpose(1, 2), lens)
    if not torch.equal(ops.decode_attention(
            q, k.contiguous(), v.contiguous(), lens).transpose(1, 2),
            strided):
        fail("decode_attention: the two instances differ")
    print(f"model llama3-8b decode B={B} S={S}: the compile-time-stride and "
          f"run-time-stride instances bit-equal", flush=True)


def serve_phase(report: dict, total: dict) -> None:
    """The model forward and the serving engine: SERVE_RUNS at full
    width through the attention kernels, each held teacher-forced to the
    plain attention versions; SERVE_REDUCED on the card against the CPU
    forward; `decode_attention_bshd` timed at the serve run's shapes."""
    import torch
    # the plain versions' float32 einsums and the float32 forwards run
    # in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    for spec in SERVE_RUNS:
        serve_run(spec, report, total)
    report["serve_reduced"] = [reduced_forward(a, total)
                               for a in SERVE_REDUCED]
    decode_bshd_case(report)
    torch.cuda.empty_cache()


# the train phase.  TRAIN_RUN: spx-100m (configs/spx_paper.py) at its
# full width and depth, the Trainer's own config as `examples/
# quickstart.py` runs it (4 planes, 16 micro-chunks), plane 2 failing at
# step 5 and healing at step 12.  Steps 10-19 run again from the
# step-10 checkpoint must give the first run's losses bit for bit: the
# weights and moments restore bit for bit, the attention backward has no
# atomics, the embedding's gradient is an `index_put_` with accumulate,
# which sorts its indices on CUDA, and the cross-entropy's gather meets
# one label a row, so no sum is left in an order that changes from run
# to run.
TRAIN_RUN = dict(arch="spx-100m", steps=20, batch=8, seq=1024, seed=31,
                 fail=(5, 2), heal=(12, 2), ckpt_at=10, held_step=1,
                 profiled_step=15)
TRAIN_LLAMA_LAYERS = 2
TRAIN_LLAMA = dict(steps=3, batch=1, seq=2048, seed=32)
# the backward against its plain version: max abs error over the plain
# gradient's largest magnitude (float32: sums over up to 4,096 keys in
# another order; bfloat16: the gradients are rounded to bf16 after
# float32 sums, 2^-9 relative, and the forward's P was rounded too)
BWD_TOL = {"float32": 2e-5, "bfloat16": 1e-2}
# (name, batch, tokens, query heads, kv heads, head_dim, window, dtype):
# spx-100m's train shape (the summary row), llama3-8b's and gemma3-12b's
# prefill cells of the model_kernels phase
BWD_CELLS = (("spx-100m train", 8, 1024, 12, 4, 64, 0, "bfloat16"),
             ("llama3-8b prefill", 1, PREFILL_S, LLAMA["Hq"], LLAMA["Hkv"],
              LLAMA["D"], 0, "bfloat16"),
             ("llama3-8b prefill", 1, PREFILL_S, LLAMA["Hq"], LLAMA["Hkv"],
              LLAMA["D"], 0, "float32"),
             ("gemma3-12b local", 1, PREFILL_S, GEMMA["Hq"], GEMMA["Hkv"],
              GEMMA["D"], GEMMA["window"], "bfloat16"))


def bwd_errors(got, want) -> float:
    """The largest of max |a - b| / max(1e-30, max |b|) over (dq, dk,
    dv)."""
    err = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype or not \
                bool(g.isfinite().all()):
            fail(f"flash_attention_bwd: {tuple(g.shape)} {g.dtype} against "
                 f"{tuple(w.shape)} {w.dtype}, or non-finite")
        scale = max(float(w.float().abs().max()), 1e-30)
        err = max(err, float((g.float() - w.float()).abs().max()) / scale)
    return err


# the backward's three kernels, by the name the profiler gives them
BWD_KERNELS = ("flash_bwd_delta", "flash_bwd_dkdv", "flash_bwd_dq")


def kernel_split_ms(fn, names, reps: int = 3, sessions: int = 3) -> dict:
    """Device ms a call of `fn` spends in the kernels whose names hold
    each of `names` (torch.profiler over `reps` calls after one warm-up,
    read from its raw device events: kernels launched through ctypes
    outside any torch op are not in `key_averages`; None where the
    profiler saw no such kernel).  After long runs of the other phases
    a session came back without device events while the next one saw
    them (PERF.md, PR 30), so up to `sessions` are tried."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    fn()
    torch.cuda.synchronize()
    out = dict.fromkeys(names)
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                with record_function("kernel_split_ms"):
                    fn()
            torch.cuda.synchronize()
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            for n in names:
                if n in e.name():
                    out[n] = (out[n] or 0.0) + (e.end_ns() - e.start_ns()) \
                        / 1e6 / reps
        if any(v is not None for v in out.values()):
            break
    return out


def bwd_cases(report: dict, summary: dict) -> None:
    """The backward kernel at BWD_CELLS on seeded card tensors, against
    its plain version on the forward kernel's output and log-sum-exp;
    two launches bit-equal; timed beside the plain version, SDPA's
    backward (`scaled_dot_product_attention(..., enable_gqa=True)`,
    the backward alone) and the bound, its three kernels apart
    (`kernel_split_ms`); and the forward kernel on the same inputs."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    # the plain versions' float32 einsums in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(29)
    rows = []
    for name, B, S, Hq, Hkv, D, window, dname in BWD_CELLS:
        dtype = getattr(torch, dname)

        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dtype)

        q, dout = randn(B, S, Hq, D), randn(B, S, Hq, D)
        k, v = randn(B, S, Hkv, D), randn(B, S, Hkv, D)
        out, lse = ops.flash_attention_fwd(q, k, v, window=window)

        def run():
            return ops.flash_attention_bwd(q, k, v, out, dout, lse,
                                           window=window)

        def plain():
            return ref.flash_attention_bwd_ref(q, k, v, out, dout, lse,
                                               window=window)

        got = run()
        err = bwd_errors(got, plain())
        if not err <= BWD_TOL[dname]:
            fail(f"flash_attention_bwd {name} {dname}: err {err:.3g} > "
                 f"{BWD_TOL[dname]} of the largest gradient")
        if not all(torch.equal(a, b) for a, b in zip(got, run())):
            fail(f"flash_attention_bwd {name} {dname}: two launches differ")
        del got
        qs, ks, vs = (t.detach().transpose(1, 2).requires_grad_(True)
                      for t in (q, k, v))
        pos = torch.arange(S, device="cuda")
        mask = None if not window else (
            (pos[:, None] >= pos[None, :])
            & (pos[:, None] - pos[None, :] < window))
        sdpa_out = F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, is_causal=mask is None,
            enable_gqa=True)
        grad = dout.transpose(1, 2)

        def library():
            return torch.autograd.grad(sdpa_out, (qs, ks, vs), grad,
                                       retain_graph=True)

        ms = event_ms(run, repeats=5)
        split = kernel_split_ms(run, BWD_KERNELS)
        plain_ms = event_ms(plain)
        library_ms = event_ms(library, repeats=5)
        # row 9 on these inputs (it writes the log-sum-exp)
        fwd_ms = graph_ms(lambda: ops.flash_attention_fwd(
            q, k, v, window=window), reps=5)
        del sdpa_out, qs, ks, vs
        pairs = attn_pairs(S, S, True, window)
        nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() \
            + lse.numel() * 4
        nops = 10 * D * B * Hq * pairs
        # the work the kernels do: S and dP again in dq (14 D), and at
        # head_dim 192/256 S^T and dP^T twice in dk_dv (18 D)
        work = (14 if D <= 128 else 18) * D * B * Hq * pairs
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = nops / PEAK_FLOPS[dname] * 1e3
        row = dict(kernel="flash_attention_bwd", case=f"{name} {dname}",
                   dtype=dname, shape=[B, S, Hq, Hkv, D, window],
                   max_abs_err=err, tol=BWD_TOL[dname], bytes=nbytes,
                   ops=nops, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                   tflops=nops / ms / 1e9, work=work,
                   tflops_done=work / ms / 1e9, fwd_ms=fwd_ms,
                   delta_ms=split["flash_bwd_delta"],
                   dkdv_ms=split["flash_bwd_dkdv"],
                   dq_ms=split["flash_bwd_dq"])
        parts = " ".join(
            f"{k}_ms={'not measured' if v is None else f'{v:.6f}'}"
            for k, v in zip(("delta", "dkdv", "dq"),
                            (row["delta_ms"], row["dkdv_ms"], row["dq_ms"])))
        print(f"model flash_attention_bwd {name} {dname} (B={B} S={S} "
              f"{Hq}/{Hkv} heads D={D} window={window}): ms={ms:.6f} "
              f"plain_ms={plain_ms:.6f} library_ms={library_ms:.6f} "
              f"bound_ms={row['bound_ms']:.6f} ({row['bound_by']}) "
              f"tflops={row['tflops']:.1f} of the 10 D work, "
              f"{row['tflops_done']:.1f} of the {work // (D * B * Hq * pairs)}"
              f" D it does; profiled {parts}; err={err:.3g} of the largest "
              f"gradient (bound {BWD_TOL[dname]}); two launches bit-equal; "
              f"flash_attention forward ms={fwd_ms:.6f}", flush=True)
        rows.append(row)
        del q, k, v, out, lse, dout
        torch.cuda.empty_cache()
    summary["flash_attention_bwd"] = dict(
        rows[0], max_abs_err_all=max(r["max_abs_err"] for r in rows))
    report["flash_attention_bwd"] = rows


@contextmanager
def held_bwd(step: dict):
    """Every flash_attention_bwd launch while the block runs held to
    its plain version on the call's own inputs: `fail` past BWD_TOL of
    its dtype times each gradient's largest plain magnitude.  `step`
    gets the calls, the worst error so scaled and the worst max abs
    error over max |dO| x max |v|."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    launch = fa._launch_bwd

    def held(q, k, v, out, dout, lse, layout, causal, window):
        got = launch(q, k, v, out, dout, lse, layout, causal, window)
        want = ref.flash_attention_bwd_ref(q, k, v, out, dout, lse,
                                           causal=causal, window=window)
        dname = str(q.dtype).split(".")[1]
        err = bwd_errors(got, want)
        if not err <= BWD_TOL[dname]:
            fail(f"flash_attention_bwd at q {tuple(q.shape)} on the train "
                 f"path: err {err:.3g} > {BWD_TOL[dname]}")
        absolute = max(float((g.float() - w.float()).abs().max())
                       for g, w in zip(got, want))
        dov = float(dout.float().abs().max()) * float(v.float().abs().max())
        step["calls"] = step.get("calls", 0) + 1
        step["err"] = max(step.get("err", 0.0), err)
        step["err_dov"] = max(step.get("err_dov", 0.0),
                              absolute / max(dov, 1e-30))
        return got

    fa._launch_bwd = held
    try:
        yield
    finally:
        fa._launch_bwd = launch


def train_batches(cfg, spec: dict, start: int = 0):
    """The synthetic pipeline's batches for `spec`, on the card."""
    import torch
    from repro_torch.data import DataConfig, DataLoader
    dl = DataLoader(DataConfig(vocab=cfg.vocab, seq_len=spec["seq"],
                               global_batch=spec["batch"]),
                    start_step=start)
    for batch in dl:
        yield {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}


def batch_loss(cfg, params, batch) -> float:
    """`loss_fn` of `params`, cast as a train step with
    `cast_params_bf16` casts them, on `batch`."""
    import torch
    from repro_torch.models import loss_fn, tree_map
    from repro_torch.parallel import local_ctx
    with torch.no_grad():
        cast = tree_map(params, lambda p: p.to(torch.bfloat16)
                        if p.dtype == torch.float32 and p.ndim > 1 else p)
        return float(loss_fn(cast, cfg, batch, local_ctx())[0])


def expected_failover(spec: dict) -> tuple:
    """planes up a step and the recovery records of a CPU
    `FailoverController` through the spec's fail and heal."""
    from repro_torch.core.fault_tolerance import FailoverController
    from repro_torch.core.planes import PlaneConfig
    fc = FailoverController(PlaneConfig(n_planes=4, microchunks=16))
    up = []
    for i in range(spec["steps"]):
        if i == spec["fail"][0]:
            fc.fail_plane(spec["fail"][1])
        if i == spec["heal"][0]:
            fc.restore_plane(spec["heal"][1])
        fc.on_step()
        up.append(int(fc.plane_up.sum()))
    return up, [dataclasses.astuple(r) for r in fc.records]


@contextmanager
def kept_grads(keep: dict):
    """The gradients of the train steps while the block runs, as the
    step hands them to AdamW: `keep["grads"]` holds a copy of the last
    step's tree."""
    from repro_torch.models import tree_map
    from repro_torch.train import loop
    update = loop.adamw_update

    def kept(grads, *args, **kwargs):
        keep["grads"] = tree_map(grads, lambda t: t.clone())
        return update(grads, *args, **kwargs)

    loop.adamw_update = kept
    try:
        yield
    finally:
        loop.adamw_update = update


def spx_train(report: dict, total: dict, keep: dict) -> None:
    """TRAIN_RUN: the Trainer through 20 steps, the failover, the
    checkpoint round trip and the rerun from it; `keep["grads"]` gets
    the held step's gradients (the dp phase syncs them)."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.planes import PlaneConfig
    from repro_torch.kernels import build
    from repro_torch.models import (init_params, param_count,
                                    standard_attention_layers, tree_leaves,
                                    tree_map)
    from repro_torch.parallel import local_ctx
    from repro_torch.train import Trainer, TrainerConfig
    spec = TRAIN_RUN
    cfg = get_config(spec["arch"])
    ckpt = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    # the checkpoint at step 10 is saved by hand (`Trainer.save`), so the
    # one `Trainer.restore` finds is that one
    tcfg = TrainerConfig(plane=PlaneConfig(n_planes=4, microchunks=16),
                         warmup_steps=2, total_steps=spec["steps"],
                         cast_params_bf16=True, ckpt_dir=str(ckpt),
                         ckpt_every=10 * spec["steps"])
    reset_peak()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        spec["seed"]), device="cuda")
    n_attn = standard_attention_layers(cfg)
    # the loss falls: the weights before and after the run on the first
    # step's batch, cast as the step casts them (one batch, so the spread
    # between the synthetic batches, about 1e-2 at 8,192 tokens, does not
    # decide it; it fell 0.045-0.086 over six seeds).  On these uniform
    # tokens a batch no step trains on moves by the run's noise alone
    # (-0.023 to +0.023 over 20 steps, with the kernels or the plain
    # float32 backward; PERF.md, PR 30), so its change is printed, not
    # held
    first = next(train_batches(cfg, spec))
    unseen = next(train_batches(cfg, spec, start=spec["steps"]))
    first_before = batch_loss(cfg, params, first)
    unseen_before = batch_loss(cfg, params, unseen)
    tr = Trainer(cfg, local_ctx(), tcfg, params)
    per_step = {"flash_attention": n_attn, "flash_attention_bwd": n_attn}
    hist, counts, held, saved, profiled = [], [], {}, None, None
    build.reset_launches()
    for i, batch in zip(range(spec["steps"]), train_batches(cfg, spec)):
        if i == spec["fail"][0]:
            tr.inject_plane_failure(spec["fail"][1])
        if i == spec["heal"][0]:
            tr.heal_plane(spec["heal"][1])
        before = dict(build.LAUNCHES)
        if i == spec["held_step"]:
            with held_bwd(held), kept_grads(keep):
                m = tr.train_step(batch)
        elif i == spec["profiled_step"]:
            m, profiled = device_profile("a train step",
                                         lambda: tr.train_step(batch))
        else:
            m = tr.train_step(batch)
        torch.cuda.synchronize()
        step_counts = {k: build.LAUNCHES[k] - before[k] for k in before}
        check_launches(f"train {cfg.name} step {i}", step_counts, per_step,
                       total)
        hist.append(m)
        if tr.step == spec["ckpt_at"]:
            tr.save()
            saved = tree_map({"params": tr.params, "opt": tr.opt_state},
                             lambda t: t.clone())
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in hist]
    first_after = batch_loss(cfg, tr.params, first)
    unseen_after = batch_loss(cfg, tr.params, unseen)
    if not all(np.isfinite(losses)) or not first_after < first_before:
        fail(f"train {cfg.name}: losses {losses}; the first step's batch "
             f"{first_before} before the run, {first_after} after")
    if held.get("calls") != n_attn:
        fail(f"train {cfg.name}: {held.get('calls')} backward calls held, "
             f"expected {n_attn}")
    up, records = expected_failover(spec)
    if [h["planes_up"] for h in hist] != up or [
            dataclasses.astuple(r) for r in tr.failover.records] != records:
        fail(f"train {cfg.name}: planes up {[h['planes_up'] for h in hist]}"
             f", records {tr.failover.records}; a CPU FailoverController "
             f"gives {up}, {records}")
    timed = [h["step_time_s"] for i, h in enumerate(hist)
             if i not in (0, spec["held_step"], spec["profiled_step"])]
    med = float(np.median(timed))
    tokens = spec["batch"] * spec["seq"]

    # the step-10 checkpoint: restored bit for bit, then steps 10-19 again
    rest = Trainer.restore(cfg, local_ctx(), tcfg, params)
    if rest.step != spec["ckpt_at"]:
        fail(f"train {cfg.name}: restored at step {rest.step}")
    got = {"params": rest.params, "opt": rest.opt_state}
    bits = all(torch.equal(a, b) and a.dtype == b.dtype for a, b in zip(
        tree_leaves(got), tree_leaves(saved)))
    if not bits:
        fail(f"train {cfg.name}: the step-{rest.step} checkpoint does not "
             "restore bit-equal")
    del saved
    if spec["fail"][0] < rest.step <= spec["heal"][0]:
        rest.inject_plane_failure(spec["fail"][1])
    again = []
    for i, batch in zip(range(rest.step, spec["steps"]),
                        train_batches(cfg, spec, start=rest.step)):
        if i == spec["heal"][0]:
            rest.heal_plane(spec["heal"][1])
        again.append(rest.train_step(batch))
    first = losses[spec["ckpt_at"]:]
    rerun = [h["loss"] for h in again]
    if rerun != first:
        fail(f"train {cfg.name}: rerun losses {rerun} against {first}, "
             "not bit-equal")
    if [h["planes_up"] for h in again] != up[spec["ckpt_at"]:]:
        fail(f"train {cfg.name}: rerun planes up differ")
    shutil.rmtree(ckpt, ignore_errors=True)
    busy = (profiled["busy_ms"] / profiled["wall_ms"]
            if profiled["busy_ms"] else None)
    out = dict(arch=cfg.name, params=param_count(params), steps=len(hist),
               losses=losses, first_before=first_before,
               first_after=first_after, unseen_before=unseen_before,
               unseen_after=unseen_after, rerun_losses=rerun,
               median_step_s=med,
               tokens_per_s=tokens / med, max_memory_allocated=peak,
               launches_per_step=per_step, held=held,
               records=[dataclasses.astuple(r)
                        for r in tr.failover.records],
               planes_up=[h["planes_up"] for h in hist],
               step_times_s=[h["step_time_s"] for h in hist],
               profile=profiled, device_busy_share=busy)
    report["train"] = out
    print(f"train {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, head_dim {cfg.head_dim}, "
          f"vocab {cfg.vocab}; {out['params']:,} float32 parameters, bf16 "
          f"cast): {len(hist)} steps of {spec['batch']} x {spec['seq']} "
          f"tokens, loss {losses[0]:.4f} -> {losses[-1]:.4f} (the first "
          f"step's batch: {first_before:.4f} -> {first_after:.4f}; an "
          f"unseen batch, not held: {unseen_before:.4f} -> "
          f"{unseen_after:.4f}); median step "
          f"{med * 1e3:.3f} ms, {tokens / med:,.0f} tokens/s, peak "
          f"{peak / 2**30:.2f} GiB; {per_step} a step; device busy "
          + ("not measured" if busy is None else f"{busy:.1%}")
          + " of a profiled step", flush=True)
    print(f"  failover: planes up {out['planes_up']}, records "
          f"{out['records']} (a CPU FailoverController's); step "
          f"{spec['held_step']}'s {held['calls']} backward calls within "
          f"{held['err']:.3g} of the largest plain gradient (bound "
          f"{BWD_TOL['bfloat16']}; max abs err over max |dO| x max |v|: "
          f"{held['err_dov']:.3g})", flush=True)
    print(f"  checkpoint at step {spec['ckpt_at']}: parameters and AdamW "
          f"state restore bit-equal; steps {spec['ckpt_at']}-"
          f"{spec['steps'] - 1} again: losses bit-equal; step times (ms) "
          f"{[round(t * 1e3, 3) for t in out['step_times_s']]}", flush=True)
    del tr, rest, params, got
    gc.collect()
    torch.cuda.empty_cache()


def llama_train(report: dict, total: dict) -> None:
    """llama3-8b at full width, TRAIN_LLAMA_LAYERS layers, remat
    "full": TRAIN_LLAMA's steps through the Trainer."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import init_params, param_count
    from repro_torch.parallel import local_ctx
    from repro_torch.train import Trainer, TrainerConfig
    spec = TRAIN_LLAMA
    cfg = dataclasses.replace(get_config("llama3-8b"),
                              n_layers=TRAIN_LLAMA_LAYERS)
    if cfg.remat != "full":
        fail(f"{cfg.name}: remat {cfg.remat!r}, expected 'full'")
    reset_peak()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        spec["seed"]), device="cuda")
    tr = Trainer(cfg, local_ctx(), TrainerConfig(
        warmup_steps=1, total_steps=spec["steps"]), params)
    build.reset_launches()
    hist = [tr.train_step(b) for _, b in zip(range(spec["steps"]),
                                             train_batches(cfg, spec))]
    torch.cuda.synchronize()
    n = cfg.n_layers
    check_launches(f"train {cfg.name} x{n} layers", dict(build.LAUNCHES),
                   {"flash_attention": 2 * n * spec["steps"],
                    "flash_attention_bwd": n * spec["steps"]}, total)
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in hist]
    if not all(np.isfinite(losses)):
        fail(f"train {cfg.name}: losses {losses}")
    out = dict(arch=cfg.name, layers=n, params=param_count(params),
               losses=losses, step_times_s=[h["step_time_s"] for h in hist],
               max_memory_allocated=peak)
    report["train_llama"] = out
    print(f"train {cfg.name} at full width, {n} layers, remat full "
          f"({out['params']:,} float32 parameters): {spec['steps']} steps of "
          f"{spec['batch']} x {spec['seq']} tokens, losses "
          f"{[round(x, 4) for x in losses]}, step times (ms) "
          f"{[round(t * 1e3, 1) for t in out['step_times_s']]}, peak "
          f"{peak / 2**30:.2f} GiB; flash_attention 2 and "
          "flash_attention_bwd 1 a layer a step", flush=True)
    del tr, params
    gc.collect()
    torch.cuda.empty_cache()


def f32_step(report: dict, total: dict) -> None:
    """One spx-100m step through `make_train_step` on the kernels and on
    the plain attention versions, from the same weights on the same
    batch: with float32 activations (no weight cast) the loss within
    1e-4 and the grad norm within 1e-3 relative; the bf16 step's
    differences printed beside them."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import init_params, standard_attention_layers
    from repro_torch.optim import adamw_init
    from repro_torch.parallel import local_ctx
    from repro_torch.train import TrainerConfig, make_train_step
    base = get_config(TRAIN_RUN["arch"])
    params = init_params(base, torch.Generator(device="cuda").manual_seed(
        33), device="cuda")
    batch = next(train_batches(base, TRAIN_RUN))
    out = {}
    for dname, cast in (("float32", False), ("bfloat16", True)):
        cfg = dataclasses.replace(base, dtype=dname)
        step = make_train_step(cfg, local_ctx(), TrainerConfig(
            warmup_steps=1, total_steps=2, cast_params_bf16=cast))
        build.reset_launches()
        _, _, mk = step(params, adamw_init(params), batch, 1)
        torch.cuda.synchronize()
        n = standard_attention_layers(cfg)
        check_launches(f"train step {cfg.name} {dname}",
                       dict(build.LAUNCHES), {"flash_attention": n,
                                              "flash_attention_bwd": n},
                       total)
        with plain_on_card():
            _, _, mp = step(params, adamw_init(params), batch, 1)
        dl = abs(float(mk["loss"]) - float(mp["loss"])) / float(mp["loss"])
        dg = abs(float(mk["grad_norm"]) - float(mp["grad_norm"])) / \
            float(mp["grad_norm"])
        out[dname] = dict(loss=float(mk["loss"]), plain_loss=float(
            mp["loss"]), loss_rel=dl, grad_norm=float(mk["grad_norm"]),
            plain_grad_norm=float(mp["grad_norm"]), grad_norm_rel=dg)
    report["train_f32_step"] = out
    f, b = out["float32"], out["bfloat16"]
    print(f"train step {base.name}, kernels against the plain attention: "
          f"float32 loss {f['loss']:.6f} vs {f['plain_loss']:.6f} "
          f"({f['loss_rel']:.3g} relative, bound 1e-4), grad norm "
          f"{f['grad_norm']:.6f} vs {f['plain_grad_norm']:.6f} "
          f"({f['grad_norm_rel']:.3g}, bound 1e-3); bfloat16 (weight cast) "
          f"loss {b['loss_rel']:.3g}, grad norm {b['grad_norm_rel']:.3g} "
          "relative (measured, not held)", flush=True)
    if not (f["loss_rel"] <= 1e-4 and f["grad_norm_rel"] <= 1e-3):
        fail(f"train step {base.name} float32: kernels against plain "
             f"{f}")
    del params
    gc.collect()
    torch.cuda.empty_cache()


def train_phase(report: dict, total: dict) -> dict:
    """The training path: TRAIN_RUN, TRAIN_LLAMA and the float32 step
    (the backward kernel's cells, `bwd_cases`, run first of all).
    Returns TRAIN_RUN's held-step gradients under "grads"."""
    import torch
    # the plain versions' float32 einsums and the float32 step run in
    # full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    keep: dict = {}
    spx_train(report, total, keep)
    llama_train(report, total)
    f32_step(report, total)
    torch.cuda.empty_cache()
    return keep


# the dp phase: `plane_allreduce` over an NCCL process group of one rank
# (a `file://` store in a temporary directory; its mesh from
# `make_mesh_for(1, 1)`) on TRAIN_RUN's held-step gradients under
# TRAIN_RUN's plane config (4 planes, 16 micro-chunks) and the Trainer's
# key for that step; each mode timed over DP_REPEATS calls; the DP train
# step at world 1; then llama3-8b cut as TRAIN_LLAMA under REMAT_RUNS.
DP_PLANES = dict(n_planes=4, microchunks=16)
DP_REPEATS = 5
REMAT_RUNS = ("full", "dots", "kv")


@contextmanager
def held_codec(stats: dict):
    """Every codec launch through `kernels.ops` while the block runs held
    to its plain version on the call's own inputs, bit for bit (`fail`
    otherwise); `stats[kernel]` counts the calls by (R, C)."""
    import torch
    from repro_torch.kernels import ops, ref
    encode, decode = ops.int8_encode, ops.int8_decode

    def same(got, want) -> bool:
        return all(g.dtype == w.dtype and g.shape == w.shape and
                   torch.equal(g.view(torch.uint8), w.view(torch.uint8))
                   for g, w in zip(got, want))

    def count(kernel, x):
        by = stats.setdefault(kernel, {})
        by[tuple(x.shape)] = by.get(tuple(x.shape), 0) + 1

    def held_encode(x, noise):
        got = encode(x, noise)
        if not same(got, ref.int8_encode_ref(x, noise)):
            fail(f"int8_encode at {tuple(x.shape)} on the dp path differs "
                 "from its plain version")
        count("int8_encode", x)
        return got

    def held_decode(q, scale, **kw):
        got = decode(q, scale, **kw)
        if not same((got,), (ref.int8_decode_ref(q, scale, **kw),)):
            fail(f"int8_decode at {tuple(q.shape)} on the dp path differs "
                 "from its plain version")
        count("int8_decode", q)
        return got

    ops.int8_encode, ops.int8_decode = held_encode, held_decode
    try:
        yield
    finally:
        ops.int8_encode, ops.int8_decode = encode, decode


def codec_chunks(leaves, microchunks: int) -> dict:
    """{(R, C): [chunks]} of the chunks `plane_allreduce`'s int8 mode
    compresses at world 1, by their (rows, last dim) view: each chunk of
    a leaf of two or more dims and more than `microchunks` elements."""
    from repro_torch.core.collectives import _chunk_bounds, _scatter_dim
    out: dict = {}
    for x in leaves:
        if x.ndim == 0 or x.numel() <= microchunks:
            continue
        for lo, hi in _chunk_bounds(x.shape[0], microchunks):
            c = x[lo:hi]
            if 0 <= _scatter_dim(tuple(c.shape), 1) < c.ndim - 1:
                out.setdefault((c.numel() // c.shape[-1], c.shape[-1]),
                               []).append(c)
    return out


def dp_allreduce(ctx, grads, total: dict, smi: str) -> dict:
    """`plane_allreduce` of `grads` in each mode over the context's data
    group: psum and rs_ag bit-equal to the gradients, rs_ag_int8 with
    one encode and one decode launch a compressed chunk (each held to
    its plain version) and every element within one code step of its
    gradient row; each mode's wall (CUDA events); the codec kernels at
    each chunk shape against their plain versions and the bound."""
    import torch
    from repro_torch.core.collectives import (MODES, chunk_noise, fold_seed,
                                              plane_allreduce)
    from repro_torch.core.planes import PlaneConfig
    from repro_torch.kernels import build, ops, ref
    from repro_torch.models import tree_leaves
    group = ctx.group(("data",))
    pcfg = PlaneConfig(**DP_PLANES)
    key = fold_seed(17, TRAIN_RUN["held_step"])
    leaves = tree_leaves(grads)
    by_shape = codec_chunks(leaves, pcfg.microchunks)
    shapes = {rc: len(cs) for rc, cs in by_shape.items()}
    chunks = sum(shapes.values())
    stats: dict = {}
    walls, profiles = {}, {}
    for mode in MODES:
        build.reset_launches()
        held = held_codec(stats) if mode == "rs_ag_int8" else \
            contextlib.nullcontext()
        with held:
            got = tree_leaves(plane_allreduce(grads, group, pcfg, key=key,
                                              mode=mode))
        torch.cuda.synchronize()
        want = ({"int8_encode": chunks, "int8_decode": chunks}
                if mode == "rs_ag_int8" else {})
        check_launches(f"dp plane_allreduce {mode}", dict(build.LAUNCHES),
                       want, total)
        if mode != "rs_ag_int8":
            if not all(torch.equal(a, b) for a, b in zip(got, leaves)):
                fail(f"dp plane_allreduce {mode} at world 1 does not return "
                     "the gradients bit for bit")
        else:
            worst = 0.0
            for a, b in zip(got, leaves):
                if b.ndim < 2:
                    if not torch.equal(a, b):
                        fail("dp rs_ag_int8: an uncompressed leaf changed")
                    continue
                step = b.abs().amax(-1, keepdim=True) / 127
                worst = max(worst, float(((a - b).abs() / step.clamp_min(
                    1e-30)).max()))
            if not worst <= 1 + 1e-5:
                fail(f"dp rs_ag_int8: an element {worst:.4g} code steps "
                     "from its gradient")
            if stats.get("int8_encode") != shapes or \
                    stats.get("int8_decode") != shapes:
                fail(f"dp rs_ag_int8: codec calls {stats}, expected {shapes}")
        del got

        def call(mode=mode):
            return plane_allreduce(grads, group, pcfg, key=key, mode=mode)

        walls[mode] = event_ms(call, repeats=DP_REPEATS)
        _, profiles[mode] = device_profile(f"plane_allreduce {mode}", call)
    build.reset_launches()
    rows = []
    # each shape's first chunk of the gradients, the largest shapes first
    for (R, C), cs in sorted(by_shape.items(),
                             key=lambda kv: -kv[0][0] * kv[0][1]):
        n = len(cs)
        x = cs[0].reshape(R, C).contiguous()
        noise = chunk_noise(key, 1, (R, C), "cuda")
        q, sc = ops.int8_encode(x, noise)
        row = dict(shape=(R, C), chunks=n)
        for kernel, run, plain, library, nbytes, flops in (
                ("int8_encode", lambda: ops.int8_encode(x, noise),
                 lambda: ref.int8_encode_ref(x, noise), None,
                 R * C * (4 + 4 + 1) + R * 4, CODEC_FLOPS["int8_encode"]),
                ("int8_decode", lambda: ops.int8_decode(q, sc),
                 lambda: ref.int8_decode_ref(q, sc), lambda: q * sc,
                 R * C * (1 + 4) + R * 4, CODEC_FLOPS["int8_decode"])):
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = flops * R * C / PEAK_FLOPS["float32"] * 1e3
            row[kernel] = dict(
                ms=graph_ms(run), plain_ms=event_ms(plain),
                library_ms=None if library is None else graph_ms(library),
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        rows.append(row)
    build.reset_launches()
    calls = {k: sum(r["chunks"] * r[k]["ms"] for r in rows)
             for k in ("int8_encode", "int8_decode")}
    bound = {k: sum(r["chunks"] * r[k]["bound_ms"] for r in rows)
             for k in ("int8_encode", "int8_decode")}
    n_el = sum(x.numel() for x in leaves)
    print(f"dp plane_allreduce of {TRAIN_RUN['arch']}'s step-"
          f"{TRAIN_RUN['held_step']} gradients ({len(leaves)} leaves, "
          f"{n_el:,} float32; {DP_PLANES}) over an NCCL group of 1 rank: "
          + ", ".join(f"{m} {walls[m]:.3f} ms" for m in MODES)
          + f" a call (CUDA events, median of {DP_REPEATS}); psum and "
          f"rs_ag bit-equal to the gradients; rs_ag_int8 {chunks} encode "
          f"and {chunks} decode launches a call, each bit-equal to its plain"
          f" version, every element within one code step ({smi})",
          flush=True)
    for r in rows:
        e, d = r["int8_encode"], r["int8_decode"]
        print(f"  codec at {r['shape'][0]}x{r['shape'][1]} x{r['chunks']} a "
              f"call: encode ms={e['ms']:.6f} plain_ms={e['plain_ms']:.6f} "
              f"bound_ms={e['bound_ms']:.6f}; decode ms={d['ms']:.6f} "
              f"plain_ms={d['plain_ms']:.6f} library_ms="
              f"{d['library_ms']:.6f} bound_ms={d['bound_ms']:.6f}",
              flush=True)
    print(f"  codec a call: encode {calls['int8_encode']:.3f} ms (bound "
          f"{bound['int8_encode']:.3f}), decode {calls['int8_decode']:.3f} "
          f"ms (bound {bound['int8_decode']:.3f}), summed over the chunks "
          f"({smi})", flush=True)
    return dict(walls_ms=walls, profiles=profiles, chunks=chunks,
                codec_rows=rows,
                codec_ms_per_call=calls, codec_bound_ms_per_call=bound,
                elements=n_el)


def dp_step(ctx, total: dict) -> dict:
    """TRAIN_RUN's config: one step through `make_train_step` over the
    world-1 mesh and one without a mesh, from the same weights on the
    same batch: bit-equal (the plane axes of size 1 are dropped)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.planes import PlaneConfig
    from repro_torch.kernels import build
    from repro_torch.models import (init_params, standard_attention_layers,
                                    tree_leaves)
    from repro_torch.optim import adamw_init
    from repro_torch.parallel import local_ctx
    from repro_torch.train import TrainerConfig, make_train_step
    cfg = get_config(TRAIN_RUN["arch"])
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        34), device="cuda")
    batch = next(train_batches(cfg, TRAIN_RUN))
    tcfg = TrainerConfig(plane=PlaneConfig(**DP_PLANES), warmup_steps=1,
                         total_steps=2)
    runs = []
    n = standard_attention_layers(cfg)
    for c in (ctx, local_ctx()):
        build.reset_launches()
        p2, st, m = make_train_step(cfg, c, tcfg)(
            params, adamw_init(params), batch, 1, 5)
        torch.cuda.synchronize()
        check_launches(f"dp step {cfg.name}", dict(build.LAUNCHES),
                       {"flash_attention": n, "flash_attention_bwd": n},
                       total)
        runs.append(tree_leaves(p2) + tree_leaves(st) +
                    [m["loss"], m["grad_norm"]])
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        fail(f"dp step {cfg.name}: the step over the world-1 mesh differs "
             "from the step without a mesh")
    print(f"dp step {cfg.name} over the world-1 mesh: parameters, AdamW "
          "state, loss and grad norm bit-equal to the step without a mesh",
          flush=True)
    return dict(bit_equal=True)


def remat_runs(total: dict, smi: str) -> dict:
    """llama3-8b at full width cut to TRAIN_LLAMA_LAYERS layers, under
    each of REMAT_RUNS: TRAIN_LLAMA's steps through `make_train_step`
    (the first a warm-up; peak memory over all of them), then, once
    every policy's steps have run, the first batch's gradients through
    `make_grad_fn` against "full"'s (bit-equal, else within BWD_TOL of
    each leaf's largest), with every flash forward launch's outputs
    recorded: each recomputed launch must equal one of the first
    forward's bit for bit."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import init_params, tree_leaves
    from repro_torch.optim import adamw_init
    from repro_torch.parallel import local_ctx
    from repro_torch.train import TrainerConfig, make_train_step
    from repro_torch.train.loop import make_grad_fn
    spec = TRAIN_LLAMA
    base = dataclasses.replace(get_config("llama3-8b"),
                               n_layers=TRAIN_LLAMA_LAYERS)
    n = base.n_layers
    params = init_params(base, torch.Generator(device="cuda").manual_seed(
        spec["seed"]), device="cuda")
    batches = [b for _, b in zip(range(spec["steps"]),
                                 train_batches(base, spec))]
    tcfg = TrainerConfig(warmup_steps=1, total_steps=spec["steps"])
    out = {}
    for remat in REMAT_RUNS:
        cfg = dataclasses.replace(base, remat=remat)
        step = make_train_step(cfg, local_ctx(), tcfg)
        reset_peak()
        build.reset_launches()
        p, st = params, adamw_init(params)
        times = []
        for i, batch in enumerate(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, st, m = step(p, st, batch, i)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        check_launches(f"train {cfg.name} x{n} remat {remat}",
                       dict(build.LAUNCHES),
                       {"flash_attention": 2 * n * len(batches),
                        "flash_attention_bwd": n * len(batches)}, total)
        out[remat] = dict(step_ms=times, peak=peak, loss=float(m["loss"]))
        del p, st, m
    ref_grads = None
    for remat in REMAT_RUNS:
        cfg = dataclasses.replace(base, remat=remat)
        launched = []
        launch = fa._launch

        def recorded(*args):
            got = launch(*args)
            launched.append(tuple(t.clone() for t in got))
            return got

        fa._launch = recorded
        try:
            _, grads = make_grad_fn(cfg, local_ctx(), tcfg)(params,
                                                            batches[0])
            torch.cuda.synchronize()
        finally:
            fa._launch = launch
        # the backward recomputes the periods last first: match each
        # recomputed launch with a first-forward one, each used once
        first = launched[:n]
        for again in launched[n:]:
            hit = next((i for i, f in enumerate(first) if all(
                a.shape == b.shape and torch.equal(a, b)
                for a, b in zip(f, again))), None)
            if hit is None:
                fail(f"remat {remat}: a recomputed flash forward differs "
                     "from every launch of the first forward")
            first.pop(hit)
        if len(launched) != 2 * n:
            fail(f"remat {remat}: {len(launched)} flash forward launches, "
                 f"expected {2 * n}")
        del launched, first
        grads = tree_leaves(grads)
        if ref_grads is None:
            ref_grads, err, bits = grads, 0.0, True
        else:
            bits = all(torch.equal(a, b) for a, b in zip(grads, ref_grads))
            err = max(float((a - b).abs().max()) / max(
                float(b.abs().max()), 1e-30)
                for a, b in zip(grads, ref_grads))
            if not err <= BWD_TOL["bfloat16"]:
                fail(f"remat {remat}: gradients {err:.3g} of the largest "
                     "from remat full's")
        del grads
        o = out[remat]
        o.update(grads_bit_equal_full=bits, grads_err_full=err)
        warm = float(np.median(o["step_ms"][1:]))
        print(f"remat {remat}: {base.name} x{n} layers at full width, "
              f"{spec['batch']} x {spec['seq']} tokens: step ms "
              f"{[round(t, 3) for t in o['step_ms']]} (median after the "
              f"first {warm:.3f}), peak {o['peak'] / 2**30:.2f} GiB, loss "
              f"{o['loss']:.4f}; flash forward twice a layer (recomputed "
              "outputs bit-equal to the first forward's); first-batch "
              "gradients "
              + ("bit-equal to remat full's" if bits else
                 f"within {err:.3g} of remat full's (bound "
                 f"{BWD_TOL['bfloat16']})") + f" ({smi})", flush=True)
    del ref_grads, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dp_phase(report: dict, total: dict, grads) -> None:
    """The data-parallel path at world 1 on the card (`dp_allreduce`,
    `dp_step`) over an NCCL process group, no fallback; then remat
    "dots" and "kv" (`remat_runs`)."""
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.parallel import ShardCtx
    smi = card()
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            ctx = ShardCtx(make_mesh_for(1, 1))
            out = dp_allreduce(ctx, grads, total, smi)
            del grads
            out["step"] = dp_step(ctx, total)
        finally:
            dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    out["remat"] = remat_runs(total, smi)
    report["dp"] = out


# the tp phase: phi3.5-moe at full width, 2 layers, bf16 activations:
# a loss over one batch of `tokens` and a serve run; deepseek-v2 (MLA)
# at full width cut to its dense prefix layer and one MoE layer, the
# same; mamba2-780m at full width and depth: the gradients of the first
# batch, `steps` steps and a serve run; llama3-8b at full width, 2
# layers: the gradients of the first batch and `steps` steps under TP
# and under FSDP over "data" (FSDP_LLAMA takes TP_LLAMA's spec)
TP_SERVE = dict(batch=2, max_len=544, prompts=(512, 512), max_new=16)
TP_MOE = dict(arch="phi3.5-moe-42b-a6.6b", layers=2, tokens=2048, seed=38,
              serve=dict(TP_SERVE, seed=39))
TP_MLA = dict(arch="deepseek-v2-236b", layers=2, tokens=2048, seed=41,
              serve=dict(TP_SERVE, seed=42))
TP_SSM = dict(arch="mamba2-780m", layers=48, steps=2, batch=1, seq=1024,
              seed=43, serve=dict(TP_SERVE, seed=44))
TP_LLAMA = dict(arch="llama3-8b", layers=2, steps=2, batch=1, seq=2048,
                seed=40)
COLLECTIVES = ("all_reduce", "all_gather_into_tensor",
               "reduce_scatter_tensor", "all_to_all_single", "all_gather")


@contextmanager
def counted_collectives(counts: dict):
    """Every `torch.distributed` collective the block issues, counted
    by name into `counts`."""
    import torch.distributed as dist
    saved = {n: getattr(dist, n) for n in COLLECTIVES}

    def counted(name, fn):
        def call(*args, **kwargs):
            counts[name] = counts.get(name, 0) + 1
            return fn(*args, **kwargs)
        return call

    for n, fn in saved.items():
        setattr(dist, n, counted(n, fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(dist, n, fn)


def bit_equal(what: str, got, want) -> None:
    """`fail` unless the two lists of tensors are equal bit for bit."""
    import torch
    bad = [i for i, (a, b) in enumerate(zip(got, want))
           if a.shape != b.shape or not torch.equal(a, b)]
    if len(got) != len(want) or bad:
        i = bad[0] if bad else None
        err = (float((got[i].float() - want[i].float()).abs().max())
               if bad and got[i].shape == want[i].shape else None)
        fail(f"{what}: {len(bad)} of {len(want)} tensors differ from the "
             f"run without a mesh (first {i}, max abs err {err})")


def tp_model(spec: dict):
    """(cfg, params on the card from the spec's seed) of a tp-phase run:
    the arch at full width, cut to the spec's layers."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = dataclasses.replace(get_config(spec["arch"]),
                              n_layers=spec["layers"])
    return cfg, init_params(cfg, torch.Generator(device="cuda").manual_seed(
        spec["seed"]), device="cuda")


def tp_loss(cfg, params, local, ctx, spec, total, worst) -> dict:
    """A no-grad `loss_fn` over one batch of the spec's tokens, through
    `ctx` on the rank's slices `local` and without a mesh on `params`:
    loss, CE and aux bit-equal; walls and collectives."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.models import loss_fn, standard_attention_layers
    from repro_torch.models.moe import moe_mode
    from repro_torch.parallel import local_ctx
    if cfg.moe_experts:
        mode = moe_mode(cfg, ctx, spec["tokens"])
        if mode != "a2a":
            fail(f"tp {cfg.name}: MoE mode {mode}, expected a2a")
    g = torch.Generator(device="cuda").manual_seed(spec["seed"])
    toks = torch.randint(0, cfg.vocab, (1, spec["tokens"] + 1),
                         generator=g, device="cuda", dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    n = standard_attention_layers(cfg)
    losses = []
    counts: dict = {}
    with torch.no_grad():               # a warm-up: the first call's setup
        loss_fn(params, cfg, batch, local_ctx())
    with held_on_card(ATTN_TOL["bfloat16"], worst):
        for c in (ctx, local_ctx()):
            build.reset_launches()
            with torch.no_grad(), counted_collectives(
                    counts if c is ctx else {}):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss, m = loss_fn(local if c is ctx else params, cfg, batch,
                                  c)
                torch.cuda.synchronize()
            check_launches(f"tp {cfg.name} loss", dict(build.LAUNCHES),
                           {"flash_attention": n}, total)
            losses.append((loss, m["ce"], m["aux"],
                           time.perf_counter() - t0))
    bit_equal(f"tp {cfg.name} loss, ce and aux", list(losses[0][:3]),
              list(losses[1][:3]))
    return dict(loss=float(losses[0][0]), aux=float(losses[0][2]),
                loss_ms=losses[0][3] * 1e3,
                loss_ms_no_mesh=losses[1][3] * 1e3, loss_collectives=counts)


def tp_serve(cfg, params, local, ctx, spec, total, worst,
             profile: bool = False) -> dict:
    """`ServeEngine` over the spec's prompts through `ctx` on `local` and
    without a mesh on `params`: every prefill's and step's logits and
    the tokens bit-equal; walls and collectives.  With `profile`, one
    more decode step of each run on its last caches under
    `device_profile` (its launches not counted)."""
    import numpy as np
    import torch
    from repro_torch.kernels import build
    from repro_torch.models import standard_attention_layers
    from repro_torch.parallel import local_ctx
    n = standard_attention_layers(cfg)
    recs, profiles = [], {}
    with held_on_card(ATTN_TOL["bfloat16"], worst):
        for c in (ctx, local_ctx()):
            build.reset_launches()
            counts: dict = {}
            with counted_collectives(counts if c is ctx else {}):
                rec = serve_engine(cfg, local if c is ctx else params,
                                   spec, ctx=c)
            check_launches(f"tp {cfg.name} serve", dict(build.LAUNCHES),
                           {"flash_attention": n * len(rec["prefill"]),
                            "decode_attention": n * len(rec["decode"])},
                           total)
            if profile:
                label = "TP" if c is ctx else "no mesh"
                profiles[label] = decode_profile(
                    cfg, local if c is ctx else params, rec, c,
                    f"a {cfg.name} decode step ({label})")
                build.reset_launches()
            recs.append(dict(rec, collectives=counts, caches=None))
    tp, one = recs
    bit_equal(f"tp {cfg.name} serve logits", tp["prefill"] + tp["decode"],
              one["prefill"] + one["decode"])
    if tp["outs"] != one["outs"]:
        fail(f"tp {cfg.name} serve: tokens {tp['outs']} against "
             f"{one['outs']} without a mesh")
    return dict(prefill_ms=[t * 1e3 for t in tp["prefill_s"]],
                prefill_ms_no_mesh=[t * 1e3 for t in one["prefill_s"]],
                decode_ms_median=float(np.median(tp["decode_s"])) * 1e3,
                decode_ms_median_no_mesh=float(
                    np.median(one["decode_s"])) * 1e3,
                decode_steps=len(tp["decode"]), prefills=len(tp["prefill"]),
                serve_collectives=tp["collectives"], profiles=profiles)


def fmt_serve(out: dict, spec: dict) -> str:
    return (f"serve {len(spec['prompts'])} prompts of {spec['prompts']} "
            f"tokens, prefill ms {[round(t, 1) for t in out['prefill_ms']]}"
            f" (without a mesh "
            f"{[round(t, 1) for t in out['prefill_ms_no_mesh']]}), "
            f"{out['decode_steps']} decode steps median "
            f"{out['decode_ms_median']:.2f} ms (without a mesh "
            f"{out['decode_ms_median_no_mesh']:.2f}), collectives "
            f"{out['serve_collectives']} ({out['prefills']} prefills, "
            f"{out['decode_steps']} steps)")


def tp_loss_serve(spec: dict, ctx, total: dict, worst: dict) -> dict:
    """TP_MOE or TP_MLA through the TP path and without a mesh (module
    docstring): `tp_loss`, then `tp_serve`."""
    import torch
    from repro_torch.models import param_count, param_specs
    from repro_torch.parallel import shard_params
    reset_peak()
    cfg, params = tp_model(spec)
    local = shard_params(params, param_specs(cfg, ctx))
    n = cfg.n_layers
    out = dict(arch=cfg.name, layers=n, params=param_count(params))
    out.update(tp_loss(cfg, params, local, ctx, spec, total, worst))
    out.update(tp_serve(cfg, params, local, ctx, spec["serve"], total,
                        worst))
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    print(f"tp {cfg.name} x{n} layers over the world-1 mesh "
          f"({out['params']:,} float32 parameters): loss over "
          f"{spec['tokens']} tokens (a2a) {out['loss']:.6f}, aux "
          f"{out['aux']:.6f}, {out['loss_ms']:.1f} ms (without a mesh "
          f"{out['loss_ms_no_mesh']:.1f}), collectives "
          f"{out['loss_collectives']}; {fmt_serve(out, spec['serve'])}; "
          f"peak {out['max_memory_allocated'] / 2**30:.2f} GiB; loss, aux, "
          "logits and tokens bit-equal to the run without a mesh",
          flush=True)
    del params, local
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_train(spec: dict, ctxs: dict, total: dict, worst: dict,
             serve: bool = False) -> dict:
    """The spec's model through `make_grad_fn` (the first batch's loss
    and gradients) and `spec["steps"]` steps of `make_train_step`
    (metrics, parameters, AdamW state) without a mesh and through each
    context of `ctxs` (label: context) on its slices, each bit-equal to
    the run without a mesh; every flash forward and backward launch held
    to its plain version.  With `serve`, then `tp_serve` through each
    context, a decode step of each run profiled."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.models import (param_count, param_specs,
                                    standard_attention_layers, tree_leaves)
    from repro_torch.optim import adamw_init
    from repro_torch.parallel import gather_params, local_ctx, shard_params
    from repro_torch.train import TrainerConfig, make_train_step
    from repro_torch.train.loop import make_grad_fn
    reset_peak()
    cfg, params = tp_model(spec)
    batches = [b for _, b in zip(range(spec["steps"]),
                                 train_batches(cfg, spec))]
    tcfg = TrainerConfig(warmup_steps=1, total_steps=spec["steps"])
    n = standard_attention_layers(cfg)
    labels = ["no mesh"] + list(ctxs)
    ctx_of = dict(ctxs, **{"no mesh": local_ctx()})
    bwd: dict = {}
    grads, runs, walls, counts = {}, {}, {}, {}
    with held_on_card(ATTN_TOL["bfloat16"], worst), held_bwd(bwd):
        for label in labels:
            c = ctx_of[label]
            specs = param_specs(cfg, c) if c.mesh is not None else None
            p = params if specs is None else shard_params(params, specs)
            build.reset_launches()
            loss, g = make_grad_fn(cfg, c, tcfg)(p, batches[0])
            torch.cuda.synchronize()
            check_launches(f"tp {cfg.name} grads ({label})",
                           dict(build.LAUNCHES),
                           {"flash_attention": 2 * n,
                            "flash_attention_bwd": n}, total)
            if specs is not None:
                g = gather_params(g, specs)
            grads[label] = [t.cpu() for t in [loss] + tree_leaves(g)]
            del g
            # the results go to the host and the slices are dropped after
            # each run, so the card holds one run's state at a time
            step = make_train_step(cfg, c, tcfg)
            opt = adamw_init(p)
            metrics, times, counts[label] = [], [], {}
            build.reset_launches()
            for i, b in enumerate(batches):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with counted_collectives(counts[label] if i == 0 else {}):
                    p, opt, m = step(p, opt, b, i + 1)
                    torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                metrics += [m["loss"], m["grad_norm"], m["lr_scale"]]
            check_launches(f"tp {cfg.name} steps ({label})",
                           dict(build.LAUNCHES),
                           {"flash_attention": 2 * n * len(batches),
                            "flash_attention_bwd": n * len(batches)},
                           total)
            if specs is not None:
                p = gather_params(p, specs)
                opt = dict(opt, m=gather_params(opt["m"], specs),
                           v=gather_params(opt["v"], specs))
            runs[label] = [t.cpu() for t in metrics + tree_leaves(p) +
                           tree_leaves(opt)]
            walls[label] = times
            del p, opt
            gc.collect()
            torch.cuda.empty_cache()
    out = dict(arch=cfg.name, layers=cfg.n_layers,
               params=param_count(params), bwd=bwd,
               losses=[float(x) for x in
                       runs["no mesh"][:3 * len(batches):3]],
               step_ms_no_mesh=[t * 1e3 for t in walls["no mesh"]])
    for label in ctxs:
        bit_equal(f"tp {cfg.name} ({label}) loss and gradients",
                  grads[label], grads["no mesh"])
        bit_equal(f"tp {cfg.name} ({label}) steps: metrics, parameters and "
                  "AdamW state", runs[label], runs["no mesh"])
        out[label] = dict(step_ms=[t * 1e3 for t in walls[label]],
                          step_collectives=counts[label])
    del grads, runs
    if serve:
        for label, c in ctxs.items():
            local = shard_params(params, param_specs(cfg, c))
            out[label].update(tp_serve(cfg, params, local, c, spec["serve"],
                                       total, worst, profile=True))
            del local
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    for label in ctxs:
        o = out[label]
        print(f"tp {cfg.name} x{cfg.n_layers} layers over the world-1 mesh "
              f"({label}; {out['params']:,} float32 parameters): gradients "
              f"of {spec['batch']} x {spec['seq']} tokens and "
              f"{len(batches)} steps bit-equal to the run without a mesh "
              f"(losses {[round(x, 4) for x in out['losses']]}); step ms "
              f"{[round(t, 1) for t in o['step_ms']]} (without a mesh "
              f"{[round(t, 1) for t in out['step_ms_no_mesh']]}); "
              f"collectives a step {o['step_collectives']}"
              + (f"; {fmt_serve(o, spec['serve'])}, logits and tokens "
                 "bit-equal" if serve else "") +
              f"; flash_attention_bwd calls held {bwd.get('calls')} (worst "
              f"{bwd.get('err', 0.0):.3g}); peak "
              f"{out['max_memory_allocated'] / 2**30:.2f} GiB", flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_phase(report: dict, total: dict) -> None:
    """Tensor parallelism and FSDP at world 1 on the card over an NCCL
    process group, no fallback: `tp_loss_serve` of TP_MOE and TP_MLA,
    `tp_train` of TP_SSM (with serving) and of TP_LLAMA under TP and
    under FSDP (FSDP_LLAMA)."""
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.launch.specs import make_ctx
    smi = card()
    torch.cuda.set_device(0)
    t0 = time.perf_counter()
    worst: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            mesh = make_mesh_for(1, 1)
            ctx = make_ctx(mesh, fsdp=False)
            fsdp = make_ctx(mesh, fsdp=True)
            out = dict(moe=tp_loss_serve(TP_MOE, ctx, total, worst),
                       mla=tp_loss_serve(TP_MLA, ctx, total, worst),
                       ssm=tp_train(TP_SSM, {"TP": ctx}, total, worst,
                                    serve=True),
                       llama=tp_train(TP_LLAMA, {"TP": ctx, "FSDP": fsdp},
                                      total, worst))
        finally:
            dist.destroy_process_group()
    out.update(held=worst, wall_s=time.perf_counter() - t0, card=smi)
    report["tp"] = out
    print(f"tp phase: {out['wall_s']:.1f} s on {smi}; attention calls held "
          f"to their plain versions {worst}", flush=True)


# the profile phase's loops: (scenario, routing, dtypes)
PROFILE_RUNS = (("giga_fabric_storage", "ar", ("float64", "float32")),
                ("giga_fabric_storage", "ecmp", ("float64", "float32")),
                ("giga_fat_tree", "war", ("float64",)),
                ("giga_fat_tree", "ecmp", ("float64",)),
                ("giga_fabric_storage_reroute", None, ("float64",)))


def profile_phase(report: dict) -> None:
    """Where a giga slot's time goes: `torch.profiler` over the slot loop
    (12 slots, host prep excluded) of each PROFILE_RUNS loop, eager and
    captured (the captured loop's replays of slots 1..11; its capture
    runs before the profiler starts).  Device busy share = summed kernel
    time / loop wall.  Prints "not measured" when the profiler records
    no device activity."""
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

    for name, routing, dnames in PROFILE_RUNS:
        c = compile_scenario(scenario(name, routing).with_sim(slots=slots))
        for dname in dnames:
            dtype = getattr(torch, dname)
            cfg, _, ops = engine.prepare(c, "cuda", dtype)
            for captured in (False, True):
                kind = "captured" if captured else "eager"
                what = f"{label(name, routing)} {dname} " \
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
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}"
              "; run it from a checkout of the repo", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.netsim import graph

    smi = card()
    print(smi, flush=True)
    t0 = time.perf_counter()
    build.library()
    print(f"build: nvcc {build.build_seconds:.2f} s (both sources), "
          f"library loaded after "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    print(f"build: {sass_check()}", flush=True)

    report = {"nvidia_smi": smi, "device": torch.cuda.get_device_name(0)}
    # the backward's cells first: after the phases below, profiles of
    # its three kernels came back without device events (PERF.md, PR
    # 30), where a fresh process sees them all
    bwd_summary: dict = {}
    bwd_cases(report, bwd_summary)
    summary = kernel_phase(report)
    summary.update(bwd_summary)
    sync_phase()
    total: dict = {}
    # each phase starts from an empty graph cache, so its first run of a
    # structure captures as it did before the cache
    for phase in (registry_phase, scale_phase, sparse_phase, compact_phase,
                  schedule_phase, trace_phase, batch_phase, sweep_phase,
                  packet_phase):
        graph.clear_graph_cache()
        phase(report, total)
    graph.clear_graph_cache()
    model_phase(report, total, summary)
    serve_phase(report, total)
    kept = train_phase(report, total)
    dp_phase(report, total, kept.pop("grads"))
    tp_phase(report, total)
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
