"""Rank processes for the port's data- and tensor-parallel CPU tests.

`start_ranks(fn, world, *args)` spawns `world` processes with
`torch.multiprocessing` (the spawn method), each of which joins a gloo
process group of `world` ranks through a `file://` store in a fresh
temporary directory, runs `fn(rank, world, *args)` on one CPU thread,
saves what it returns with `torch.save` and leaves the group.
`RankGroup.results()` waits for them (with a timeout) and returns the
ranks' results in rank order.  Several groups may run at once: each has
its own store.

The rank functions live here, not in the test files, so a rank process
imports torch and the port and nothing of JAX.
"""
from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import ARCHS
from repro_torch.core import collectives
from repro_torch.core.collectives import MODES, plane_allreduce
from repro_torch.core.planes import PlaneConfig
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.launch.specs import make_ctx
from repro_torch.models import (decode_step, init_caches, loss_fn, moe,
                                param_specs, prefill_step, tree_items,
                                tree_leaves, tree_map)
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel import (ShardCtx, gather_params, local_ctx,
                                  shard_params, tp)
from repro_torch.parallel.sharding import mesh_group
from repro_torch.train import (Request, ServeEngine, Trainer, TrainerConfig,
                               make_train_step)
from repro_torch.train.loop import batch_axes, make_grad_fn


def _rank_main(rank, fn, world, store, out, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        result = fn(rank, world, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(out, f"{rank}.pt"))


class RankGroup:
    """`world` rank processes running one function (`start_ranks`)."""

    def __init__(self, fn, world: int, args: tuple):
        self._dir = tempfile.TemporaryDirectory()
        self.world = world
        self._ctx = mp.start_processes(
            _rank_main, args=(fn, world, os.path.join(self._dir.name,
                                                      "store"),
                              self._dir.name, args),
            nprocs=world, join=False, start_method="spawn")

    def results(self, timeout: float = 120.0) -> list:
        """The ranks' results in rank order; raises if a rank failed or
        the group outlives `timeout` seconds (its processes are then
        killed)."""
        try:
            end = time.monotonic() + timeout
            while not self._ctx.join(timeout=1.0):
                if time.monotonic() > end:
                    raise TimeoutError(f"{self.world} ranks still running "
                                       f"after {timeout} s")
            return [torch.load(os.path.join(self._dir.name, f"{r}.pt"))
                    for r in range(self.world)]
        finally:
            for p in self._ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(5)
            self._dir.cleanup()


def start_ranks(fn, world: int, *args) -> RankGroup:
    return RankGroup(fn, world, args)


def dp_mesh(world: int):
    """The data-parallel mesh of `world` ranks the tests use: (data 2,
    model 1) at 2, (pod 2, data world / 2, model 1) above, with the
    context over its DP dims."""
    if world <= 2:
        mesh = make_mesh_for(world, 1)
        return mesh, ShardCtx(mesh, dp_axes=("data",))
    mesh = make_mesh_for(world, 1, pods=2)
    return mesh, ShardCtx(mesh, dp_axes=("pod", "data"))


# ---------------------------------------------------------------------------
# plane_allreduce
# ---------------------------------------------------------------------------

def allreduce_rank(rank, world, inputs: str, noise: str, microchunks: int,
                   seed: int):
    """`plane_allreduce` of this rank's leaves (`inputs`: an npz with
    "{rank}/{i}") over the world in each mode.  The int8 mode runs twice:
    with the port's own noise and with the draws in `noise` (an npz
    "{kidx}") in place of `chunk_noise`.  Returns {mode: [leaves]}, the
    int8 run on the given draws under "rs_ag_int8_ref"."""
    with np.load(inputs) as z:
        n = len([k for k in z.files if k.startswith(f"{rank}/")])
        leaves = [torch.from_numpy(z[f"{rank}/{i}"]) for i in range(n)]
    before = [x.clone() for x in leaves]
    _, ctx = dp_mesh(world)
    group = ctx.group(ctx.plane_axes)
    cfg = PlaneConfig(n_planes=4, microchunks=microchunks)
    out = {}
    for mode in MODES:
        out[mode] = plane_allreduce(leaves, group, cfg, key=seed, mode=mode)
    with np.load(noise) as z:
        draws = {int(k): z[k] for k in z.files}

    def given(seed_, kidx, shape, device):
        assert tuple(shape) == draws[kidx].shape, (kidx, shape)
        return torch.from_numpy(draws[kidx]).to(device)

    own = collectives.chunk_noise
    collectives.chunk_noise = given
    try:
        out["rs_ag_int8_ref"] = plane_allreduce(leaves, group, cfg,
                                                key=seed, mode="rs_ag_int8")
    finally:
        collectives.chunk_noise = own
    out["default"] = plane_allreduce(leaves, group, cfg, key=seed)
    assert all(torch.equal(a, b) for a, b in zip(leaves, before))
    return out


# ---------------------------------------------------------------------------
# the data-parallel train step and the meshes
# ---------------------------------------------------------------------------

def dp_rank(rank, world, params_path: str, batch: dict, arch: str,
            key: int):
    """What the DP tests need from a world of 1, 2 or 4 ranks: the
    meshes (`_meshes`), and at world 1 the step over `make_mesh_for(1,
    1)` against the step without a mesh (`_world_one`), at world 4 the
    DP step (`_dp_step`)."""
    out = {"meshes": _meshes(world)}
    if world in (1, 4):
        params = torch.load(params_path)
        cfg = ARCHS[arch].reduced(dtype="float32")
        run = _world_one if world == 1 else _dp_step
        out.update(run(world, cfg, params, batch, key))
    return out


def _dp_step(world, cfg, params, batch: dict, key: int):
    """The DP step of `cfg` over `dp_mesh(world)` on the global `batch`:
    the synced (loss, grads) of `make_grad_fn` under each compression
    ("none" is psum, "rs_ag" passes as a mode, "int8" is rs_ag_int8),
    one step's metrics and parameters (psum) at step 1, and a
    `Trainer`'s first step over the mesh (loss, hosts it tracks,
    parameters)."""
    _, ctx = dp_mesh(world)
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {}
    for compression in ("none", "rs_ag", "int8"):
        tcfg = TrainerConfig(plane=PlaneConfig(4, 8, compression=compression),
                             cast_params_bf16=False)
        loss, grads = make_grad_fn(cfg, ctx, tcfg)(params, tensors, key)
        out[compression] = (float(loss), tree_leaves(grads))
    tcfg = TrainerConfig(plane=PlaneConfig(4, 8), warmup_steps=1,
                         total_steps=4, cast_params_bf16=False)
    p2, _, m = make_train_step(cfg, ctx, tcfg)(
        params, adamw_init(params), batch, 1, key)
    out["step"] = ({k: float(v) for k, v in m.items()}, tree_leaves(p2))
    tr = Trainer(cfg, ctx, tcfg, params)
    m = tr.train_step(batch)
    out["trainer"] = (m["loss"], tr.step_times.ewma.shape[0],
                      tree_leaves(tr.params))
    return out


def _world_one(world, cfg, params, batch: dict, key: int):
    """At world 1: the step over `make_mesh_for(1, 1)` and the step
    without a mesh (parameters, first moments, metrics), and
    `plane_allreduce` in each mode of the parameters as a tree."""
    mesh = make_mesh_for(1, 1)
    tcfg = TrainerConfig(warmup_steps=1, total_steps=4,
                         cast_params_bf16=False)
    runs = []
    for ctx in (ShardCtx(mesh), local_ctx()):
        p2, st, m = make_train_step(cfg, ctx, tcfg)(
            params, adamw_init(params), batch, 1, key)
        runs.append((tree_leaves(p2), tree_leaves(st["m"]), dict(m)))
    group = ShardCtx(mesh).group(("data",))
    synced = {mode: tree_leaves(plane_allreduce(
        params, group, PlaneConfig(4, 8), key=key, mode=mode))
        for mode in MODES}
    return dict(runs=runs, leaves=tree_leaves(params), synced=synced)


def _meshes(world):
    """`make_mesh_for` at this world (and over 2 pods at 4): each mesh's
    shape, dim names, this rank's coordinate and the ranks of its group
    over the dims but "model"; the error of a ShardCtx over a model dim
    above 1 (None at world 1); at world 4 the error of the flattened
    group of a mesh whose ranks do not run row-major over (pod, data)."""
    out = {"meshes": []}
    plans = [(world, 1, 1)] + ([(world, 1, 2)] if world == 4 else [])
    for devices, model, pods in plans:
        mesh = make_mesh_for(devices, model, pods)
        dims = tuple(d for d in mesh.mesh_dim_names if d != "model")
        ranks = dist.get_process_group_ranks(mesh_group(mesh, dims))
        out["meshes"].append((tuple(mesh.shape), mesh.mesh_dim_names,
                              tuple(mesh.get_coordinate()), ranks))
    out["tp"] = None
    if world > 1:
        ctx = ShardCtx(make_mesh_for(world, world))
        out["tp"] = (ctx.tp_size,
                     dist.get_process_group_ranks(ctx.tp_group), ctx.tp_rank)
    out["order_error"] = None
    if world == 4:
        from torch.distributed.device_mesh import DeviceMesh
        permuted = DeviceMesh("cpu", torch.tensor([[[0], [2]], [[1], [3]]]),
                              mesh_dim_names=("pod", "data", "model"))
        try:
            mesh_group(permuted, ("pod", "data"))
        except RuntimeError as e:
            out["order_error"] = str(e)
    return out


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------

def tp_rank(rank, world, cases: list):
    """What the TP tests need from a world of 2 or 4 ranks: every
    collective of `parallel.tp` on this rank's draws (`_tp_collectives`)
    and each case of `cases` (dicts whose "run" names a function of
    `TP_RUNS`, called with the world and the case), by case name."""
    out = {"collectives": _tp_collectives(world)}
    for case in cases:
        out[case["name"]] = TP_RUNS[case["run"]](world, case)
    return out


def _tp_draw(world, rank, i):
    """Rank `rank`'s draws for op `i`: (x, upstream gradient), x of
    (4, 4 * world, 3) float32."""
    g = torch.Generator().manual_seed(100 * world + 10 * rank + i)
    x = torch.randn(4, 4 * world, 3, generator=g)
    return x, g


TP_OPS = {
    "copy_to": lambda x, group: tp.copy_to(x, group),
    "reduce_from": lambda x, group: tp.reduce_from(x, group),
    "reduce": lambda x, group: tp.reduce(x, group),
    "gather": lambda x, group: tp.gather(x, 1, group),
    "reduce_scatter": lambda x, group: tp.reduce_scatter(x, 1, group),
    "all_to_all": lambda x, group: tp.all_to_all(x, group),
    "pmean": lambda x, group: tp.pmean(x, group),
}


def _tp_collectives(world):
    """Each op of `TP_OPS` over the world's model group: {op: (x, y,
    upstream gradient, x's gradient)}."""
    ctx = ShardCtx(make_mesh_for(world, world))
    out = {}
    for i, (name, op) in enumerate(TP_OPS.items()):
        x, g = _tp_draw(world, dist.get_rank(), i)
        x.requires_grad_(True)
        y = op(x, ctx.tp_group)
        gy = torch.randn(y.shape, generator=g)
        (gx,) = torch.autograd.grad(y, x, gy)
        out[name] = (x.detach(), y.detach(), gy, gx)
    return out


def _tp_setup(world, case):
    """(cfg, ctx, whole params, specs, this rank's slices) of a case: its
    mesh over `case["model"]` and `case.get("pods", 1)` pods, its
    context from `launch.specs.make_ctx` (FSDP over "data" when
    `case.get("fsdp")`)."""
    cfg = ARCHS[case["arch"]].reduced(dtype="float32", **case["over"])
    mesh = make_mesh_for(world, case["model"], case.get("pods", 1))
    ctx = make_ctx(mesh, fsdp=case.get("fsdp", False))
    params = torch.load(case["params"])
    specs = param_specs(cfg, ctx)
    return cfg, ctx, params, specs, shard_params(params, specs)


def _dp_tile(ctx, batch: dict):
    """This rank's tile of `batch` over the DP dims (as `make_grad_fn`
    tiles it), and the group of those dims (None at one tile)."""
    axes = batch_axes(ctx)
    if not axes:
        return batch, None
    group = ctx.group(axes)
    n, r = dist.get_world_size(group), dist.get_rank(group)
    return {k: v.chunk(n)[r] for k, v in batch.items()}, group


def tp_grad(world, case):
    """The TP step's loss and gradients (`make_grad_fn`, gathered), the
    CE and aux of the rank's tile averaged over the data dim, whether
    gathering the slices gives back the whole tree bit for bit, and (for
    MoE) each dispatch's per-expert drops, recorded on a no-grad
    forward."""
    cfg, ctx, params, specs, lp = _tp_setup(world, case)
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    tcfg = TrainerConfig(cast_params_bf16=False,
                         aux_weight=case.get("aux_weight", 0.01))
    loss, grads = make_grad_fn(cfg, ctx, tcfg)(lp, batch, case.get("key"))
    drops = []
    dispatch = moe._dispatch

    def counting(x_flat, eids, ranks, n_experts, capacity):
        over = (ranks >= capacity).reshape(-1)
        drops.append(torch.bincount(eids.reshape(-1)[over],
                                    minlength=n_experts).tolist())
        return dispatch(x_flat, eids, ranks, n_experts, capacity)

    moe._dispatch = counting
    tile, group = _dp_tile(ctx, batch)
    try:
        with torch.no_grad():
            _, m = loss_fn(lp, cfg, tile, ctx)
    finally:
        moe._dispatch = dispatch
    metrics = torch.stack([m["ce"], m["aux"]])
    if group is not None:
        dist.all_reduce(metrics, group=group)
        metrics = metrics / dist.get_world_size(group)
    back = gather_params(lp, specs)
    return dict(loss=float(loss), ce=float(metrics[0]),
                aux=float(metrics[1]),
                grads=tree_leaves(gather_params(grads, specs)),
                roundtrip=all(torch.equal(a, b) for a, b in zip(
                    tree_leaves(back), tree_leaves(params))),
                drops=drops)


def tp_decode(world, case):
    """A prefill of the case's prompts and decode steps on its given
    tokens (teacher forcing): every step's logits, the whole vocab."""
    cfg, ctx, _, _, lp = _tp_setup(world, case)
    prompt = torch.from_numpy(case["prompt"])
    steps = torch.from_numpy(case["steps"])
    with torch.inference_mode():
        caches = init_caches(cfg, prompt.shape[0], case["max_len"],
                             "float32", "cpu", ctx)
        logits, caches = prefill_step(lp, cfg, prompt, ctx, caches)
        out = [logits]
        for i in range(steps.shape[1]):
            pos = torch.full((prompt.shape[0],), prompt.shape[1] + i,
                             dtype=torch.int32)
            logits, caches = decode_step(lp, cfg, steps[:, i:i + 1], pos,
                                         ctx, caches)
            out.append(logits)
    return out


def cache_layout(caches) -> dict:
    """{key path: (shape, bytes)} of every leaf of a cache tree."""
    return {path: (tuple(x.shape), x.numel() * x.element_size())
            for path, x in tree_items(caches)}


def serve_run(cfg, ctx, params, case):
    """`prefill_step` and `decode_step` greedily from the case's prompt
    (every step's logits), then a `ServeEngine` with the case's two
    requests, the second admitted after `case["later"]` steps (their
    tokens), and the engine's caches at the end (`cache_layout`)."""
    prompt = torch.from_numpy(case["prompt"])
    b = prompt.shape[0]
    with torch.inference_mode():
        caches = init_caches(cfg, b, case["max_len"], "float32", "cpu", ctx)
        logits, caches = prefill_step(params, cfg, prompt, ctx, caches)
        out = [logits]
        for i in range(case["decode"]):
            tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
            pos = torch.full((b,), prompt.shape[1] + i, dtype=torch.int32)
            logits, caches = decode_step(params, cfg, tok, pos, ctx, caches)
            out.append(logits)
    eng = ServeEngine(cfg, ctx, params, batch=2, max_len=case["max_len"])
    reqs = [Request(i, p, case["max_new"])
            for i, p in enumerate(case["requests"])]
    eng.add_request(reqs[0])
    for _ in range(case["later"]):
        eng.step()
    eng.add_request(reqs[1])
    while any(eng.slots):
        eng.step()
    return out, [r.out for r in reqs], cache_layout(eng.caches)


def tp_serve(world, case):
    """`serve_run` under the case's mesh on the rank's slices: logits,
    tokens and {"rank": the rank's cache layout, "whole": that of the
    caches without a mesh}."""
    cfg, ctx, _, _, lp = _tp_setup(world, case)
    out, tokens, layout = serve_run(cfg, ctx, lp, case)
    whole = init_caches(cfg, 2, case["max_len"], "float32", "cpu")
    return out, tokens, dict(rank=layout, whole=cache_layout(whole))


def train_steps(cfg, ctx, params, case):
    """`case["steps"]` steps of `make_train_step` on the case's batch
    with its clip norm (and aux weight, 0.01 by default): each step's
    metrics and (gathered under a mesh) parameters."""
    tcfg = TrainerConfig(adamw=AdamWConfig(clip_norm=case["clip"]),
                         warmup_steps=1, total_steps=4,
                         cast_params_bf16=False,
                         aux_weight=case.get("aux_weight", 0.01))
    step = make_train_step(cfg, ctx, tcfg)
    opt = adamw_init(params)
    out = []
    for i in range(case["steps"]):
        params, opt, m = step(params, opt, case["batch"], i + 1, 3)
        full = params if ctx.mesh is None else gather_params(
            params, param_specs(cfg, ctx))
        out.append(({k: float(v) for k, v in m.items()}, tree_leaves(full)))
    return out


def tp_train(world, case):
    """`train_steps` under the case's mesh on the rank's slices."""
    cfg, ctx, _, _, lp = _tp_setup(world, case)
    return train_steps(cfg, ctx, lp, case)


def tp_ckpt(world, case):
    """Checkpoints under the case's mesh: the rank's slices restored from
    the one-rank checkpoint in `case["one_rank"]` with shardings (equal
    to `shard_params` of the whole tree, bit for bit), a save of the
    slices into `case["dir"]` restored the same way, a `Trainer`'s save
    and restore under the mesh, and the error of a restore into a target
    whose leaf has another shape."""
    cfg, ctx, params, specs, lp = _tp_setup(world, case)
    zeros = tree_map(lp, torch.zeros_like)
    got, step, _ = restore_checkpoint(case["one_rank"], zeros, specs)
    equal = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(got), tree_leaves(lp)))
    save_checkpoint(case["dir"], 2, lp, shardings=specs)
    again, _, _ = restore_checkpoint(case["dir"], zeros, specs)
    tcfg = TrainerConfig(ckpt_dir=case["dir"] + "_trainer")
    Trainer(cfg, ctx, tcfg, lp).save()
    tr = Trainer.restore(cfg, ctx, tcfg, zeros)
    equal_again = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(again) + tree_leaves(tr.params), 2 * tree_leaves(lp)))
    bad = dict(lp, final_ln=torch.zeros(cfg.d_model + 1))
    try:
        restore_checkpoint(case["dir"], bad, specs)
        error = None
    except ValueError as e:
        error = str(e)
    return dict(step=step, equal=equal, equal_again=equal_again,
                error=error)


TP_RUNS = {"grad": tp_grad, "decode": tp_decode, "serve": tp_serve,
           "train": tp_train, "ckpt": tp_ckpt}
