"""Rank processes for the port's data-parallel CPU tests.

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

from repro_torch.configs import ARCHS
from repro_torch.core import collectives
from repro_torch.core.collectives import MODES, plane_allreduce
from repro_torch.core.planes import PlaneConfig
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.models import tree_leaves
from repro_torch.optim import adamw_init
from repro_torch.parallel import ShardCtx, local_ctx
from repro_torch.parallel.sharding import mesh_group
from repro_torch.train import Trainer, TrainerConfig, make_train_step
from repro_torch.train.loop import make_grad_fn


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
    out["tp_error"] = None
    if world > 1:
        try:
            ShardCtx(make_mesh_for(world, world))
        except NotImplementedError as e:
            out["tp_error"] = str(e)
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
