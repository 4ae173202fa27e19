"""Training loop: plane-split DP gradient sync, failover,
checkpoint/restart; the port of the reference's `train/loop.py`.

`make_train_step` takes the loss and its gradient by autograd (the
reference's `jax.value_and_grad`), then one AdamW update under the cosine
schedule.  With `cast_params_bf16`, every float32 leaf of two or more
dims goes through a differentiable `.to(bfloat16)` before the layer
stack consumes it, as the reference casts before the gather, so the
gradient reaches the float32 master weights through the cast.

Data parallelism: the batch is tiled over the context's DP axes whose
mesh dims are above 1, FSDP's included (`batch_axes`).  Each rank
takes its tile (`ShardCtx.group`'s rank) of every batch leaf whose axis
0 divides by those axes' size, and the whole leaf otherwise; takes the
loss and gradients of its tile; syncs the gradients over the plane axes
(the DP axes but FSDP's, the reference's `shard_map` body) with
`plane_allreduce` (the mean, keyed by the step's `key`); and averages
the loss over every DP axis.  The AdamW update then runs on every rank
alike, so the ranks keep equal parameters.  With no such axis (one
rank, or a mesh of dims of 1) the step is the one-rank step, and `key`
feeds nothing.

FSDP: each rank holds its slice of the leaves whose specs name the FSDP
dim; the forward gathers them and autograd reduce-scatters their
gradients over the FSDP ranks (`models.transformer`).  The loss is
seeded with 1 / (tp x |FSDP dim|), so that sum over the FSDP ranks is
the mean over their tiles; the leaves FSDP does not split (the
embedding table, whose d_model dim is never split) have their
gradients summed over the FSDP group after autograd, to the same mean.
The plane engine then syncs the other DP axes ("pod" on a (pod, data,
model) mesh), as the reference's does.  The bf16 cast comes before the
gathers, so they move bf16.

The `Trainer` threads a host-side `FailoverController` (PLB state) and
telemetry through the steps; plane failures re-weight the micro-chunk
streams (`stream_report`) within `recovery_steps` without touching the
numerics.

Tensor parallelism: under a mesh every rank holds its slices of the
leaves the rules shard (`sharding.shard_params`) and the whole of the
others, and every rank of a model group takes the same batch (the batch
is tiled over the DP dims only).  The loss is replicated over the model
group and its gradient is seeded with 1 / tp, so a sharded leaf's
gradient is its own and a replicated leaf's is the rank's terms
(`parallel.tp`): the norm gains on sequence slices, replicated K/V
projections, the whole embedding or head of a vocab the model dim does
not divide.  After autograd those are summed over the model group in
one all-reduce; then the DP sync runs on the rank's slices, and AdamW's
clip scale takes the global norm over every group that splits a leaf
(`optim.adamw.global_norm`, `norm_groups`), so every rank takes the same
step.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.collectives import fold_seed, plane_allreduce, stream_report
from ..core.fault_tolerance import FailoverController
from ..core.planes import PlaneConfig
from ..core.telemetry import HFTBuffer, StepTimeTracker
from ..models import (loss_fn, param_specs, tree_leaves, tree_map,
                      tree_unflatten)
from ..models.config import ModelConfig
from ..optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                           cosine_schedule)
from ..parallel.sharding import ShardCtx, Spec, axis_size, spec_leaves


@dataclass(frozen=True)
class TrainerConfig:
    plane: PlaneConfig = PlaneConfig()
    adamw: AdamWConfig = AdamWConfig()
    warmup_steps: int = 100
    total_steps: int = 1000
    aux_weight: float = 0.01
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 200
    ckpt_keep: int = 3
    # Cast >=2-D fp32 params to bf16 BEFORE the layer stack consumes them
    # (the reference does so to halve its weight gathers). The model
    # casts at use anyway; master params/optimizer stay fp32.
    cast_params_bf16: bool = True


def _to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def plane_axes(ctx: ShardCtx) -> Tuple[str, ...]:
    """The context's plane axes whose mesh dims are above 1, the ones a
    step syncs over with `plane_allreduce` (none without a mesh)."""
    if ctx.mesh is None:
        return ()
    return tuple(a for a in ctx.plane_axes if axis_size(ctx.mesh, a) > 1)


def batch_axes(ctx: ShardCtx) -> Tuple[str, ...]:
    """The DP axes whose mesh dims are above 1, FSDP's included: the
    batch is tiled over them (none without a mesh)."""
    if ctx.mesh is None:
        return ()
    return tuple(a for a in ctx.dp_axes if axis_size(ctx.mesh, a) > 1)


def leaf_splits(cfg: ModelConfig, ctx: ShardCtx) -> Optional[List[tuple]]:
    """Under a mesh, the mesh dims that split each leaf (in the mesh's
    order), in `tree_leaves` order; else None."""
    if ctx.mesh is None:
        return None
    names = tuple(ctx.mesh.mesh_dim_names)
    return [tuple(d for d in names if d in tuple(s))
            for s in spec_leaves(param_specs(cfg, ctx))]


def _sum_unsplit(grads: list, splits: list, dim: str, group) -> list:
    """`grads` with every leaf the mesh dim `dim` does not split summed
    over `group` (that dim's): one all-reduce a dtype over the leaves
    laid end to end."""
    import torch.distributed as dist
    out = list(grads)
    by_dtype: Dict[Any, list] = {}
    for i, (g, dims) in enumerate(zip(grads, splits)):
        if dim not in dims:
            by_dtype.setdefault(g.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        for i, part in zip(idx, flat.split([grads[i].numel()
                                            for i in idx])):
            out[i] = part.view_as(grads[i])
    return out


def make_grad_fn(cfg: ModelConfig, ctx: ShardCtx, tcfg: TrainerConfig):
    """Returns grad(params, batch, key=None) -> (loss, grads): the loss
    (0-d, detached) and the gradient tree of the step, synced over the
    model group, the FSDP dim and the plane axes (module docstring).
    `params` are the rank's (its slices under a mesh); `batch` holds
    tensors on the parameters' device; `key` is the step's integer seed
    for the int8 codec's noise.  The inputs are not written.  Every rank
    of the mesh must build it together (the groups are made then)."""
    axes = plane_axes(ctx)
    group = ctx.group(axes) if axes else None
    tiles = batch_axes(ctx)
    tile_group = ctx.group(tiles) if tiles else None
    splits = leaf_splits(cfg, ctx)
    fsdp = ctx.fsdp_axis if ctx.fsdp_size > 1 else None
    seed_scale = 1.0 / (ctx.tp_size * ctx.fsdp_size)

    def _cast(params):
        if not tcfg.cast_params_bf16:
            return params
        return tree_map(params, lambda p: p.to(torch.bfloat16)
                        if p.dtype == torch.float32 and p.ndim > 1 else p)

    def local(params, batch):
        leaves = tree_leaves(params)
        wrt = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            loss = loss_fn(_cast(tree_unflatten(params, wrt)), cfg, batch,
                           ctx, tcfg.aux_weight)[0]
            seed = torch.full_like(loss, seed_scale)
            grads = torch.autograd.grad(loss, wrt, seed, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        if splits is not None:
            grads = _sum_unsplit(grads, splits, ctx.tp_axis, ctx.tp_group)
        if fsdp is not None:
            grads = _sum_unsplit(grads, splits, fsdp, ctx.fsdp_group)
        return loss.detach(), tree_unflatten(params, grads)

    def grad(params, batch, key=None):
        if tile_group is None:
            return local(params, batch)
        import torch.distributed as dist
        n, r = dist.get_world_size(tile_group), dist.get_rank(tile_group)
        batch = {k: v.chunk(n)[r] if v.shape[0] % n == 0 else v
                 for k, v in batch.items()}
        loss, grads = local(params, batch)
        if group is not None:
            grads = plane_allreduce(grads, group, tcfg.plane, key=key)
        loss = loss.clone()
        dist.all_reduce(loss, group=tile_group)
        return loss / n, grads

    return grad


def norm_groups(cfg: ModelConfig, ctx: ShardCtx) -> Optional[list]:
    """Under a mesh, for each leaf in `tree_leaves` order the group over
    the mesh dims that split it (`optim.adamw.global_norm`'s `groups`;
    None for a leaf whole on every rank); else None.  Every rank must
    ask together (a group over several dims is made then)."""
    splits = leaf_splits(cfg, ctx)
    if splits is None:
        return None
    return [ctx.group(dims) if dims else None for dims in splits]


def make_train_step(cfg: ModelConfig, ctx: ShardCtx, tcfg: TrainerConfig):
    """Returns step(params, opt_state, batch, step, key=None) -> (params,
    opt_state, metrics): `batch` holds arrays or tensors (moved to the
    parameters' device), `step` the int step of the schedule, `key` the
    step's integer seed (`make_grad_fn`); `metrics` holds 0-d tensors
    `loss`, `grad_norm` and `lr_scale`.  The inputs are not written."""
    grad = make_grad_fn(cfg, ctx, tcfg)
    groups = norm_groups(cfg, ctx)

    def step_fn(params, opt_state, batch, step, key=None):
        device = tree_leaves(params)[0].device
        loss, grads = grad(params, _to_device(batch, device), key)
        lr_scale = cosine_schedule(
            torch.tensor(step, dtype=torch.int32, device=device),
            tcfg.warmup_steps, tcfg.total_steps)
        params, opt_state, om = adamw_update(grads, opt_state, params,
                                             tcfg.adamw, lr_scale, groups)
        metrics = {"loss": loss, "grad_norm": om["grad_norm"],
                   "lr_scale": lr_scale}
        return params, opt_state, metrics

    return step_fn


def state_shardings(cfg: ModelConfig, ctx: ShardCtx):
    """The specs of a trainer's checkpointed tree ({"params", "opt"}:
    the moments as the parameters, the step count whole) under a mesh,
    else None."""
    if ctx.mesh is None:
        return None
    specs = param_specs(cfg, ctx)
    return {"params": specs, "opt": {"m": specs, "v": specs,
                                     "count": Spec((), ctx.mesh)}}


class Trainer:
    """Host-side orchestration: data, telemetry, failover, checkpoints."""

    def __init__(self, cfg: ModelConfig, ctx: ShardCtx, tcfg: TrainerConfig,
                 params, opt_state=None, start_step: int = 0):
        self.cfg, self.ctx, self.tcfg = cfg, ctx, tcfg
        self.params = params
        self.opt_state = opt_state if opt_state is not None else \
            adamw_init(params)
        self.step = start_step
        self.step_fn = make_train_step(cfg, ctx, tcfg)
        self.failover = FailoverController(tcfg.plane)
        self.hft = HFTBuffer()
        n_hosts = 1 if ctx.mesh is None else ctx.mesh.size()
        self.step_times = StepTimeTracker(min(n_hosts, 64))
        self.history: list = []
        self._report = None

    # -- fault hooks -------------------------------------------------------
    def inject_plane_failure(self, plane: int) -> None:
        self.failover.fail_plane(plane)

    def heal_plane(self, plane: int) -> None:
        self.failover.restore_plane(plane)

    # -- one step ----------------------------------------------------------
    def train_step(self, batch: Dict[str, Any]) -> Dict[str, float]:
        t0 = time.perf_counter()
        weights = self.failover.on_step()
        self.params, self.opt_state, metrics = self.step_fn(
            self.params, self.opt_state, batch, self.step,
            fold_seed(17, self.step))
        metrics = {k: float(v) for k, v in metrics.items()}
        wall = time.perf_counter() - t0

        # plane-level accounting: the slowest plane gates the collective
        # (byte-aware LPT stream assignment; see core.collectives)
        report = stream_report(self.params, self.tcfg.plane, weights)
        self._report = report
        plane_rate = np.where(self.failover.plane_up, 1.0, 1e-3)
        share = report.bytes_per_plane / max(report.chunk_bytes.sum(), 1e-9)
        t = np.where(share > 0, share / np.maximum(plane_rate, 1e-9), 0.0)
        tmax = float(t.max())
        eff = 1.0 / (self.tcfg.plane.n_planes * tmax) if tmax > 0 else 1.0
        metrics.update(step_time_s=wall, plane_eff_bw=float(eff),
                       planes_up=int(self.failover.plane_up.sum()))
        self.hft.record(float(self.step), metrics)
        self.history.append(metrics)
        self.step += 1

        if (self.tcfg.ckpt_dir and
                self.step % self.tcfg.ckpt_every == 0):
            self.save()
        return metrics

    # -- checkpointing -----------------------------------------------------
    def save(self) -> str:
        """Commit the parameters and the AdamW state (under a mesh the
        whole tree, written by the mesh's first rank)."""
        from ..checkpoint.ckpt import prune_checkpoints, save_checkpoint
        path = save_checkpoint(
            self.tcfg.ckpt_dir, self.step,
            {"params": self.params, "opt": self.opt_state},
            extras={"model": self.cfg.name},
            shardings=state_shardings(self.cfg, self.ctx))
        prune_checkpoints(self.tcfg.ckpt_dir, self.tcfg.ckpt_keep)
        return path

    @classmethod
    def restore(cls, cfg: ModelConfig, ctx: ShardCtx, tcfg: TrainerConfig,
                template_params, shardings=None) -> "Trainer":
        """A trainer at the latest checkpoint of `tcfg.ckpt_dir`, its
        leaves on `template_params`' devices and dtypes; under a mesh the
        template holds the rank's slices and so does the trainer
        (`shardings` defaults to `state_shardings`)."""
        from ..checkpoint.ckpt import restore_checkpoint
        tmpl = {"params": template_params,
                "opt": adamw_init(template_params)}
        if shardings is None:
            shardings = state_shardings(cfg, ctx)
        tree, step, _ = restore_checkpoint(tcfg.ckpt_dir, tmpl, shardings)
        return cls(cfg, ctx, tcfg, tree["params"], tree["opt"],
                   start_step=step)
