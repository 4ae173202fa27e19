"""Training loop: plane-split DP gradient sync, failover,
checkpoint/restart; the port of the reference's `train/loop.py`.

`make_train_step` takes the loss and its gradient by autograd (the
reference's `jax.value_and_grad`), then one AdamW update under the cosine
schedule.  With `cast_params_bf16`, every float32 leaf of two or more
dims goes through a differentiable `.to(bfloat16)` before the layer
stack consumes it, as the reference casts before the gather, so the
gradient reaches the float32 master weights through the cast.

Data parallelism: the step syncs over the context's plane axes whose
mesh dims are above 1 (the reference's `shard_map` body).  Each rank
takes its tile (`ShardCtx.group`'s rank) of every batch leaf whose axis
0 divides by those axes' size, and the whole leaf otherwise; takes the
loss and gradients of its tile; sums the gradients over the group with
`plane_allreduce` (the mean, keyed by the step's `key`); and averages
the loss.  The AdamW update then runs on every rank alike, so the ranks
keep equal parameters.  With no such axis (one rank, or a mesh of dims
of 1) the step is the one-rank step, and `key` feeds nothing.

The `Trainer` threads a host-side `FailoverController` (PLB state) and
telemetry through the steps; plane failures re-weight the micro-chunk
streams (`stream_report`) within `recovery_steps` without touching the
numerics.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.collectives import fold_seed, plane_allreduce, stream_report
from ..core.fault_tolerance import FailoverController
from ..core.planes import PlaneConfig
from ..core.telemetry import HFTBuffer, StepTimeTracker
from ..models import loss_fn, tree_leaves, tree_map, tree_unflatten
from ..models.config import ModelConfig
from ..optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                           cosine_schedule)
from ..parallel.sharding import ShardCtx, axis_size


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
    step syncs over (none without a mesh)."""
    if ctx.mesh is None:
        return ()
    return tuple(a for a in ctx.plane_axes if axis_size(ctx.mesh, a) > 1)


def make_grad_fn(cfg: ModelConfig, ctx: ShardCtx, tcfg: TrainerConfig):
    """Returns grad(params, batch, key=None) -> (loss, grads): the loss
    (0-d, detached) and the gradient tree of the step, synced over the
    plane axes (module docstring).  `batch` holds tensors on the
    parameters' device; `key` is the step's integer seed for the int8
    codec's noise.  The inputs are not written.  Every rank of the
    group must build it together (the group is made then)."""
    axes = plane_axes(ctx)
    group = ctx.group(axes) if axes else None

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
            grads = torch.autograd.grad(loss, wrt, allow_unused=True)
        return loss.detach(), tree_unflatten(params, [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)])

    def grad(params, batch, key=None):
        if group is None:
            return local(params, batch)
        import torch.distributed as dist
        n, r = dist.get_world_size(group), dist.get_rank(group)
        batch = {k: v.chunk(n)[r] if v.shape[0] % n == 0 else v
                 for k, v in batch.items()}
        loss, grads = local(params, batch)
        grads = plane_allreduce(grads, group, tcfg.plane, key=key)
        loss = loss.clone()
        dist.all_reduce(loss, group=group)
        return loss / n, grads

    return grad


def make_train_step(cfg: ModelConfig, ctx: ShardCtx, tcfg: TrainerConfig):
    """Returns step(params, opt_state, batch, step, key=None) -> (params,
    opt_state, metrics): `batch` holds arrays or tensors (moved to the
    parameters' device), `step` the int step of the schedule, `key` the
    step's integer seed (`make_grad_fn`); `metrics` holds 0-d tensors
    `loss`, `grad_norm` and `lr_scale`.  The inputs are not written."""
    grad = make_grad_fn(cfg, ctx, tcfg)

    def step_fn(params, opt_state, batch, step, key=None):
        device = tree_leaves(params)[0].device
        loss, grads = grad(params, _to_device(batch, device), key)
        lr_scale = cosine_schedule(
            torch.tensor(step, dtype=torch.int32, device=device),
            tcfg.warmup_steps, tcfg.total_steps)
        params, opt_state, om = adamw_update(grads, opt_state, params,
                                             tcfg.adamw, lr_scale)
        metrics = {"loss": loss, "grad_norm": om["grad_norm"],
                   "lr_scale": lr_scale}
        return params, opt_state, metrics

    return step_fn


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
        from ..checkpoint.ckpt import prune_checkpoints, save_checkpoint
        path = save_checkpoint(
            self.tcfg.ckpt_dir, self.step,
            {"params": self.params, "opt": self.opt_state},
            extras={"model": self.cfg.name})
        prune_checkpoints(self.tcfg.ckpt_dir, self.tcfg.ckpt_keep)
        return path

    @classmethod
    def restore(cls, cfg: ModelConfig, ctx: ShardCtx, tcfg: TrainerConfig,
                template_params, shardings=None) -> "Trainer":
        """A trainer at the latest checkpoint of `tcfg.ckpt_dir`, its
        leaves on `template_params`' devices and dtypes."""
        from ..checkpoint.ckpt import restore_checkpoint
        tmpl = {"params": template_params,
                "opt": adamw_init(template_params)}
        tree, step, _ = restore_checkpoint(tcfg.ckpt_dir, tmpl, shardings)
        return cls(cfg, ctx, tcfg, tree["params"], tree["opt"],
                   start_step=step)
