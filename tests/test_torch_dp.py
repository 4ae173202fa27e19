"""The port's data parallelism on the CPU: `launch.mesh.make_mesh_for`,
the data-parallel `ShardCtx` and its process groups, and the train step
synced over the plane axes (`train.loop.make_grad_fn`,
`make_train_step`), against the JAX package's one-rank step.

Ranks are spawned processes over gloo and a `file://` store
(`torch_dist_workers`): worlds of 1, 2 and 4, at once.  The model is the
reduced llama3-8b in float32 with the reference's weights
(`params_from_jax`), and the global batch (8 x 32 tokens) comes from a
numpy seed; at 4 ranks the mesh is (pod 2, data 2, model 1) and each
rank takes 2 rows.

Tolerances, as measured: the synced gradient in psum and rs_ag mode
within 1e-3 of the one-rank global gradient, each leaf's max abs error
over its largest magnitude (the check the reference's own system test
makes; measured 2.2e-6: four local means of two rows summed in another
order than one mean of eight; measured 5.5e-7); in int8 mode within one
code step of the leaf's largest magnitude, 1/127 (measured 7.8e-3).
After one step in psum mode the loss within 1e-5 relative of the
reference's one-rank step on the global batch (measured 8e-8) and every
parameter within 5e-4 of its leaf's largest magnitude (the CPU
tolerance of the port's gradients; measured up to 2.1e-4), but where
the gradient is near zero: AdamW's first update is lr g / (|g| + eps),
which a gradient within a few eps of zero moves by up to 2 lr for any
last-bit difference in g, so such a parameter is held within 2 lr, its
gradient must be within 1e-3 of its leaf's largest, and there may be at
most 1e-4 of all parameters (measured: 1 of 114,944, 8.1e-4 of its
zero-initialized leaf's largest).  The ranks end the step with equal
parameters, bit for bit.  At world 1 the step over a mesh equals the
step without one bit for bit (the plane axes are all of size 1), and
`plane_allreduce` returns its input in psum and rs_ag mode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import init_params as jx_init_params
from repro.models.config import ModelConfig as JxModelConfig
from repro.optim.adamw import adamw_init as jx_adamw_init
from repro.parallel.sharding import local_ctx as jx_local_ctx
from repro.train import TrainerConfig as JxTrainerConfig
from repro.train import make_train_step as jx_make_train_step
from repro_torch.configs import ARCHS
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.models import params_from_jax, tree_leaves
from repro_torch.parallel import ShardCtx, local_ctx
from repro_torch.train import TrainerConfig
from repro_torch.train.loop import make_grad_fn

import torch_dist_workers as w

ARCH = "llama3-8b"
KEY = 11
GRAD_TOL = 1e-3
LOSS_RTOL = 1e-5
PARAM_TOL = 5e-4
NEAR_ZERO_SHARE = 1e-4


def _batch():
    rng = np.random.default_rng(5)
    toks = rng.integers(0, ARCHS[ARCH].reduced().vocab, (8, 33)).astype(
        np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: ranks' results} for worlds 1, 2 and 4, and the one-rank
    references: the port's global gradient and the reference's step."""
    cfg = ARCHS[ARCH].reduced(dtype="float32")
    jcfg = JxModelConfig(**dataclasses.asdict(cfg))
    ref = jax.device_get(jax.jit(lambda k: jx_init_params(k, jcfg))(
        jax.random.PRNGKey(0)))
    params = params_from_jax(ref, cfg, device="cpu")
    path = tmp_path_factory.mktemp("dp") / "params.pt"
    torch.save(params, path)
    batch = _batch()
    groups = [w.start_ranks(w.dp_rank, world, str(path), batch, ARCH, KEY)
              for world in (1, 2, 4)]
    tcfg = TrainerConfig(cast_params_bf16=False)
    loss, grads = make_grad_fn(cfg, local_ctx(), tcfg)(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    jstep = jx_make_train_step(jcfg, jx_local_ctx(), JxTrainerConfig(
        warmup_steps=1, total_steps=4, cast_params_bf16=False))
    jp, _, jm = jstep(jax.tree.map(jnp.asarray, ref), jx_adamw_init(ref),
                      {k: jnp.asarray(v) for k, v in batch.items()},
                      jnp.asarray(1, jnp.int32), jax.random.PRNGKey(0))
    out = {g.world: g.results() for g in groups}
    out["global"] = (float(loss), tree_leaves(grads))
    out["ref"] = ({k: float(v) for k, v in jm.items()},
                  [np.asarray(x) for x in jax.tree.leaves(jp)])
    return out


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)


@pytest.mark.parametrize("compression", ["none", "rs_ag"])
def test_dp_gradient_matches_the_global_gradient(runs, compression):
    gloss, gg = runs["global"]
    for rank in runs[4]:
        loss, grads = rank[compression]
        assert abs(loss - gloss) <= LOSS_RTOL * abs(gloss)
        errs = [_rel(a, b) for a, b in zip(grads, gg)]
        assert max(errs) <= GRAD_TOL, max(errs)
        for a, b in zip(grads, runs[4][0][compression][1]):
            assert torch.equal(a, b)


def test_dp_int8_gradient_within_a_code_step(runs):
    _, gg = runs["global"]
    for rank in runs[4]:
        errs = [_rel(a, b) for a, b in zip(rank["int8"][1], gg)]
        assert max(errs) <= 1 / 127, max(errs)
        assert max(errs) > 1e-4          # compressed, not summed exactly


def test_dp_step_matches_the_reference_one_rank_step(runs):
    """The loss and the parameters after one step; a parameter past
    PARAM_TOL must sit on a gradient near zero (module docstring)."""
    jm, jp = runs["ref"]
    _, gg = runs["global"]
    lr = TrainerConfig().adamw.lr
    for rank in runs[4]:
        m, p = rank["step"]
        assert abs(m["loss"] - jm["loss"]) <= LOSS_RTOL * abs(jm["loss"])
        assert m["lr_scale"] == pytest.approx(jm["lr_scale"], rel=1e-6)
        near, total = 0, 0
        for a, b, g in zip(p, jp, gg):
            err = np.abs(a.numpy() - b)
            off = err > PARAM_TOL * np.abs(b).max()
            g = np.abs(g.numpy())
            assert (g[off] <= GRAD_TOL * g.max()).all()
            assert (err[off] <= 2 * lr).all()
            near, total = near + int(off.sum()), total + err.size
        assert near <= NEAR_ZERO_SHARE * total, near


def test_dp_ranks_end_the_step_with_equal_parameters(runs):
    first = runs[4][0]["step"][1]
    for rank in runs[4][1:]:
        assert all(torch.equal(a, b) for a, b in zip(rank["step"][1], first))


def test_dp_trainer_steps_over_the_mesh(runs):
    """The `Trainer` over the 4-rank mesh: it tracks 4 hosts, keys its
    step (`fold_seed(17, step)`), and its ranks agree."""
    gloss, _ = runs["global"]
    loss0, hosts0, p0 = runs[4][0]["trainer"]
    for loss, hosts, p in (r["trainer"] for r in runs[4]):
        assert hosts == 4 and loss == loss0
        assert abs(loss - gloss) <= LOSS_RTOL * abs(gloss)
        assert all(torch.equal(a, b) for a, b in zip(p, p0))


def test_world_one_step_equals_the_step_without_a_mesh(runs):
    (res,) = runs[1]
    (p1, m1, met1), (p0, m0, met0) = res["runs"]
    assert all(torch.equal(a, b) for a, b in zip(p1 + m1, p0 + m0))
    assert all(torch.equal(met1[k], met0[k]) for k in met0)
    for mode in ("psum", "rs_ag"):
        assert all(torch.equal(a, b) for a, b in zip(res["synced"][mode],
                                                     res["leaves"]))


@pytest.mark.parametrize("world", [1, 2, 4])
def test_make_mesh_for_builds_the_reference_shapes(runs, world):
    """(data, model) over one pod, (pod, data, model) over two; the group
    over the dims but "model" holds every rank in row-major order."""
    want = [((world, 1), ("data", "model"))]
    if world == 4:
        want.append(((2, 2, 1), ("pod", "data", "model")))
    for rank, res in enumerate(runs[world]):
        got = res["meshes"]["meshes"]
        assert [(s, n) for s, n, _, _ in got] == want
        for shape, _, coord, ranks in got:
            assert ranks == list(range(world))
            assert coord == tuple(np.unravel_index(rank, shape))


@pytest.mark.parametrize("world", [2, 4])
def test_tensor_parallel_mesh_raises_naming_4c(runs, world):
    for res in runs[world]:
        assert "queue 1 item 4c" in res["meshes"]["tp_error"]


def test_group_in_another_rank_order_raises(runs):
    for res in runs[4]:
        err = res["meshes"]["order_error"]
        assert "reference's order is [0, 2, 1, 3]" in err


def test_production_mesh_shape():
    assert production_mesh_shape() == ((16, 16), ("data", "model"))
    assert production_mesh_shape(multi_pod=True) == (
        (2, 16, 16), ("pod", "data", "model"))


def test_shard_ctx_properties_match_the_reference():
    """`plane_axes`, `tp_size` and `dp_spec` as the reference defines
    them (without a mesh: no sync, `train.loop.plane_axes` is empty)."""
    from repro.parallel.sharding import ShardCtx as JxShardCtx
    from repro_torch.train.loop import plane_axes
    for kw in ({}, {"dp_axes": ("pod", "data")},
               {"dp_axes": ("pod", "data"), "fsdp_axis": "data"}):
        ctx, jctx = ShardCtx(**kw), JxShardCtx(**kw)
        assert (ctx.plane_axes, ctx.tp_size, ctx.dp_spec) == \
            (jctx.plane_axes, jctx.tp_size, jctx.dp_spec)
        assert plane_axes(ctx) == ()
