"""The port's MLA and SSM families under tensor parallelism and its FSDP
over the data dim (`repro_torch.parallel.sharding.local_part`,
`fsdp_whole`, `models.attention.apply_mla`, `models.ssm.apply_mamba`,
the FSDP train step, serving and checkpoints) against the port's
one-rank run and the JAX package.

Ranks are spawned processes over gloo and a `file://` store
(`torch_dist_workers.tp_rank`): one world of 2 and one of 4, each
running every case of its world once, in contexts built by
`launch.specs.make_ctx`.  Weights are the reference's
(`params_from_jax`, float32), batches come from numpy seeds.  The
cases:

  * deepseek-v2 (MLA) reduced at (data, model) (1, 2), (1, 4) and
    (2, 2), and with 6 heads at (1, 4), where the last rank has none;
  * mamba2 reduced at the same three meshes, and with 6 SSM heads in 2
    groups at (1, 4), whose heads, B/C groups and even parameter splits
    do not align; jamba reduced to a period of two layers (attention with
    a dense MLP, then mamba with MoE, as jamba's period pairs them) at
    the three meshes;
  * serving MLA and SSM at model 2 and 4 (prefill and greedy decode
    logits, then a `ServeEngine` whose second request is admitted
    mid-run, so the SSM state and the latent cache carry over steps);
  * FSDP for llama3-8b and phi3.5-moe reduced at (data 2, model 1),
    (data 2, model 2) and (pod 2, data 2, model 1), the last syncing
    "pod" through `plane_allreduce`; two train steps at (2, 2) and at
    the pod mesh; a checkpoint round trip under FSDP at (2, 2).

The MoE configs (deepseek, jamba, phi3.5-moe) take a capacity factor of
2.0, at which an expert's capacity is at least a shard's tokens, so no
token drops at any mesh (asserted), and an aux weight of 0: under a mesh
the load-balance loss, a product of two batch means, is each sequence
shard's or tile's, averaged, not the whole batch's.  So the one-rank run
is a fair yardstick of the loss and gradients, and the aux value is held
to the reference's under the same mesh.  Under FSDP the reference's MoE
routes the data dim's whole batch at once (its data dim is automatic
there), the port each rank's tile, as both do under DP, so the aux
values part (ROADMAP queue 3; `test_moe_aux_under_fsdp_is_the_tiles`).

The reference runs on 8 forced host devices in three subprocesses at
once, on the weights the test drew (saved as arrays), with its CPU
backend's optimization level at 0 (a third less compile time; its
values stay within the bounds below, closer to the port's than at the
default level): every case's loss, aux and gradients under the same
mesh and context (`repro.launch.specs.make_ctx`; at a plane axis above
1 inside the train step's `shard_map` with `plane_allreduce`, as its
`make_train_step` runs it).

Tolerances, as measured (max over cases, on the CPU), named as in
`tests/test_torch_tp.py`.  These configs' gradients are sensitive: one
ulp of every weight moves them by up to 9.3e-4 of a leaf's largest
magnitude (`test_mesh_departures_are_within_one_ulp_of_the_weights`:
phi3.5-moe 9.3e-4, deepseek 5.5e-4 and with 6 heads 2.7e-4, llama3-8b
5.4e-5, jamba 2.2e-5, mamba2 1.4e-5 and with 6 heads 7.4e-6), and every
mesh case stays within 0.54 of its config's move; the MLA serving
logits move by 1.0e-4, mamba2's by 4.5e-6
(`test_serving_departures_are_within_one_ulp_of_the_weights`).
  * loss and aux within LOSS_RTOL relative of the reference's under the
    mesh (measured 1.7e-7 and 2.0e-7) and the loss of the port's
    one-rank loss (measured 1.6e-7), `test_torch_tp.py`'s bound;
  * gathered gradients within PORT_TOL of each leaf's largest magnitude
    of the one-rank run's (measured 8.5e-5, deepseek with 6 heads at
    model 4; above `test_torch_tp.py`'s 4e-5 by the sensitivity above:
    the same sums in another order; each case is held to twice its
    config's move too) and of the reference's within
    REF_TOL (measured 2.1e-4), `test_torch_tp.py`'s bound;
  * serving logits within LOGIT_TOL of the one-rank run (measured
    3.5e-5, MLA at model 2; above `test_torch_tp.py`'s 1e-5 because one
    ulp of every weight moves that config's logits by 1.0e-4), greedy
    tokens identical;
  * two FSDP steps, clipped: the grad norm within NORM_RTOL of the
    one-rank step's (measured 9.8e-8 and 5.9e-6), `test_torch_tp.py`'s
    bounds, the parameters within STEP_TOL absolute (measured 1.3e-5;
    above `test_torch_tp.py`'s 1e-5: AdamW's first step moves a weight
    by about lr times the sign of its gradient, so a gradient within
    the noise above of zero moves its weight by up to 2 lr whatever its
    last bits).

The file runs in about 80 s alone on 8 CPU cores.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.models import init_params as jx_init_params
from repro.models.config import ModelConfig as JxModelConfig
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import ARCHS
from repro_torch.models import params_from_jax, tree_leaves, tree_map
from repro_torch.parallel import local_ctx
from repro_torch.train import TrainerConfig
from repro_torch.train.loop import make_grad_fn

import torch_dist_workers as w

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 5e-7
PORT_TOL = 2e-4
REF_TOL = 5e-4
LOGIT_TOL = 1e-4
STEP_TOL = 3e-5
NORM_RTOL = (2e-6, 3e-5)
REF_PROCS = 3
MLA, SSM, HYBRID = "deepseek-v2-236b", "mamba2-780m", "jamba-v0.1-52b"
DENSE, MOE = "llama3-8b", "phi3.5-moe-42b-a6.6b"
NO_DROP = {"capacity_factor": 2.0}

# config name: (arch, overrides, aux weight)
CONFIGS = {
    "mla": (MLA, NO_DROP, 0.0),
    "mla_pad": (MLA, dict(NO_DROP, n_heads=6, n_kv_heads=6), 0.0),
    "mamba": (SSM, {}, 0.01),
    "ssm_pad": (SSM, {"ssm_heads": 6, "ssm_groups": 2}, 0.01),
    "jamba": (HYBRID, dict(NO_DROP, block_pattern=("a", "m"), n_layers=2),
              0.0),
    "llama": (DENSE, {}, 0.01),
    "moe": (MOE, NO_DROP, 0.0),
}
# case name: (config, world, mesh shape ((data, model) or (pod, data,
# model)), FSDP)
GRADS = {
    "mla_1x2": ("mla", 2, (1, 2), False),
    "mla_1x4": ("mla", 4, (1, 4), False),
    "mla_2x2": ("mla", 4, (2, 2), False),
    "mla_pad_m4": ("mla_pad", 4, (1, 4), False),
    "mamba_1x2": ("mamba", 2, (1, 2), False),
    "mamba_1x4": ("mamba", 4, (1, 4), False),
    "mamba_2x2": ("mamba", 4, (2, 2), False),
    "ssm_pad_m4": ("ssm_pad", 4, (1, 4), False),
    "jamba_1x2": ("jamba", 2, (1, 2), False),
    "jamba_1x4": ("jamba", 4, (1, 4), False),
    "jamba_2x2": ("jamba", 4, (2, 2), False),
    "llama_f2x1": ("llama", 2, (2, 1), True),
    "llama_f2x2": ("llama", 4, (2, 2), True),
    "llama_fpod": ("llama", 4, (2, 2, 1), True),
    "moe_f2x1": ("moe", 2, (2, 1), True),
    "moe_f2x2": ("moe", 4, (2, 2), True),
    "moe_fpod": ("moe", 4, (2, 2, 1), True),
}
FSDP = sorted(n for n, c in GRADS.items() if c[3])
# name: (config, world, model)
SERVE = {"serve_mla_m2": ("mla", 2, 2), "serve_mla_m4": ("mla", 4, 4),
         "serve_ssm_m2": ("mamba", 2, 2), "serve_ssm_m4": ("mamba", 4, 4)}
# name: (config, world, mesh shape)
TRAIN = {"train_llama_f2x2": ("llama", 4, (2, 2)),
         "train_moe_fpod": ("moe", 4, (2, 2, 1))}
TRAIN_RUN = dict(clip=0.5, steps=2)

REF_SCRIPT = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           "--xla_backend_optimization_level=0")
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.core import PlaneConfig, plane_allreduce
from repro.launch.specs import make_ctx
from repro.models import init_params, logical_axes, loss_fn
from repro.models.config import ModelConfig
from repro.parallel.sharding import param_shardings

spec = json.load(open(sys.argv[1]))
z = np.load(sys.argv[2])
out = {}
for case in spec:
    name, cfg = case["name"], ModelConfig(**case["cfg"])
    tree = jax.tree.structure(jax.eval_shape(
        lambda: init_params(jax.random.PRNGKey(0), cfg)))
    with np.load(case["params"]) as zp:
        params = jax.tree.unflatten(tree, [jnp.asarray(zp[f"arr_{i}"])
                                           for i in range(len(zp.files))])
    batch = {k: jnp.asarray(z[k]) for k in ("tokens", "labels")}
    aux_w = case["aux_weight"]
    shape = tuple(case["mesh"])
    names = ("pod", "data", "model")[-len(shape):]
    mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(
        shape), names)
    ctx = make_ctx(mesh, cfg, fsdp=case["fsdp"])
    ps = jax.device_put(params, param_shardings(
        logical_axes(cfg), ctx, jax.eval_shape(lambda: params)))
    lf = lambda p, b: loss_fn(p, cfg, b, ctx, aux_w)
    plane = tuple(a for a in ctx.plane_axes if mesh.shape[a] > 1)
    if plane:
        def body(p, b, k):
            (l, m), g = jax.value_and_grad(lambda pp: lf(pp, b),
                                           has_aux=True)(p)
            g = plane_allreduce(g, plane, PlaneConfig(), key=k)
            return (jax.lax.pmean(l, plane), jax.lax.pmean(m["aux"], plane),
                    g)
        bspec = {k: P(plane) for k in batch}
        loss, aux, g = jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=(P(), bspec, P()),
            out_specs=(P(), P(), P()), axis_names=set(plane),
            check_vma=False))(ps, batch, jax.random.PRNGKey(0))
    else:
        (loss, m), g = jax.jit(jax.value_and_grad(lf, has_aux=True))(
            ps, batch)
        aux = m["aux"]
    out[f"{name}/loss"] = np.asarray(loss)
    out[f"{name}/aux"] = np.asarray(aux)
    for i, x in enumerate(jax.tree.leaves(g)):
        out[f"{name}/g/{i}"] = np.asarray(x)
np.savez(sys.argv[3], **out)
print("ok")
"""


def _cfg(config):
    arch, over, _ = CONFIGS[config]
    return ARCHS[arch].reduced(dtype="float32", **over)


def _batch(seed: int = 50, b: int = 4, s: int = 32) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _serve_case():
    rng = np.random.default_rng(51)
    return dict(prompt=rng.integers(0, 256, (2, 16)).astype(np.int32),
                requests=[rng.integers(0, 256, 12).astype(np.int32),
                          rng.integers(0, 256, 9).astype(np.int32)],
                max_len=48, decode=8, max_new=6, later=3)


def _mesh_kw(shape):
    """`tp_rank` case keys of a mesh shape."""
    return dict(model=shape[-1], pods=shape[0] if len(shape) == 3 else 1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ranks": {world: the ranks' results}, "world": each case's world,
    "ref": the reference's arrays, "one": the port's one-rank runs,
    "params": whole trees, "dir": the FSDP run's checkpoint}."""
    tmp = tmp_path_factory.mktemp("tp_fsdp")
    params, paths = {}, {}
    for name in CONFIGS:
        cfg = _cfg(name)
        jcfg = JxModelConfig(**dataclasses.asdict(cfg))
        ref = jax.device_get(jax.jit(lambda k: jx_init_params(k, jcfg))(
            jax.random.PRNGKey(0)))
        params[name] = params_from_jax(ref, cfg, device="cpu")
        paths[name] = str(tmp / f"{name}.pt")
        torch.save(params[name], paths[name])
        np.savez(tmp / f"{name}.npz", *jax.tree.leaves(ref))

    batch = _batch()
    np.savez(tmp / "batch.npz", **batch)
    spec = [dict(name=n, cfg=dataclasses.asdict(_cfg(c)), mesh=list(shape),
                 fsdp=fsdp, aux_weight=CONFIGS[c][2],
                 params=str(tmp / f"{c}.npz"))
            for n, (c, _, shape, fsdp) in GRADS.items()]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    procs = []
    for i in range(REF_PROCS):          # the reference's cases, in parallel
        (tmp / f"spec{i}.json").write_text(json.dumps(spec[i::REF_PROCS]))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", REF_SCRIPT, str(tmp / f"spec{i}.json"),
             str(tmp / "batch.npz"), str(tmp / f"ref{i}.npz")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))

    one_rank = str(tmp / "one_rank")
    save_checkpoint(one_rank, 1, params["llama"])
    cases = {2: [], 4: []}
    for name, (c, world, shape, fsdp) in GRADS.items():
        arch, over, aux_w = CONFIGS[c]
        cases[world].append(dict(name=name, run="grad", arch=arch, over=over,
                                 fsdp=fsdp, aux_weight=aux_w,
                                 params=paths[c], batch=batch, key=0,
                                 **_mesh_kw(shape)))
    for name, (c, world, model) in SERVE.items():
        arch, over, _ = CONFIGS[c]
        cases[world].append(dict(name=name, run="serve", arch=arch,
                                 over=over, model=model, params=paths[c],
                                 **_serve_case()))
    for name, (c, world, shape) in TRAIN.items():
        arch, over, aux_w = CONFIGS[c]
        cases[world].append(dict(name=name, run="train", arch=arch,
                                 over=over, fsdp=True, aux_weight=aux_w,
                                 params=paths[c], batch=batch,
                                 **_mesh_kw(shape), **TRAIN_RUN))
    cases[4].append(dict(name="ckpt_f2x2", run="ckpt", arch=DENSE, over={},
                         fsdp=True, model=2, params=paths["llama"],
                         one_rank=one_rank, dir=str(tmp / "fsdp_ckpt")))
    groups = {world: w.start_ranks(w.tp_rank, world, cases[world])
              for world in (2, 4)}

    one = {}
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    for name, (_, _, aux_w) in CONFIGS.items():
        tcfg = TrainerConfig(cast_params_bf16=False, aux_weight=aux_w)
        loss, grads = make_grad_fn(_cfg(name), local_ctx(), tcfg)(
            params[name], tensors)
        one[name] = (float(loss), tree_leaves(grads))
    for c in ("mla", "mamba"):
        one[f"serve_{c}"] = w.serve_run(_cfg(c), local_ctx(), params[c],
                                        _serve_case())
    for name, (c, _, _) in TRAIN.items():
        one[name] = w.train_steps(_cfg(c), local_ctx(), params[c],
                                  dict(TRAIN_RUN, batch=tensors,
                                       aux_weight=CONFIGS[c][2]))

    out = {"ranks": {world: g.results(timeout=600)
                     for world, g in groups.items()},
           "world": {c["name"]: world for world, cs in cases.items()
                     for c in cs},
           "one": one, "params": params, "dir": str(tmp / "fsdp_ckpt")}
    out["ref"] = {}
    for i, proc in enumerate(procs):
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        with np.load(tmp / f"ref{i}.npz") as z:
            out["ref"].update({k: z[k] for k in z.files})
    return out


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)


def _ref_grads(runs, name):
    ref = runs["ref"]
    n = len([k for k in ref if k.startswith(f"{name}/g/")])
    return [ref[f"{name}/g/{i}"] for i in range(n)]


def _results(runs, name):
    """Every rank's result of case `name`."""
    return [r[name] for r in runs["ranks"][runs["world"][name]]]


# ---------------------------------------------------------------------------
# gradients: MLA, SSM and the hybrid under TP; FSDP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(GRADS))
def test_grads_match_the_one_rank_run(runs, name):
    """Loss and gathered gradients against the port's one-rank run; every
    rank ends with the same loss and gradients, its slices gather back
    to the whole tree bit for bit, and no token was dropped."""
    res = _results(runs, name)
    loss0, g0 = runs["one"][GRADS[name][0]]
    for r in res:
        assert abs(r["loss"] - loss0) <= LOSS_RTOL * abs(loss0)
        assert r["roundtrip"]
        assert not any(any(d) for d in r["drops"])
        assert len(r["grads"]) == len(g0)
        for a, b in zip(r["grads"], g0):
            assert a.shape == b.shape
        errs = [_rel(a, b) for a, b in zip(r["grads"], g0)]
        assert max(errs) <= PORT_TOL, max(errs)
        assert all(torch.equal(a, b) for a, b in zip(r["grads"],
                                                     res[0]["grads"]))


@pytest.mark.parametrize("name", sorted(GRADS))
def test_grads_match_the_reference_under_the_mesh(runs, name):
    """Loss, aux and gradients against the reference's under the same
    mesh and context (FSDP's included); phi3.5-moe's aux under FSDP is
    `test_moe_aux_under_fsdp_is_the_tiles`."""
    res = _results(runs, name)
    ref = runs["ref"]
    loss, aux = float(ref[f"{name}/loss"]), float(ref[f"{name}/aux"])
    assert abs(res[0]["loss"] - loss) <= LOSS_RTOL * abs(loss)
    if not name.startswith("moe_"):
        assert abs(res[0]["aux"] - aux) <= LOSS_RTOL * max(abs(aux), 1e-30)
    errs = [_rel(a, b) for a, b in zip(res[0]["grads"],
                                       _ref_grads(runs, name))]
    assert max(errs) <= REF_TOL, max(errs)


def _one_ulp_move(config, params) -> float:
    """How far the one-rank gradients of `config` move, as a share of
    each leaf's largest magnitude, when every weight moves by one ulp
    (times 1 + 2^-23 s, s drawn from {-1, 0, 1} with a fixed seed)."""
    cfg, (_, _, aux_w) = _cfg(config), CONFIGS[config]
    grad = make_grad_fn(cfg, local_ctx(), TrainerConfig(
        cast_params_bf16=False, aux_weight=aux_w))
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    gen = torch.Generator().manual_seed(1)
    moved = tree_map(params, lambda x: x * (1 + 2.0 ** -23 * torch.randint(
        -1, 2, x.shape, generator=gen).float()))
    return max(_rel(a, b) for a, b in zip(
        tree_leaves(grad(moved, batch)[1]), tree_leaves(grad(params,
                                                             batch)[1])))


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_mesh_departures_are_within_one_ulp_of_the_weights(runs, config):
    """The ground of PORT_TOL: every case of `config` departs from the
    one-rank gradients by no more than twice what one ulp of every
    weight moves them (the same sums in another order; a fault in the
    sharding moves them by orders more)."""
    move = _one_ulp_move(config, runs["params"][config])
    _, g0 = runs["one"][config]
    for name in (n for n, c in GRADS.items() if c[0] == config):
        for r in _results(runs, name):
            errs = [_rel(a, b) for a, b in zip(r["grads"], g0)]
            assert max(errs) <= 2 * move, (name, max(errs), move)


def test_moe_aux_under_fsdp_is_the_tiles(runs):
    """At (data 2, model 1) under FSDP the reference's MoE routes the data
    dim's whole batch at once, so its aux loss is the one-rank run's;
    the port routes each rank's tile (as both do under DP) and its aux,
    the tiles' mean, departs from it (ROADMAP queue 3)."""
    with torch.no_grad():
        from repro_torch.models import loss_fn
        _, m = loss_fn(runs["params"]["moe"], _cfg("moe"),
                       {k: torch.from_numpy(v) for k, v in _batch().items()},
                       local_ctx())
    ref_aux = float(runs["ref"]["moe_f2x1/aux"])
    assert abs(ref_aux - float(m["aux"])) <= LOSS_RTOL * abs(ref_aux)
    assert abs(_results(runs, "moe_f2x1")[0]["aux"] - ref_aux) > 1e-6


# ---------------------------------------------------------------------------
# serving, the FSDP train step, checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SERVE))
def test_serving_matches_the_one_rank_run(runs, name):
    res = _results(runs, name)
    logits0, outs0 = runs["one"][f"serve_{SERVE[name][0]}"]
    for logits, outs in res:
        assert outs == outs0
        for a, b in zip(logits, logits0):
            assert a.shape == b.shape == (2, 1, 256)
            assert float((a - b).abs().max()) <= LOGIT_TOL
            assert torch.equal(a.argmax(-1), b.argmax(-1))


@pytest.mark.parametrize("config", ["mamba", "mla"])
def test_serving_departures_are_within_one_ulp_of_the_weights(runs, config):
    """The ground of LOGIT_TOL: each serving case of `config` departs from
    the one-rank logits by no more than twice what one ulp of every
    weight moves them (`_one_ulp_move`'s draw)."""
    params = runs["params"][config]
    gen = torch.Generator().manual_seed(1)
    moved = tree_map(params, lambda x: x * (1 + 2.0 ** -23 * torch.randint(
        -1, 2, x.shape, generator=gen).float()))
    logits0, _ = runs["one"][f"serve_{config}"]
    logits1, _ = w.serve_run(_cfg(config), local_ctx(), moved, _serve_case())
    move = max(float((a - b).abs().max()) for a, b in zip(logits1, logits0))
    for name in (n for n, c in SERVE.items() if c[0] == config):
        for logits, _ in _results(runs, name):
            err = max(float((a - b).abs().max())
                      for a, b in zip(logits, logits0))
            assert err <= 2 * move, (name, err, move)


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_fsdp_steps_match_the_one_rank_steps(runs, name):
    """Two clipped steps under FSDP: every rank's gathered parameters are
    bit-equal, its grad norm and loss are the one-rank step's and so are
    its parameters."""
    res = _results(runs, name)
    one = runs["one"][name]
    for step, norm_rtol in enumerate(NORM_RTOL):
        m0, p0 = one[step]
        assert m0["grad_norm"] > TRAIN_RUN["clip"]
        for r in res:
            m, p = r[step]
            assert abs(m["grad_norm"] - m0["grad_norm"]) <= \
                norm_rtol * m0["grad_norm"]
            assert abs(m["loss"] - m0["loss"]) <= LOSS_RTOL * m0["loss"]
            assert all(torch.equal(a, b) for a, b in zip(p, res[0][step][1]))
    errs = [float((a - b).abs().max()) for a, b in zip(res[0][1][1],
                                                       one[1][1])]
    assert max(errs) <= STEP_TOL, max(errs)


def test_checkpoints_round_trip_between_fsdp_and_one_rank(runs):
    """At (data 2, model 2) under FSDP: a one-rank checkpoint restores
    into the rank's slices, an FSDP save restores into a one-rank run,
    each bit for bit; a target of another shape raises."""
    res = _results(runs, "ckpt_f2x2")
    for r in res:
        assert r["step"] == 1 and r["equal"] and r["equal_again"]
        assert "reshard topology mismatch" in r["error"]
    params = runs["params"]["llama"]
    got, step, _ = restore_checkpoint(runs["dir"], dict(params))
    assert step == 2
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                 tree_leaves(params)))
