"""The port's tensor parallelism on the CPU (`repro_torch.parallel.tp`,
the TP `ShardCtx`, the model's column/row-parallel layers with
sequence-parallel residuals, the vocab-parallel embedding and loss, the
MoE's a2a and psum modes, the TP train step, serving and checkpoints)
against the port's one-rank run and the JAX package.

Ranks are spawned processes over gloo and a `file://` store
(`torch_dist_workers.tp_rank`): one world of 2 and one of 4, each
running every case of its world once.  Meshes: (data 1, model 2),
(data 1, model 4) and (data 2, model 2).  Weights are the reference's
(`params_from_jax`, float32), batches come from numpy seeds.  The
reference runs on 8 forced host devices: its unsharded
`jax.value_and_grad` of `loss_fn` for the dense configs, and for the
reduced phi3.5-moe its loss, aux loss and gradients under each mesh
(at data 2 inside the train step's `shard_map` over "data", with
`plane_allreduce`), and its prefill and decode logits under (1, 2) and
(1, 4); its cases are split over three subprocesses that run at once.

Tolerances, as measured (max over cases, on the CPU):
  * dense loss against the port's one-rank loss and the reference's
    within LOSS_RTOL relative (measured 1.6e-7; the vocab-parallel CE
    keeps logsumexp's order), the gathered gradients within PORT_TOL of
    each leaf's largest magnitude of the one-rank run's (measured
    2.0e-5, llama3-8b at model 4: the row-parallel products, the
    reduce-scatters and the replicated leaves' sums add the same terms
    in another order; the 1e-5 aimed at is passed by that much), and of
    the reference's unsharded gradients within REF_TOL, the bound of the
    port's train-step tests (measured 1.1e-4);
  * MoE under a mesh against the reference under the same mesh: loss
    and aux within LOSS_RTOL (measured 1.1e-7), gradients within REF_TOL
    (measured 1.1e-4), prefill (a2a) and decode (psum) logits within
    REF_LOGIT_TOL absolute (measured 1.2e-4, the prefill at model 4; the
    port's float32 logits sit within 1e-4 of the reference's without a
    mesh, `test_torch_models.py`); the per-shard capacity moves the
    loss off the one-rank loss by 0.12-0.14;
  * serving: logits within LOGIT_TOL of the one-rank run (measured
    5.7e-6 at model 4), greedy tokens identical;
  * the train step at (data 2, model 2), clipped (grad norm 25 against
    a clip of 0.5): the grad norm within NORM_RTOL of the one-rank
    step's (measured 9.1e-7 at step 1 and 1.1e-5 at step 2: AdamW's
    first update moves a parameter whose gradient is within a few eps
    of zero by up to 2 lr whatever the gradient's last bits, so step 2
    starts from parameters up to 7.2e-6 apart), the parameters after
    two steps within STEP_TOL absolute (measured 7.2e-6).

The file runs in about 65 s alone on 8 CPU cores (the three reference
subprocesses set it).
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
from repro_torch.models import params_from_jax, tree_leaves
from repro_torch.parallel import local_ctx
from repro_torch.train import TrainerConfig
from repro_torch.train.loop import make_grad_fn

import torch_dist_workers as w

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 5e-7
PORT_TOL = 4e-5
REF_TOL = 5e-4
LOGIT_TOL = 1e-5
REF_LOGIT_TOL = 2.5e-4
STEP_TOL = 1e-5
NORM_RTOL = (2e-6, 3e-5)
MOE = "phi3.5-moe-42b-a6.6b"
REF_PROCS = 3

# name: (arch, overrides, world, model)
DENSE = {
    "llama_m2": ("llama3-8b", {}, 2, 2),
    "llama_m4": ("llama3-8b", {"remat": "full"}, 4, 4),
    "gemma2b_m2": ("gemma-2b", {}, 2, 2),
    "gemma3_m2": ("gemma3-12b", {}, 2, 2),
    "pad_m4": ("llama3-8b", {"n_heads": 6, "n_kv_heads": 2}, 4, 4),
}
# name: (world, data, model)
MOE_MESHES = {"moe_1x2": (2, 1, 2), "moe_1x4": (4, 1, 4),
              "moe_2x2": (4, 2, 2)}
SERVE = {"serve_m2": (2, 2), "serve_m4": (4, 4)}

REF_SCRIPT = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.core import PlaneConfig, plane_allreduce
from repro.models import (decode_step, init_caches, init_params,
                          logical_axes, loss_fn, prefill_step)
from repro.models.config import ModelConfig
from repro.parallel.sharding import ShardCtx, local_ctx, param_shardings

spec = json.load(open(sys.argv[1]))
z = np.load(sys.argv[2])
out = {}
for case in spec:
    name, cfg = case["name"], ModelConfig(**case["cfg"])
    params = jax.jit(lambda k: init_params(k, cfg))(jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(z[f"{case['batch']}/{k}"])
             for k in ("tokens", "labels")}
    lf = lambda p, b, ctx: loss_fn(p, cfg, b, ctx, 0.01)
    if case["mesh"] is None:
        ctx, ps = local_ctx(), params
    else:
        data, model = case["mesh"]
        mesh = Mesh(np.array(jax.devices()[:data * model]).reshape(
            data, model), ("data", "model"))
        ctx = ShardCtx(mesh=mesh)
        ps = jax.device_put(params, param_shardings(
            logical_axes(cfg), ctx, jax.eval_shape(lambda: params)))
    if case["mesh"] is not None and case["mesh"][0] > 1:
        def body(p, b, k):
            (l, m), g = jax.value_and_grad(
                lambda pp: lf(pp, b, ctx), has_aux=True)(p)
            g = plane_allreduce(g, ("data",), PlaneConfig(), key=k)
            return (jax.lax.pmean(l, "data"),
                    jax.lax.pmean(m["aux"], "data"), g)
        bspec = {k: P("data") for k in batch}
        loss, aux, g = jax.jit(jax.shard_map(
            body, mesh=ctx.mesh, in_specs=(P(), bspec, P()),
            out_specs=(P(), P(), P()), axis_names={"data"},
            check_vma=False))(ps, batch, jax.random.PRNGKey(0))
    elif case["grad"]:
        (loss, m), g = jax.jit(jax.value_and_grad(
            lambda p, b: lf(p, b, ctx), has_aux=True))(ps, batch)
        aux = m["aux"]
    else:
        loss, m = jax.jit(lambda p, b: lf(p, b, ctx))(ps, batch)
        aux, g = m["aux"], {}
    out[f"{name}/loss"] = np.asarray(loss)
    out[f"{name}/aux"] = np.asarray(aux)
    for i, x in enumerate(jax.tree.leaves(g)):
        out[f"{name}/g/{i}"] = np.asarray(x)
    if case.get("decode"):
        prompt = jnp.asarray(z[f"{case['batch']}/prompt"])
        steps = jnp.asarray(z[f"{case['batch']}/steps"])
        b, s = prompt.shape
        caches = init_caches(cfg, b, case["decode"], cfg.dtype)
        pre = jax.jit(lambda p, t, c: prefill_step(p, cfg, t, ctx, c))
        dec = jax.jit(lambda p, t, q, c: decode_step(p, cfg, t, q, ctx, c))
        logits, caches = pre(ps, prompt, caches)
        out[f"{name}/logits/0"] = np.asarray(logits)
        for i in range(steps.shape[1]):
            pos = jnp.full((b,), s + i, jnp.int32)
            logits, caches = dec(ps, steps[:, i:i + 1], pos, caches)
            out[f"{name}/logits/{i + 1}"] = np.asarray(logits)
np.savez(sys.argv[3], **out)
print("ok")
"""


def _cfg(arch, over):
    return ARCHS[arch].reduced(dtype="float32", **over)


def _batch(seed: int, b: int, s: int) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _moe_batch():
    """Each row's first half one token repeated, the rest drawn: the
    repeats route alike, so an expert overflows its capacity on the
    first sequence slices and not on the last."""
    out = _batch(41, 2, 64)
    out["tokens"][:, :32] = 7
    out["labels"][:, :31] = 7
    rng = np.random.default_rng(42)
    out["prompt"] = rng.integers(0, 256, (2, 16)).astype(np.int32)
    out["steps"] = rng.integers(0, 256, (2, 4)).astype(np.int32)
    return out


def _serve_case():
    rng = np.random.default_rng(43)
    return dict(prompt=rng.integers(0, 256, (2, 16)).astype(np.int32),
                requests=[rng.integers(0, 256, 12).astype(np.int32),
                          rng.integers(0, 256, 9).astype(np.int32)],
                max_len=48, decode=8, max_new=6, later=3)


TRAIN = dict(batch=_batch(44, 4, 32), clip=0.5, steps=2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ranks": {world: the ranks' results}, "world": each case's world,
    "ref": the reference's arrays, "one": the port's one-rank runs,
    "params": whole trees, "dir": the TP run's checkpoint}."""
    tmp = tmp_path_factory.mktemp("tp")
    archs = {name: (arch, over) for name, (arch, over, _, _) in
             DENSE.items()}
    archs["moe"] = (MOE, {})
    params, paths = {}, {}
    for name, (arch, over) in archs.items():
        cfg = _cfg(arch, over)
        jcfg = JxModelConfig(**dataclasses.asdict(cfg))
        ref = jax.device_get(jax.jit(lambda k: jx_init_params(k, jcfg))(
            jax.random.PRNGKey(0)))
        params[name] = params_from_jax(ref, cfg, device="cpu")
        paths[name] = str(tmp / f"{name}.pt")
        torch.save(params[name], paths[name])

    dense_batch, moe_batch = _batch(40, 4, 32), _moe_batch()
    np.savez(tmp / "batches.npz",
             **{f"dense/{k}": v for k, v in dense_batch.items()},
             **{f"moe/{k}": v for k, v in moe_batch.items()})
    spec = [dict(name=n, cfg=dataclasses.asdict(_cfg(*archs[n])),
                 batch="dense", mesh=None, grad=True) for n in DENSE]
    spec.append(dict(name="pad_ref_m4", cfg=dataclasses.asdict(
        _cfg(*archs["pad_m4"])), batch="dense", mesh=[1, 4], grad=False))
    for n, (_, data, model) in MOE_MESHES.items():
        spec.append(dict(name=n, cfg=dataclasses.asdict(_cfg(MOE, {})),
                         batch="moe", mesh=[data, model], grad=True,
                         decode=32 if data == 1 else 0))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    procs = []
    for i in range(REF_PROCS):          # the reference's cases, in parallel
        (tmp / f"spec{i}.json").write_text(json.dumps(spec[i::REF_PROCS]))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", REF_SCRIPT, str(tmp / f"spec{i}.json"),
             str(tmp / "batches.npz"), str(tmp / f"ref{i}.npz")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))

    one_rank = str(tmp / "one_rank")
    save_checkpoint(one_rank, 1, params["llama_m2"])
    cases = {2: [], 4: []}
    for name, (arch, over, world, model) in DENSE.items():
        cases[world].append(dict(name=name, run="grad", arch=arch, over=over,
                                 model=model, params=paths[name],
                                 batch=dense_batch))
    for name, (world, data, model) in MOE_MESHES.items():
        cases[world].append(dict(name=name, run="grad", arch=MOE, over={},
                                 model=model, params=paths["moe"],
                                 batch={k: moe_batch[k] for k in
                                        ("tokens", "labels")}, key=0))
        if data == 1:
            cases[world].append(dict(
                name=name + "_decode", run="decode", arch=MOE, over={},
                model=model, params=paths["moe"],
                prompt=moe_batch["prompt"], steps=moe_batch["steps"],
                max_len=32))
    for name, (world, model) in SERVE.items():
        cases[world].append(dict(name=name, run="serve", arch="llama3-8b",
                                 over={}, model=model,
                                 params=paths["llama_m2"], **_serve_case()))
    cases[4].append(dict(name="train_2x2", run="train", arch="llama3-8b",
                         over={}, model=2, params=paths["llama_m2"],
                         **TRAIN))
    cases[2].append(dict(name="ckpt", run="ckpt", arch="llama3-8b",
                         over={}, model=2, params=paths["llama_m2"],
                         one_rank=one_rank, dir=str(tmp / "tp_ckpt")))
    groups = {world: w.start_ranks(w.tp_rank, world, cases[world])
              for world in (2, 4)}

    one = {}
    tcfg = TrainerConfig(cast_params_bf16=False)
    for name, (arch, over) in archs.items():
        batch = moe_batch if name == "moe" else dense_batch
        batch = {k: torch.from_numpy(batch[k]) for k in ("tokens", "labels")}
        loss, grads = make_grad_fn(_cfg(arch, over), local_ctx(), tcfg)(
            params[name], batch)
        one[name] = (float(loss), tree_leaves(grads))
    cfg = _cfg("llama3-8b", {})
    one["serve"] = w.serve_run(cfg, local_ctx(), params["llama_m2"],
                               _serve_case())
    one["train"] = w.train_steps(cfg, local_ctx(), params["llama_m2"],
                                 dict(TRAIN, batch={
                                     k: torch.from_numpy(v)
                                     for k, v in TRAIN["batch"].items()}))

    out = {"ranks": {world: g.results(timeout=600)
                     for world, g in groups.items()},
           "world": {c["name"]: world for world, cs in cases.items()
                     for c in cs},
           "one": one, "params": params, "dir": str(tmp / "tp_ckpt")}
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
# the collectives
# ---------------------------------------------------------------------------

def _expected(op, xs, gys):
    """The op's outputs and input gradients on every rank, computed on the
    gathered tensors."""
    n = len(xs)
    total, gtotal = sum(xs), sum(gys)
    if op == "copy_to":
        return xs, [gtotal] * n
    if op == "reduce_from":
        return [total] * n, gys
    if op == "reduce":
        return [total] * n, [gtotal] * n
    if op == "pmean":
        return [total / n] * n, [gtotal / n] * n
    if op == "gather":
        y = np.concatenate(xs, axis=1)
        return [y] * n, np.split(gtotal, n, axis=1)
    if op == "reduce_scatter":
        return (np.split(total, n, axis=1),
                [np.concatenate(gys, axis=1)] * n)
    if op == "all_to_all":
        ys = [np.concatenate([np.split(x, n)[r] for x in xs])
              for r in range(n)]
        gxs = [np.concatenate([np.split(g, n)[r] for g in gys])
               for r in range(n)]
        return ys, gxs
    raise ValueError(op)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("op", sorted(w.TP_OPS))
def test_collective_and_its_gradient_match_the_gathered_computation(
        runs, world, op):
    res = [r["collectives"][op] for r in runs["ranks"][world]]
    xs = [x.numpy() for x, _, _, _ in res]
    gys = [gy.numpy() for _, _, gy, _ in res]
    ys, gxs = _expected(op, xs, gys)
    for (x, y, gy, gx), want_y, want_gx in zip(res, ys, gxs):
        np.testing.assert_allclose(y.numpy(), want_y, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(gx.numpy(), want_gx, rtol=1e-6,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# dense configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(DENSE))
def test_dense_tp_matches_the_one_rank_run(runs, name):
    """Loss and gathered gradients against the port's one-rank run; every
    rank ends with the same loss and gradients, and the slices gather
    back to the whole tree bit for bit."""
    res = _results(runs, name)
    loss0, g0 = runs["one"][name]
    for r in res:
        assert abs(r["loss"] - loss0) <= LOSS_RTOL * abs(loss0)
        assert r["roundtrip"]
        errs = [_rel(a, b) for a, b in zip(r["grads"], g0)]
        assert max(errs) <= PORT_TOL, max(errs)
        assert all(torch.equal(a, b) for a, b in zip(r["grads"],
                                                     res[0]["grads"]))


@pytest.mark.parametrize("name", sorted(DENSE))
def test_dense_tp_matches_the_reference(runs, name):
    res = _results(runs, name)
    ref = runs["ref"]
    loss = float(ref[f"{name}/loss"])
    assert abs(res[0]["loss"] - loss) <= LOSS_RTOL * abs(loss)
    errs = [_rel(a, b) for a, b in zip(res[0]["grads"],
                                       _ref_grads(runs, name))]
    assert max(errs) <= REF_TOL, max(errs)


def test_padded_heads_give_no_gradient_to_padded_rows(runs):
    """n_heads 6 at model 4: ranks hold heads [0, 2), [2, 4), [4, 6) and
    none; the gathered wq and wo equal the one-rank gradients in shape
    and the run matches (the other tests); the reference's own padding
    regroups the heads onto other kv heads, so its loss under the mesh
    departs from its unsharded loss (ROADMAP queue 3)."""
    res = _results(runs, "pad_m4")
    _, g0 = runs["one"]["pad_m4"]
    for a, b in zip(res[0]["grads"], g0):
        assert a.shape == b.shape
    ref = runs["ref"]
    assert abs(float(ref["pad_ref_m4/loss"]) -
               float(ref["pad_m4/loss"])) > 1e-3


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(MOE_MESHES))
def test_moe_a2a_matches_the_reference_under_the_mesh(runs, name):
    res = _results(runs, name)
    ref = runs["ref"]
    loss, aux = float(ref[f"{name}/loss"]), float(ref[f"{name}/aux"])
    for r in res:
        assert abs(r["loss"] - loss) <= LOSS_RTOL * abs(loss)
        assert abs(r["aux"] - aux) <= LOSS_RTOL * abs(aux)
    errs = [_rel(a, b) for a, b in zip(res[0]["grads"],
                                       _ref_grads(runs, name))]
    assert max(errs) <= REF_TOL, max(errs)


@pytest.mark.parametrize("name", ["moe_1x2", "moe_1x4"])
def test_moe_decode_psum_matches_the_reference(runs, name):
    """A prefill (a2a) and four decode steps (psum), the whole vocab's
    logits on every rank."""
    res = _results(runs, name + "_decode")
    ref = runs["ref"]
    for r in res:
        for i, got in enumerate(r):
            want = ref[f"{name}/logits/{i}"]
            assert got.shape == want.shape
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=REF_LOGIT_TOL)


def test_moe_drops_are_per_shard(runs):
    """At model 2 an expert overflows its capacity on one sequence slice
    and not on the other, and the a2a loss differs from the one-rank
    loss (whose capacity is the whole batch's)."""
    res = _results(runs, "moe_1x2")
    per_rank = [r["drops"] for r in res]
    assert any(a[e] > 0 and b[e] == 0
               for calls in zip(*per_rank)
               for a in calls for b in calls
               for e in range(len(a)))
    loss0, _ = runs["one"]["moe"]
    assert abs(res[0]["loss"] - loss0) > 1e-4


# ---------------------------------------------------------------------------
# serving, the train step, checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SERVE))
def test_serving_matches_the_one_rank_run(runs, name):
    res = _results(runs, name)
    logits0, outs0 = runs["one"]["serve"]
    for logits, outs in res:
        assert outs == outs0
        for a, b in zip(logits, logits0):
            assert a.shape == b.shape == (2, 1, 256)
            assert float((a - b).abs().max()) <= LOGIT_TOL
            assert torch.equal(a.argmax(-1), b.argmax(-1))


def test_train_step_keeps_model_ranks_equal(runs):
    """(data 2, model 2), two steps with the clip active: every rank's
    gathered parameters are bit-equal, its grad norm is the one-rank
    step's and so are its parameters."""
    res = _results(runs, "train_2x2")
    one = runs["one"]["train"]
    for step, norm_rtol in enumerate(NORM_RTOL):
        m0, p0 = one[step]
        assert m0["grad_norm"] > TRAIN["clip"]
        for r in res:
            m, p = r[step]
            assert abs(m["grad_norm"] - m0["grad_norm"]) <= \
                norm_rtol * m0["grad_norm"]
            assert abs(m["loss"] - m0["loss"]) <= LOSS_RTOL * m0["loss"]
            assert all(torch.equal(a, b) for a, b in zip(p, res[0][step][1]))
    errs = [float((a - b).abs().max()) for a, b in zip(res[0][1][1],
                                                       one[1][1])]
    assert max(errs) <= STEP_TOL, max(errs)


def test_checkpoints_round_trip_between_tp_and_one_rank(runs):
    """A one-rank checkpoint restores into the TP run's slices, a TP save
    restores into a one-rank run, each bit for bit; a target of another
    shape raises."""
    res = _results(runs, "ckpt")
    for r in res:
        assert r["step"] == 1 and r["equal"] and r["equal_again"]
        assert "reshard topology mismatch" in r["error"]
    params = runs["params"]["llama_m2"]
    got, step, _ = restore_checkpoint(
        runs["dir"], {k: v for k, v in params.items()})
    assert step == 2
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                 tree_leaves(params)))
