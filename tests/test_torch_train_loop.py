"""The port's training loop (`make_train_step`, `Trainer`,
`launch.train`) against the JAX package's on the CPU.

Weights are the reference's, carried across with `params_from_jax`;
batches come from numpy seeds or the shared synthetic pipeline and go to
both.  On the CPU the port's attention is its copy of the reference's
`chunked_attention`; nothing here launches a kernel.

Tolerances, float32 (`cast_params_bf16=False`): after each of three
steps the loss within 1e-5 relative and the grad norm within 1e-4
(measured 1.7e-7 and 4e-5), the parameters within 1e-5 (measured
1.3e-6).  Over the Trainer's nine steps AdamW amplifies the last-ulp
differences: a gradient near zero whose sign the two packages' sums
settle differently moves its weight 2 lr the other way, and the next
steps' losses and norms feel it, so the loss is held within 2e-5 and
the grad norm within 1e-3 (measured 5.6e-6 and 3.8e-4).  bfloat16
(`cast_params_bf16`, bf16 activations), measured over five steps of
llama3-8b, gemma3-12b and phi3.5-moe, seeds 0 to 2: the loss within
5e-3 relative (measured up to 2.2e-3, phi3.5-moe's, whose expert routing
flips; 1.9e-3 in the launcher run below), the grad norm of the dense
llama3-8b within 25% (measured up to 15%; phi3.5-moe's differs by up to
60% and is not held: the gradients are bf16 products rounded in other
places, and a flipped route changes which experts get any).  The
gradient itself is held through the first moments after the first step
(0.1 x the clipped gradient), leaf by leaf, the max abs difference over
the reference leaf's largest value: within 0.4 (measured up to 0.31 over
llama3-8b and gemma3-12b, seeds 0 to 4, median leaf 0.06-0.12; the two
packages' bf16 gradients lie closer to each other than either lies to
the float32 gradient, 0.5 for llama3-8b; a leaf that got no gradient
would be off by 1).  The parameters are checked only for sanity, within
2 lr per update: AdamW moves a weight by about lr a step whatever its
gradient.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.train as jx_launch
from repro.core.planes import PlaneConfig as JxPlaneConfig
from repro.models import init_params as jx_init_params
from repro.models.config import ModelConfig as JxModelConfig
from repro.optim.adamw import adamw_init as jx_adamw_init
from repro.parallel.sharding import local_ctx as jx_local_ctx
from repro.train import Trainer as JxTrainer
from repro.train import TrainerConfig as JxTrainerConfig
from repro.train import make_train_step as jx_make_train_step
import repro_torch.launch.train as launch
from repro_torch.configs import ARCHS
from repro_torch.core.planes import PlaneConfig
from repro_torch.data import DataConfig, DataLoader
from repro_torch.models import params_from_jax, tree_leaves
from repro_torch.optim import adamw_init
from repro_torch.parallel import local_ctx
from repro_torch.train import Trainer, TrainerConfig, make_train_step

JX_CTX, CTX = jx_local_ctx(), local_ctx()
LOSS_RTOL = 1e-5
GNORM_RTOL = 1e-4
PARAM_ATOL = 1e-5
TRAINER_LOSS_RTOL = 2e-5
TRAINER_GNORM_RTOL = 1e-3
BF16_LOSS_RTOL = 5e-3
BF16_GNORM_RTOL = 0.25
BF16_MOMENT_TOL = 0.4


@functools.lru_cache(maxsize=None)
def _weights(arch: str, dtype: str, seed: int = 0):
    cfg = ARCHS[arch].reduced(dtype=dtype)
    jcfg = JxModelConfig(**dataclasses.asdict(cfg))
    ref = jax.device_get(jax.jit(lambda k: jx_init_params(k, jcfg))(
        jax.random.PRNGKey(seed)))
    return cfg, jcfg, ref


def _batch(cfg, seed: int, B: int = 2, S: int = 48):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.frontend_tokens:
        batch["frontend_embeds"] = (rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    return batch


def _steps(arch, dtype, cast, seed, steps=3):
    """`steps` train steps of both packages from the same weights on the
    same batches; yields (port metrics, reference metrics, port
    parameters, reference parameters, port first moments, reference
    first moments) after each, the last four as lists of leaves."""
    cfg, jcfg, ref = _weights(arch, dtype, seed)
    kw = dict(warmup_steps=1, total_steps=10, cast_params_bf16=cast)
    jstep = jx_make_train_step(jcfg, JX_CTX, JxTrainerConfig(**kw))
    step = make_train_step(cfg, CTX, TrainerConfig(**kw))
    jp, js = jax.tree.map(jnp.asarray, ref), jx_adamw_init(ref)
    p = params_from_jax(ref, cfg, device="cpu")
    st = adamw_init(p)
    for i in range(steps):
        batch = _batch(cfg, seed * 100 + i)
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in
                                    batch.items()},
                           jnp.asarray(i, jnp.int32), jax.random.PRNGKey(0))
        p, st, m = step(p, st, batch, i)
        assert int(st["count"]) == int(js["count"]) == i + 1
        assert float(m["lr_scale"]) == pytest.approx(float(jm["lr_scale"]),
                                                     rel=1e-6, abs=1e-7)
        yield (m, jm, tree_leaves(p), jax.tree.leaves(jp),
               tree_leaves(st["m"]), jax.tree.leaves(js["m"]))


def test_train_steps_match_the_reference_float32():
    """Three steps without the bf16 cast, float32 activations."""
    for m, jm, p, jp, _, _ in _steps("llama3-8b", "float32", False, 0):
        assert abs(float(m["loss"]) - float(jm["loss"])) <= \
            LOSS_RTOL * abs(float(jm["loss"]))
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
            GNORM_RTOL * float(jm["grad_norm"])
        for a, b in zip(p, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=PARAM_ATOL)


@pytest.mark.parametrize("arch,seed", [("llama3-8b", 1)])
def test_train_steps_match_the_reference_bfloat16(arch, seed):
    """Three steps with the bf16 weight cast and bf16 activations; the
    first step's gradient leaf by leaf, through the first moments."""
    lr = TrainerConfig().adamw.lr
    for i, (m, jm, p, jp, mo, jmo) in enumerate(_steps(arch, "bfloat16",
                                                       True, seed)):
        assert abs(float(m["loss"]) - float(jm["loss"])) <= \
            BF16_LOSS_RTOL * abs(float(jm["loss"]))
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
            BF16_GNORM_RTOL * float(jm["grad_norm"])
        for j, (a, b) in enumerate(zip(mo, jmo) if i == 0 else ()):
            b = np.asarray(b)
            assert a.dtype == torch.float32 and a.shape == b.shape, j
            err = float(np.abs(a.numpy() - b).max()) / float(np.abs(b).max())
            assert err <= BF16_MOMENT_TOL, (j, tuple(b.shape), err)
        for a, b in zip(p, jp):                  # step 0 has lr_scale 0
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=2 * lr * i + 1e-6)


def test_trainer_through_a_plane_fail_and_heal_matches_the_reference():
    """Both Trainers on the synthetic pipeline's batches; plane 2 fails
    at step 2 and heals at step 6: per-step loss, grad norm, plane
    efficiency and planes up, and the recovery records."""
    cfg, jcfg, ref = _weights("llama3-8b", "float32")
    kw = dict(warmup_steps=2, total_steps=10, cast_params_bf16=False)
    tr = Trainer(cfg, CTX, TrainerConfig(plane=PlaneConfig(4, 8), **kw),
                 params_from_jax(ref, cfg, device="cpu"))
    jtr = JxTrainer(jcfg, JX_CTX, JxTrainerConfig(plane=JxPlaneConfig(4, 8),
                                                  **kw),
                    jax.tree.map(jnp.asarray, ref))
    dl = DataLoader(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4))
    for i, batch in zip(range(9), dl):
        if i == 2:
            tr.inject_plane_failure(2)
            jtr.inject_plane_failure(2)
        if i == 6:
            tr.heal_plane(2)
            jtr.heal_plane(2)
        m = tr.train_step({k: torch.from_numpy(v) for k, v in batch.items()})
        jm = jtr.train_step({k: jnp.asarray(v) for k, v in batch.items()})
        assert m["planes_up"] == jm["planes_up"] == (3 if 2 <= i < 6 else 4)
        assert m["plane_eff_bw"] == pytest.approx(jm["plane_eff_bw"],
                                                  rel=1e-6)
        assert m["loss"] == pytest.approx(jm["loss"], rel=TRAINER_LOSS_RTOL)
        assert m["grad_norm"] == pytest.approx(jm["grad_norm"],
                                               rel=TRAINER_GNORM_RTOL)
        assert m["lr_scale"] == pytest.approx(jm["lr_scale"], rel=1e-6)
    assert tr.step == jtr.step == 9
    assert [dataclasses.astuple(r) for r in tr.failover.records] == \
        [dataclasses.astuple(r) for r in jtr.failover.records]
    assert tr.failover.records[0].recovery_steps is not None
    np.testing.assert_array_equal(tr._report.assignment,
                                  jtr._report.assignment)
    assert len(tr.hft.records) == 9
    assert tr.hft.series("loss").shape == (9, 2)


def test_trainer_checkpoint_restart_replays_the_run(tmp_path):
    """Restart from a checkpoint reproduces the uninterrupted run (the
    reference's own check, on the port)."""
    cfg, _, ref = _weights("llama3-8b", "float32")
    tcfg = TrainerConfig(plane=PlaneConfig(4, 8), ckpt_dir=str(tmp_path),
                         ckpt_every=3, warmup_steps=2, total_steps=50)
    tr = Trainer(cfg, CTX, tcfg, params_from_jax(ref, cfg, device="cpu"))
    dl = DataLoader(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4))
    for _, b in zip(range(5), dl):
        m_ref = tr.train_step(b)
    tr2 = Trainer.restore(cfg, CTX, tcfg,
                          params_from_jax(ref, cfg, device="cpu"))
    assert tr2.step == 3
    for _, b in zip(range(2), DataLoader(dl.cfg, start_step=3)):
        m_replay = tr2.train_step(b)
    assert m_replay["loss"] == m_ref["loss"]
    for a, b in zip(tree_leaves(tr.params), tree_leaves(tr2.params)):
        assert torch.equal(a, b)


def test_launch_train_matches_the_reference(monkeypatch, capsys):
    """`python -m repro_torch.launch.train --arch llama3-8b --reduced
    --steps 4 --device cpu` (a plane failing at step 1 and healing at
    step 3), its weights the reference launcher's seed-0 draw: its final
    JSON against `repro.launch.train`'s (bf16 activations, the bf16
    weight cast: the loss within the measured bf16 tolerance)."""
    cfg = ARCHS["llama3-8b"].reduced()
    jcfg = JxModelConfig(**dataclasses.asdict(cfg))
    ref = jax.device_get(jx_init_params(jax.random.PRNGKey(0), jcfg))
    monkeypatch.setattr(launch, "init_params",
                        lambda c, g, d: params_from_jax(ref, c, device=d))
    args = ["--arch", "llama3-8b", "--reduced", "--steps", "4", "--batch",
            "2", "--seq", "64", "--fail-plane", "1:1", "--heal-plane", "3:1"]
    assert jx_launch.main(args) == 0
    want = capsys.readouterr().out.strip().splitlines()
    assert launch.main(args + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out.strip().splitlines()
    assert [line.split(" t ")[0] for line in got if "loss" not in line] \
        == [line.split(" t ")[0] for line in want if "loss" not in line]
    gj, wj = json.loads(got[-1]), json.loads(want[-1])
    assert gj["failovers"] == wj["failovers"]
    assert [f["plane"] for f in gj["failovers"]] == [1]
    assert gj["final_loss"] == pytest.approx(wj["final_loss"],
                                             rel=BF16_LOSS_RTOL)
    assert len(got) == len(want)
