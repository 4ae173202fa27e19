"""The port's model forward (`repro_torch.models`) against the JAX package
on the CPU.

Weights are the reference's, carried across bit for bit with
`params_from_jax`; tokens, frontend embeddings and other inputs come
from numpy seeds and go to both.  On the CPU the port's attention is its
copy of the reference's `chunked_attention`, so nothing here launches a
kernel (`tests/test_torch_gpu.py` and `chip_smoke.py` hold the CUDA
route to these results).

Tolerances (float32): logits within 1e-4 (rtol and atol), the loss
within 1e-5 relative; every decode step is teacher-forced, so one
step's error does not pick the next step's token.  The two frameworks
sum the matmuls and reductions in other orders; on the reduced configs
of every architecture the largest logit difference was 5.8e-5
(phi3.5-moe) and the loss agreed within 2.4e-7.  bfloat16 has its own
tolerance, measured over seeds (`test_bfloat16_forward_matches_the_reference`).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED
from repro.data import synthetic as jx_synthetic
from repro.models import moe as jx_moe
from repro.models import decode_step as jx_decode_step
from repro.models import init_caches as jx_init_caches
from repro.models import init_params as jx_init_params
from repro.models import loss_fn as jx_loss_fn
from repro.models import prefill_step as jx_prefill_step
from repro.models.config import ModelConfig as JxModelConfig
from repro.parallel.sharding import local_ctx as jx_local_ctx
from repro_torch.configs import ARCHS
from repro_torch.data import synthetic
from repro_torch.models import (decode_step, init_caches, loss_fn,
                                params_from_jax, prefill_step)
from repro_torch.models import moe
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import local_ctx

JX_CTX, CTX = jx_local_ctx(), local_ctx()
LOGIT_TOL = 1e-4
LOSS_RTOL = 1e-5


def _jx_cfg(cfg: ModelConfig) -> JxModelConfig:
    return JxModelConfig(**dataclasses.asdict(cfg))


@functools.lru_cache(maxsize=None)
def _weights(cfg: ModelConfig, seed: int):
    """The reference's parameters for `cfg`, and the port's copy (shared
    by the tests of one process; nothing writes them)."""
    jcfg = _jx_cfg(cfg)
    ref = jax.device_get(jax.jit(lambda k: jx_init_params(k, jcfg))(
        jax.random.PRNGKey(seed)))
    return jcfg, ref, params_from_jax(ref, cfg, device="cpu")


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _layer(tree, i):
    """Period `i`'s view of a stacked parameter tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _close(got, want, tol=LOGIT_TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


class _Pair:
    """The port and the reference stepped side by side on one batch."""

    def __init__(self, cfg: ModelConfig, seed: int, batch: int,
                 max_len: int):
        self.cfg = cfg
        self.jcfg, self.ref, self.params = _weights(cfg, seed)
        self.jc = jx_init_caches(self.jcfg, batch, max_len,
                                 jnp.dtype(cfg.dtype))
        self.tc = init_caches(cfg, batch, max_len, cfg.dtype, "cpu")
        jcfg = self.jcfg
        self._jx_prefill = jax.jit(lambda p, t, c, f: jx_prefill_step(
            p, jcfg, t, JX_CTX, c, f))
        self._jx_decode = jax.jit(lambda p, t, q, c: jx_decode_step(
            p, jcfg, t, q, JX_CTX, c))

    def prefill(self, toks, fe=None):
        jl, self.jc = self._jx_prefill(
            self.ref, jnp.asarray(toks), self.jc,
            None if fe is None else jnp.asarray(fe))
        tl, self.tc = prefill_step(
            self.params, self.cfg, torch.from_numpy(toks), CTX, self.tc,
            None if fe is None else torch.from_numpy(fe))
        return tl, jl

    def decode(self, toks, pos):
        jl, self.jc = self._jx_decode(self.ref, jnp.asarray(toks),
                                      jnp.asarray(pos), self.jc)
        tl, self.tc = decode_step(self.params, self.cfg,
                                  torch.from_numpy(toks),
                                  torch.from_numpy(pos), CTX, self.tc)
        return tl, jl


def _inputs(cfg: ModelConfig, seed: int, B: int, S: int):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    fe = None
    if cfg.frontend != "none" and cfg.frontend_tokens:
        fe = (rng.standard_normal((B, cfg.frontend_tokens, cfg.d_model))
              * 0.02).astype(np.float32)
    return toks, fe


def _forward_pair(cfg: ModelConfig, seed: int, tol: float, loss_rtol: float,
                  B: int = 2, S: int = 24, steps: int = 4):
    """Prefill S tokens, `steps` teacher-forced decode steps and the loss,
    each held to the reference."""
    toks, fe = _inputs(cfg, seed, B, S + steps + 1)
    pair = _Pair(cfg, seed, B, 64)
    tl, jl = pair.prefill(toks[:, :S], fe)
    assert tl.shape == (B, 1, cfg.vocab) and tl.dtype == torch.float32
    _close(tl, jl, tol)
    for i in range(steps):
        pos = np.full((B,), S + i, np.int32)
        tl, jl = pair.decode(toks[:, S + i:S + i + 1], pos)
        _close(tl, jl, tol)
    batch = {"tokens": toks[:, :S], "labels": toks[:, 1:S + 1],
             "mask": (np.arange(S)[None] % 5 != 3).repeat(B, 0)}
    if fe is not None:
        batch["frontend_embeds"] = fe
    jloss, jm = jx_loss_fn(pair.ref, pair.jcfg,
                           {k: jnp.asarray(v) for k, v in batch.items()},
                           JX_CTX)
    tloss, tm = loss_fn(pair.params, cfg,
                        {k: torch.from_numpy(v) for k, v in batch.items()},
                        CTX)
    for got, want in ((tloss, jloss), (tm["ce"], jm["ce"]),
                      (tm["aux"], jm["aux"])):
        np.testing.assert_allclose(float(got), float(want), rtol=loss_rtol,
                                   atol=1e-7)


# ---------------------------------------------------------------------------
# every architecture, float32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ASSIGNED)
def test_forward_matches_the_reference(arch):
    """prefill_step, four decode steps and loss_fn of each family's
    reduced config: GQA with 'l' + 'g' (gemma3), MLA with MoE and shared
    experts (deepseek-v2), MoE (phi3.5), SSM (mamba2), hybrid (jamba),
    audio and vision frontends (musicgen, llava)."""
    cfg = ARCHS[arch].reduced(dtype="float32")
    _forward_pair(cfg, seed=1, tol=LOGIT_TOL, loss_rtol=LOSS_RTOL)


def test_moe_with_capacity_drops_matches_the_reference():
    """phi3.5-moe at capacity factor 0.5: some routed entries overflow
    their expert and are dropped, in both packages alike."""
    cfg = ARCHS["phi3.5-moe-42b-a6.6b"].reduced(dtype="float32",
                                                 capacity_factor=0.5)
    B, S = 2, 24
    _, ref, params = _weights(cfg, 4)
    p = params["period"][0]["mlp"]
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32))
    w, idx, _ = moe._topk_route(p["router"][0], x.reshape(B * S, -1), cfg)
    ranks = moe._ranks_within_expert(idx.reshape(-1), cfg.moe_experts)
    assert int(ranks.max()) >= moe._capacity(B * S, cfg)      # drops
    got, aux = moe.apply_moe(_layer(p, 0), cfg, x, CTX)
    jp = jax.tree.map(lambda a: a[0], ref["period"][0]["mlp"])
    want, jaux = jx_moe.apply_moe(jp, _jx_cfg(cfg), jnp.asarray(x.numpy()),
                                  JX_CTX)
    _close(got, want)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    _forward_pair(cfg, seed=4, tol=LOGIT_TOL, loss_rtol=LOSS_RTOL)


def test_moe_ranks_and_top_k_ties():
    """Equal router probabilities pick the lower expert indices, as
    `jax.lax.top_k` does, and arrival ranks are stable."""
    cfg = ARCHS["phi3.5-moe-42b-a6.6b"].reduced(dtype="float32")
    x = torch.ones(5, cfg.d_model)
    w, idx, _ = moe._topk_route(torch.zeros(cfg.d_model, cfg.moe_experts),
                                x, cfg)
    _, jidx, _ = jx_moe._topk_route(jnp.zeros((cfg.d_model,
                                               cfg.moe_experts)),
                                    jnp.ones((5, cfg.d_model)), _jx_cfg(cfg))
    assert idx.tolist() == np.asarray(jidx).tolist() == [[0, 1]] * 5
    eids = np.random.default_rng(0).integers(0, 4, 50).astype(np.int32)
    assert moe._ranks_within_expert(torch.from_numpy(eids), 4).tolist() == \
        np.asarray(jx_moe._ranks_within_expert(jnp.asarray(eids), 4)).tolist()


# ---------------------------------------------------------------------------
# bfloat16
# ---------------------------------------------------------------------------

# llama3-8b reduced in bfloat16 (its compute dtype), seeds 0-9: the
# largest logit difference to the reference was 0.109 (seed 8; logits
# up to 3.5 in magnitude, where a bf16 ulp is 0.016) and the largest
# relative loss difference 4.3e-4 (seed 6).  The tolerances hold over
# twice that.
BF16_LOGIT_TOL = 0.25
BF16_LOSS_RTOL = 1e-3


@pytest.mark.parametrize("seed", [6, 8])
def test_bfloat16_forward_matches_the_reference(seed):
    cfg = ARCHS["llama3-8b"].reduced()
    assert cfg.dtype == "bfloat16"
    toks, _ = _inputs(cfg, seed, 2, 29)
    pair = _Pair(cfg, seed, 2, 64)
    tl, jl = pair.prefill(toks[:, :24])
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=0,
                               atol=BF16_LOGIT_TOL)
    for i in range(4):
        tl, jl = pair.decode(toks[:, 24 + i:25 + i],
                             np.full((2,), 24 + i, np.int32))
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=0,
                                   atol=BF16_LOGIT_TOL)
    batch = {"tokens": toks[:, :24], "labels": toks[:, 1:25]}
    jloss, _ = jx_loss_fn(pair.ref, pair.jcfg,
                          {k: jnp.asarray(v) for k, v in batch.items()},
                          JX_CTX)
    tloss, _ = loss_fn(pair.params, cfg,
                       {k: torch.from_numpy(v) for k, v in batch.items()},
                       CTX)
    np.testing.assert_allclose(float(tloss), float(jloss),
                               rtol=BF16_LOSS_RTOL)


# ---------------------------------------------------------------------------
# synthetic data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(vocab=256, seq_len=33, global_batch=4),
    dict(vocab=128256, seq_len=64, global_batch=8, seed=7),
    dict(vocab=1000, seq_len=16, global_batch=6, frontend_tokens=4,
         d_model=24),
])
def test_synthetic_data_equals_the_reference(kw):
    cfg, jcfg = synthetic.DataConfig(**kw), jx_synthetic.DataConfig(**kw)
    for step, shard, n in ((0, 0, 1), (3, 1, 2), (11, 0, 2)):
        got = synthetic.batch_at(cfg, step, shard, n)
        want = jx_synthetic.batch_at(jcfg, step, shard, n)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    loader = synthetic.DataLoader(cfg, start_step=2)
    next(loader)
    again = synthetic.DataLoader.restore(cfg, loader.state())
    np.testing.assert_array_equal(next(again)["tokens"],
                                  jx_synthetic.batch_at(jcfg, 3)["tokens"])
