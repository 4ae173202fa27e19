"""The gradient of the port's training loss (`loss_fn` differentiated by
autograd) against `jax.value_and_grad` of the JAX package's, on the CPU,
and `remat`.

Weights are the reference's, carried across with `params_from_jax`;
batches come from numpy seeds and go to both.  On the CPU the port's
attention is its copy of the reference's `chunked_attention`; nothing
here launches a kernel (`tests/test_torch_gpu.py` and `chip_smoke.py`
hold the kernels' route to these results).  The train steps, the
`Trainer` and `launch.train` are in `tests/test_torch_train_loop.py`.

Tolerances, float32 (measured over the reduced config of every
architecture, seed 0): the loss within 1e-5 relative (measured up to
1.7e-7); each gradient leaf within 5e-4 of its largest magnitude
(measured up to 1.8e-4, jamba's: the two frameworks reduce the matmuls,
norms and the cross-entropy in other orders, and the reduced configs'
residual streams amplify it in the embedding and attention-projection
leaves).  gemma3-12b runs one period of its pattern (five local layers,
one global) to keep the reference's compile short.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import init_params as jx_init_params
from repro.models import loss_fn as jx_loss_fn
from repro.models.config import ModelConfig as JxModelConfig
from repro.parallel.sharding import local_ctx as jx_local_ctx
from repro_torch.configs import ARCHS
from repro_torch.models import (loss_fn, params_from_jax, tree_items,
                                tree_leaves, tree_unflatten)
from repro_torch.parallel import local_ctx

JX_CTX, CTX = jx_local_ctx(), local_ctx()
LOSS_RTOL = 1e-5
GRAD_TOL = 5e-4


@functools.lru_cache(maxsize=None)
def _weights(arch: str, dtype: str, seed: int = 0):
    cfg = ARCHS[arch].reduced(dtype=dtype)
    if arch == "gemma3-12b":
        cfg = dataclasses.replace(cfg, n_layers=cfg.pattern_len)
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


def _grads_match(arch):
    cfg, jcfg, ref = _weights(arch, "float32")
    batch = _batch(cfg, 0)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: jx_loss_fn(p, jcfg, b, JX_CTX)[0]))(
        ref, {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_jax(ref, cfg, device="cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss = loss_fn(tree_unflatten(params, leaves), cfg,
                   {k: torch.from_numpy(v) for k, v in batch.items()},
                   CTX)[0]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    loss = float(loss.detach())
    assert abs(loss - float(jl)) <= LOSS_RTOL * abs(float(jl))
    for (path, _), g, w in zip(tree_items(params), grads,
                               jax.tree.leaves(jg)):
        w = np.asarray(w)
        g = np.zeros_like(w) if g is None else g.numpy()
        assert g.shape == w.shape, path
        err = float(np.abs(g - w).max())
        assert err <= GRAD_TOL * max(float(np.abs(w).max()), 1e-30), \
            (path, err)


@pytest.mark.parametrize("arch", ["llama3-8b", "phi3.5-moe-42b-a6.6b",
                                  "gemma3-12b"])
def test_loss_and_grads_match_the_reference(arch):
    """Dense, MoE and gemma3's local/global pattern."""
    _grads_match(arch)


@pytest.mark.slow
@pytest.mark.parametrize("arch", ["mamba2-780m", "jamba-v0.1-52b",
                                  "deepseek-v2-236b", "llava-next-mistral-7b",
                                  "musicgen-medium", "gemma-2b",
                                  "granite-20b", "spx-100m",
                                  "deepseek-v3-proxy"])
def test_loss_and_grads_match_the_reference_every_family(arch):
    _grads_match(arch)


def test_remat_full_equals_none_on_the_cpu():
    """`torch.utils.checkpoint` runs each period's forward again in the
    backward: the loss and every gradient are the same bits."""
    cfg, _, ref = _weights("gemma3-12b", "float32")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 3).items()}
    out = []
    for remat in ("none", "full"):
        c = dataclasses.replace(cfg, remat=remat)
        params = params_from_jax(ref, c, device="cpu")
        leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
        loss = loss_fn(tree_unflatten(params, leaves), c, batch, CTX)[0]
        out.append((loss, torch.autograd.grad(loss, leaves)))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    for remat in ("dots", "kv"):
        with pytest.raises(NotImplementedError, match="queue 1 item 4"):
            loss_fn(params, dataclasses.replace(cfg, remat=remat), batch,
                    CTX)


