"""The gradient of the port's training loss (`loss_fn` differentiated by
autograd) against `jax.value_and_grad` of the JAX package's, on the CPU,
and `remat` ("full", and the selective "dots" and "kv").

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
one global) to keep the reference's compile short.  Under remat "dots"
and "kv" the port's loss and gradients equal "none" bit for bit (a
selective checkpoint recomputes the same ops on the same inputs), and
the gradients are held to the reference's under the same policy with
the tolerances above.
"""
import dataclasses
import functools

from torch.utils._python_dispatch import TorchDispatchMode

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


def _grads_match(arch, remat=None):
    cfg, jcfg, ref = _weights(arch, "float32")
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
        jcfg = dataclasses.replace(jcfg, remat=remat)
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


def _loss_and_grads(cfg, params, batch):
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss = loss_fn(tree_unflatten(params, leaves), cfg, batch, CTX)[0]
    return loss, torch.autograd.grad(loss, leaves, allow_unused=True)


def _same(a, b) -> bool:
    (la, ga), (lb, gb) = a, b
    return torch.equal(la, lb) and all(
        (x is None and y is None) or torch.equal(x, y)
        for x, y in zip(ga, gb))


def test_remat_full_equals_none_on_the_cpu():
    """`torch.utils.checkpoint` runs each period's forward again in the
    backward: the loss and every gradient are the same bits, under
    "full" and under the selective "dots" and "kv"."""
    cfg, _, ref = _weights("gemma3-12b", "float32")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 3).items()}
    params = params_from_jax(ref, cfg, device="cpu")
    base = _loss_and_grads(dataclasses.replace(cfg, remat="none"), params,
                           batch)
    for remat in ("full", "dots", "kv"):
        assert _same(_loss_and_grads(dataclasses.replace(cfg, remat=remat),
                                     params, batch), base), remat


@pytest.mark.parametrize("remat", ["dots", "kv"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_remat_policies_equal_none_on_the_cpu(arch, remat):
    """Every reduced config (init from a seed on the port's side)."""
    from repro_torch.models import init_params
    cfg = ARCHS[arch].reduced(dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 4, S=16).items()}
    base = _loss_and_grads(dataclasses.replace(cfg, remat="none"), params,
                           batch)
    assert _same(_loss_and_grads(dataclasses.replace(cfg, remat=remat),
                                 params, batch), base)


@pytest.mark.parametrize("remat", ["dots", "kv"])
@pytest.mark.parametrize("arch", ["llama3-8b", "phi3.5-moe-42b-a6.6b",
                                  "gemma3-12b"])
def test_remat_policies_match_the_reference(arch, remat):
    """The reference's `jax.checkpoint` under the same policy."""
    _grads_match(arch, remat)


@pytest.mark.slow
@pytest.mark.parametrize("remat", ["dots", "kv"])
@pytest.mark.parametrize("arch", ["mamba2-780m", "jamba-v0.1-52b",
                                  "deepseek-v2-236b", "llava-next-mistral-7b",
                                  "musicgen-medium", "gemma-2b",
                                  "granite-20b", "spx-100m",
                                  "deepseek-v3-proxy"])
def test_remat_policies_match_the_reference_every_family(arch, remat):
    _grads_match(arch, remat)


class _Recomputed(TorchDispatchMode):
    """Counts the ops a backward dispatches with grad enabled: the
    checkpoints' recomputed forwards (the backward formulas run with grad
    disabled), and every K and V tag (a custom op runs below autograd,
    with grad disabled; no backward formula calls it).  An op a selective
    checkpoint saved is answered from its cache and never reaches this
    mode."""

    def __init__(self):
        super().__init__()
        self.unbatched_dots = 0
        self.kv_tags = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.repro_torch.kv_tag.default:
            self.kv_tags += 1
        if torch.is_grad_enabled():
            self.ops += 1
            aten = torch.ops.aten
            if func in (aten.mm.default, aten.addmm.default) or (
                    func is aten.bmm.default and args[0].shape[0] == 1):
                self.unbatched_dots += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("remat", ["none", "full", "dots", "kv"])
def test_remat_policies_save_what_they_should(remat):
    """What the backward recomputes: nothing under "none"; every
    unbatched product under "full"; none of them under "dots" (saved),
    though the rest of the forward is recomputed; under "kv" the
    products again but not the K and V tags (saved), which the forward
    made once for each attention layer."""
    from repro_torch.models import init_params
    cfg = dataclasses.replace(ARCHS["llama3-8b"].reduced(dtype="float32"),
                              remat=remat)
    params = init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 5).items()}
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with _Recomputed() as fwd:
        loss = loss_fn(tree_unflatten(params, leaves), cfg, batch, CTX)[0]
    seed = torch.ones_like(loss)
    with _Recomputed() as bwd:
        torch.autograd.grad(loss, leaves, seed)
    assert fwd.kv_tags == (2 * cfg.n_layers if remat == "kv" else 0)
    assert fwd.unbatched_dots > 0
    if remat == "none":
        assert bwd.ops == 0
        return
    assert bwd.ops > 0 and bwd.kv_tags == 0
    if remat == "dots":
        assert bwd.unbatched_dots == 0
    else:
        assert bwd.unbatched_dots > 0


@pytest.mark.parametrize("remat", ["full", "dots", "kv"])
def test_remat_recompute_through_the_kernel_route(remat, monkeypatch):
    """The CUDA route on the CPU: attention through
    `flash_attention._FlashAttention` with its launches emulated by the
    plain versions written through numpy into the `torch.empty` outputs,
    a write aten never sees, as the kernels' ctypes launches are.  The
    recomputed forward launches give the first forward's outputs bit for
    bit (no policy handed a launch an output it had cached), and the
    loss and gradients equal "none" on the same route."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref as kref
    from repro_torch.models import attention, init_params
    launches = []

    def launch(q, k, v, layout, causal, window):
        assert layout == "bshd"
        out, lse = torch.empty_like(q), torch.empty(
            (q.shape[0], q.shape[2], q.shape[1]), dtype=torch.float32)
        with torch.no_grad():
            out.numpy()[...] = kref.flash_attention_bshd_ref(
                q, k, v, causal=causal, window=window).numpy()
            lse.numpy()[...] = kref.flash_attention_lse_ref(
                q, k, v, causal=causal, window=window).numpy()
        launches.append((out, lse, out.clone(), lse.clone()))
        return out, lse

    def launch_bwd(q, k, v, out, dout, lse, layout, causal, window):
        return kref.flash_attention_bwd_ref(q, k, v, out, dout, lse,
                                            causal=causal, window=window)

    def prefill(q, k, v, positions, window, cfg, ctx):
        return fa._FlashAttention.apply(q, k, v, "bshd", True, window)

    monkeypatch.setattr(fa, "_launch", launch)
    monkeypatch.setattr(fa, "_launch_bwd", launch_bwd)
    monkeypatch.setattr(attention, "_prefill_attention", prefill)
    cfg = ARCHS["gemma3-12b"].reduced(dtype="float32")
    cfg = dataclasses.replace(cfg, n_layers=cfg.pattern_len)
    params = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 6).items()}
    base = _loss_and_grads(dataclasses.replace(cfg, remat="none"), params,
                           batch)
    n = cfg.n_layers
    assert len(launches) == n
    launches.clear()
    got = _loss_and_grads(dataclasses.replace(cfg, remat=remat), params,
                          batch)
    assert len(launches) == 2 * n
    for (o1, l1, c1, m1), (o2, l2, c2, m2) in zip(launches[:n],
                                                  launches[n:]):
        assert o1.data_ptr() != o2.data_ptr()
        assert torch.equal(c1, c2) and torch.equal(m1, m2)
        assert torch.equal(o1, c1) and torch.equal(o2, c2)
    assert _same(got, base)
