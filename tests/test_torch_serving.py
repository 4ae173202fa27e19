"""The port's serving engine (`repro_torch.train.ServeEngine`) on the CPU,
against greedy `prefill_step`/`decode_step` loops of the port and of the
JAX package, and against the JAX package's own engine.

The model has a full-attention and a sliding-window layer (window 16)
in each of two periods, so a stacked cache leaf is (2, batch, ...) and
`batch == n_periods` at batch 2.  Weights are the reference's, carried
across with `params_from_jax`; prompts come from a numpy seed.  Tokens
are compared exactly: the argmax of logits that agree within 1e-4.

The reference's `ServeEngine.add_request` (`src/repro/train/serving.py`)
keeps the other slots' cache rows with `old.at[slot].set(new[slot])`
where a leaf's leading axis equals the batch, and the whole new prefill
otherwise.  Period leaves are stacked (n_periods, B, ...), so with
batch != n_periods an admission replaces every active row's cache, and
with batch == n_periods the restore writes along the period axis.  The
port restores along the batch axis (ROADMAP queue 3);
`test_reference_engine_departs_from_the_greedy_loop` shows the fault.
"""
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import decode_step as jx_decode_step
from repro.models import init_caches as jx_init_caches
from repro.models import prefill_step as jx_prefill_step
from repro.train import Request as JxRequest
from repro.train import ServeEngine as JxServeEngine
from repro_torch.kernels import build
from repro_torch.models import (attention, decode_step, init_caches,
                                prefill_step, standard_attention_layers)
from repro_torch.models.config import ModelConfig
from repro_torch.train import Request, ServeEngine

from test_torch_models import CTX, JX_CTX, _weights

CFG = ModelConfig(name="serve", n_layers=4, d_model=64, n_heads=4,
                  n_kv_heads=2, head_dim=16, d_ff=128, vocab=128,
                  block_pattern=("a", "l"), window=16, attn_chunk=16,
                  remat="none", dtype="float32", param_dtype="float32")
MAX_LEN = 48
# (prompt length, max_new): more requests than slots, so they overlap
# and slots are reused; prompts shorter and longer than the window
SHAPES = ((5, 8), (20, 4), (12, 10), (9, 6), (30, 5))


def _prompts(shapes=SHAPES, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, CFG.vocab, n).astype(np.int32), m)
            for n, m in shapes]


def _port_greedy(prompt, max_new):
    """One request alone: prefill, then decode steps feeding back the
    argmax, as the engine does (the first token from the prefill)."""
    _, _, params = _weights(CFG, 0)
    caches = init_caches(CFG, 1, MAX_LEN, "float32", "cpu")
    logits, caches = prefill_step(params, CFG, torch.from_numpy(prompt[None]),
                                  CTX, caches)
    out = [int(torch.argmax(logits[0, -1]))]
    for k in range(1, max_new):
        logits, caches = decode_step(
            params, CFG, torch.tensor([[out[-1]]], dtype=torch.int32),
            torch.tensor([len(prompt) + k - 1], dtype=torch.int32), CTX,
            caches)
        out.append(int(torch.argmax(logits[0, -1])))
    return out


@functools.lru_cache(maxsize=None)
def _jx_steps():
    jcfg, ref, _ = _weights(CFG, 0)
    prefill = jax.jit(lambda p, t, c: jx_prefill_step(p, jcfg, t, JX_CTX, c))
    decode = jax.jit(lambda p, t, q, c: jx_decode_step(p, jcfg, t, q,
                                                       JX_CTX, c))
    return jcfg, ref, prefill, decode


def _jx_greedy(prompt, max_new):
    jcfg, ref, prefill, decode = _jx_steps()
    caches = jx_init_caches(jcfg, 1, MAX_LEN, jnp.float32)
    logits, caches = prefill(ref, jnp.asarray(prompt[None]), caches)
    out = [int(jnp.argmax(logits[0, -1]))]
    for k in range(1, max_new):
        logits, caches = decode(ref, jnp.asarray([[out[-1]]], jnp.int32),
                                jnp.asarray([len(prompt) + k - 1],
                                            jnp.int32), caches)
        out.append(int(jnp.argmax(logits[0, -1])))
    return out


@pytest.fixture(scope="module")
def greedy():
    """Each request's tokens from the port's loop, which must equal the
    reference's loop."""
    out = []
    for prompt, max_new in _prompts():
        port = _port_greedy(prompt, max_new)
        assert port == _jx_greedy(prompt, max_new)
        out.append(port)
    return out


def _serve(batch, prompts=None):
    _, _, params = _weights(CFG, 0)
    eng = ServeEngine(CFG, CTX, params, batch=batch, max_len=MAX_LEN)
    reqs = [Request(i, p, m) for i, (p, m) in enumerate(prompts or
                                                         _prompts())]
    done = eng.run(reqs)
    assert sorted(r.rid for r in done) == list(range(len(reqs)))
    return [r.out for r in reqs]


def _jx_serve(batch, prompts=None):
    jcfg, ref, _, _ = _jx_steps()
    eng = JxServeEngine(jcfg, JX_CTX, ref, batch=batch, max_len=MAX_LEN)
    reqs = [JxRequest(i, p, m) for i, (p, m) in enumerate(prompts or
                                                           _prompts())]
    eng.run(reqs)
    return [r.out for r in reqs]


@pytest.mark.parametrize("batch", [2, 3], ids=["batch==n_periods",
                                               "batch!=n_periods"])
def test_engine_equals_the_greedy_loops(greedy, batch):
    """Five requests through 2 or 3 slots (admissions while others are
    active, slots reused): each request's tokens equal its greedy loop
    alone, the port's and the reference's."""
    assert CFG.n_periods == 2
    build.reset_launches()
    assert _serve(batch) == greedy
    assert all(n == 0 for n in build.LAUNCHES.values())


def test_engine_equals_the_reference_engine_at_batch_1(greedy):
    """At batch 1 the reference's restore keeps the whole new prefill,
    which is right: both engines give the greedy tokens."""
    assert _serve(1) == _jx_serve(1) == greedy


@pytest.mark.parametrize("batch,shapes", [
    (2, ((9, 6),)),                   # batch == n_periods: one request
    (3, ((9, 6), (20, 4))),           # the second admission's prefill
], ids=["batch==n_periods", "batch!=n_periods"])
def test_reference_engine_departs_from_the_greedy_loop(batch, shapes):
    """The reference's engine fault: with batch == n_periods even a lone
    request decodes wrong (the restore writes along the period axis);
    with batch != n_periods a second admission replaces the first
    request's cache.  The port's engine gives the greedy tokens."""
    prompts = _prompts(shapes, seed=3)
    want = [_port_greedy(p, m) for p, m in prompts]
    assert _serve(batch, prompts) == want
    assert _jx_serve(batch, prompts)[0] != want[0]


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_attention_routes_on_cpu(greedy):
    """chip_smoke.py's routes on the CPU path: `held_on_card` holds each
    attention call of a served run (one a layer per admission and per
    step) to the kernels' plain versions on the call's own inputs, and
    fails a route that is off by 1; under `plain_on_card` the engine
    still gives the greedy tokens."""
    smoke = _chip_smoke()
    held: dict = {}
    with smoke.held_on_card(1e-4, held):
        assert _serve(3) == greedy
    (n_pre, e_pre, _), (n_dec, e_dec, _) = (held["flash_attention"],
                                            held["decode_attention"])
    n = standard_attention_layers(CFG)
    assert n_pre == n * len(SHAPES) and n_dec % n == 0 and n_dec > 0
    assert e_pre <= 1e-4 and e_dec <= 1e-4
    with smoke.plain_on_card():
        assert _serve(3) == greedy
    right = attention._prefill_attention

    def off(*args):
        return right(*args) + 1.0

    with smoke.attention_route(off, attention._decode_attention), \
            smoke.held_on_card(1e-4, {}), \
            pytest.raises(AssertionError, match="flash_attention"):
        _serve(3)
    assert attention._prefill_attention is right


def test_engine_keeps_other_rows_and_runs_without_autograd():
    """An admission changes only its slot's rows (axis 0 of prefix
    leaves, axis 1 of stacked period leaves), and the steps run under
    inference mode."""
    cfg = ModelConfig(name="prefix", n_layers=3, n_prefix_layers=1,
                      d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
                      d_ff=64, vocab=64, block_pattern=("a",),
                      dtype="float32", param_dtype="float32")
    _, _, params = _weights(cfg, 1)
    eng = ServeEngine(cfg, CTX, params, batch=3, max_len=32)
    assert eng.add_request(Request(0, np.arange(7, dtype=np.int32), 4))
    before = jax.tree.map(lambda t: t.clone(), eng.caches)
    assert eng.add_request(Request(1, np.arange(3, 12, dtype=np.int32), 4))
    for old, new, axis in (
            (before["prefix"][0], eng.caches["prefix"][0], 0),
            (before["period"][0], eng.caches["period"][0], 1)):
        for k in old:
            keep = [i for i in range(3) if i != 1]
            assert torch.equal(old[k].index_select(axis, torch.tensor(keep)),
                               new[k].index_select(axis, torch.tensor(keep)))
            assert not torch.equal(old[k].select(axis, 1),
                                   new[k].select(axis, 1))
    eng.step()
    assert all(t.is_inference() for t in jax.tree.leaves(eng.caches))
