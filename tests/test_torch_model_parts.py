"""Parts of the port's model forward against the JAX package on the
CPU: the reference's decode-vs-full-forward cases, the ring cache's
writes and the decode kernel's valid slots, chunked attention, the SSD
scan, the frontend stubs, the `ShardCtx` (one rank or a data-parallel
mesh).

Weights, inputs and tolerances as in `tests/test_torch_models.py`
(logits within 1e-4 in float32, every decode step teacher-forced).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jx_attention
from repro.models import multimodal as jx_multimodal
from repro.models import ssm as jx_ssm
from repro_torch.configs import ARCHS
from repro_torch.kernels import build
from repro_torch.models import (decode_step, init_caches, init_params,
                                prefill_step, standard_attention_layers)
from repro_torch.models import attention, multimodal, ssm
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import ShardCtx, sharding

from test_torch_models import (CTX, LOGIT_TOL, _Pair, _close, _inputs,
                               _jx_cfg, _np, _weights)


# ---------------------------------------------------------------------------
# the reference's decode-vs-full-forward cases
# ---------------------------------------------------------------------------

_FAMILIES = {
    "gqa": dict(block_pattern=("a", "l"), window=16, n_kv_heads=2),
    "mla": dict(use_mla=True, q_lora=32, kv_lora=32, rope_head_dim=8,
                nope_head_dim=16, v_head_dim=16),
    "ssm": dict(block_pattern=("m",), ssm_state=16, ssm_heads=4,
                ssm_head_dim=8, ssm_groups=2, ssm_chunk=8),
    "hybrid": dict(block_pattern=("m", "a"), ssm_state=16, ssm_heads=4,
                   ssm_head_dim=8, ssm_groups=2, ssm_chunk=8,
                   n_kv_heads=2, moe_experts=4, moe_topk=2,
                   moe_d_ff=64, moe_every=2, capacity_factor=8.0),
}


def _family_cfg(family: str, **over) -> ModelConfig:
    kw = dict(_FAMILIES[family])
    kw.update(over)
    return ModelConfig(name=family, n_layers=4, d_model=64, n_heads=4,
                       n_kv_heads=kw.pop("n_kv_heads", 4), head_dim=16,
                       d_ff=128, vocab=128, attn_chunk=16, remat="none",
                       dtype="float32", param_dtype="float32", **kw)


@pytest.mark.parametrize("family", list(_FAMILIES))
def test_decode_matches_full_forward(family):
    """The reference's `test_decode_matches_full_forward` on the port
    (prefill S then decode one token equals a prefill of S + 1, within
    the reference's 2e-4), and each logit against the reference."""
    cfg = _family_cfg(family)
    B, S = 2, 24
    toks, _ = _inputs(cfg, 42, B, S + 1)
    full = _Pair(cfg, 0, B, 64)
    lg_full, jl_full = full.prefill(toks)
    pair = _Pair(cfg, 0, B, 64)
    pair.prefill(toks[:, :S])
    lg_dec, jl_dec = pair.decode(toks[:, S:S + 1],
                                 np.full((B,), S, np.int32))
    np.testing.assert_allclose(_np(lg_dec), _np(lg_full), rtol=2e-4,
                               atol=2e-4)
    _close(lg_full, jl_full)
    _close(lg_dec, jl_dec)


# ---------------------------------------------------------------------------
# the ring cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [10, 16, 24, 32, 40])
def test_cache_write_matches_the_reference(S):
    """A prompt shorter than the 'l' layer's ring of 16, equal to it, a
    whole number of rings (the fast path) and longer without wrapping
    evenly (24, 40: slots repeat, and the last write wins), then decode
    steps past the wrap: the same slots and positions as the
    reference's cache, the same values (within 1e-4 of the largest),
    the same logits."""
    cfg = _family_cfg("gqa")
    B = 2
    toks, _ = _inputs(cfg, S, B, S + 6)
    pair = _Pair(cfg, 3, B, 64)
    tl, jl = pair.prefill(toks[:, :S])
    _close(tl, jl)
    for i in range(6):
        for tc, jc in zip(pair.tc["period"], pair.jc["period"]):
            np.testing.assert_array_equal(tc["pos"].numpy(),
                                          np.asarray(jc["pos"]))
            for n in ("k", "v"):
                # activations of deeper layers, up to ~12 in magnitude
                want = np.asarray(jc[n])
                np.testing.assert_allclose(
                    tc[n].numpy(), want, rtol=LOGIT_TOL,
                    atol=LOGIT_TOL * np.abs(want).max())
        tl, jl = pair.decode(toks[:, S + i:S + i + 1],
                             np.full((B,), S + i, np.int32))
        _close(tl, jl)
    assert pair.tc["period"][1]["pos"].shape[-1] == cfg.window


def _valid_reference(pos, q_pos, window):
    """The reference's decode valid set of a ring (chunked_attention's
    mask with k_pos = the cache's positions)."""
    valid = (pos >= 0) & (pos <= q_pos[:, None])
    if window > 0:
        valid &= pos > q_pos[:, None] - window
    return valid


def test_decode_lengths_give_the_reference_valid_set():
    """The CUDA decode route reads slots below `decode_lengths` (min(
    position + 1, size)); through a served sequence of requests that
    overlap, reuse slots, wrap the 'l' ring and leave stale rows, those
    slots are exactly the reference's valid set at every decode step
    of every active row."""
    from repro_torch.train import Request, ServeEngine
    cfg = _family_cfg("gqa")
    _, _, params = _weights(cfg, 0)
    eng = ServeEngine(cfg, CTX, params, batch=3, max_len=48)
    checked = [0]
    decode = eng._decode

    def checking(p, toks, pos, caches):
        logits, new = decode(p, toks, pos, caches)
        active = [i for i, r in enumerate(eng.slots) if r is not None]
        for c, kind in zip(new["period"], cfg.block_pattern):
            window = cfg.window if kind == "l" else 0
            for layer in range(cfg.n_periods):
                cpos = c["pos"][layer]
                size = cpos.shape[1]
                lens = attention.decode_lengths(pos[:, None], size)
                kernel = torch.arange(size)[None] < lens[:, None]
                want = _valid_reference(cpos, pos, window)
                assert torch.equal(kernel[active], want[active])
                checked[0] += 1
        return logits, new

    eng._decode = checking
    rng = np.random.default_rng(5)
    reqs = [Request(i, rng.integers(0, cfg.vocab, n).astype(np.int32), m)
            for i, (n, m) in enumerate([(5, 20), (20, 6), (12, 30),
                                        (30, 10), (3, 12)])]
    done = eng.run(reqs)
    assert len(done) == 5 and checked[0] > 100


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [8, 16, 48])
@pytest.mark.parametrize("window,G", [(0, 1), (6, 1), (0, 2), (5, 4)])
def test_chunked_attention_matches_the_reference(chunk, window, G):
    rng = np.random.default_rng(chunk + window + G)
    B, S, H, D = 2, 40, 4, 8
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, H // G, D)).astype(np.float32)
            for _ in range(2))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    got = attention.chunked_attention(*map(torch.from_numpy, (q, k, v, pos,
                                                              pos)),
                                      window=window, chunk=chunk)
    want = jx_attention.chunked_attention(*map(jnp.asarray, (q, k, v, pos,
                                                             pos)),
                                          window=window, chunk=chunk)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("s,chunk,init", [(24, 8, False), (21, 8, True),
                                          (5, 16, True)])
def test_ssd_scan_matches_the_reference(s, chunk, init):
    """The chunked scan, padded where s is not a multiple of the chunk
    (the padded steps' dt = 0 leaves the final state undecayed), from
    zero and from a given state; and one decode step."""
    rng = np.random.default_rng(s)
    b, h, p, g, n = 2, 4, 8, 2, 8
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(h) * 0.3).astype(np.float32)
    B, C = (rng.standard_normal((b, s, g, n)).astype(np.float32)
            for _ in range(2))
    st = rng.standard_normal((b, h, p, n)).astype(np.float32) if init \
        else None
    args = (x, dt, A, B, C)
    y, fin = ssm.ssd_scan(*map(torch.from_numpy, args), chunk,
                          init_state=None if st is None
                          else torch.from_numpy(st))
    jy, jfin = jx_ssm.ssd_scan(*map(jnp.asarray, args), chunk,
                               init_state=None if st is None
                               else jnp.asarray(st))
    _close(y, jy, 1e-4)
    _close(fin, jfin, 1e-4)
    st0 = np.zeros((b, h, p, n), np.float32) if st is None else st
    one = (st0, x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0])
    got = ssm.ssd_step(*map(torch.from_numpy, one))
    want = jx_ssm.ssd_step(*map(jnp.asarray, one))
    for g_, w_ in zip(got, want):
        _close(g_, w_, 1e-5)


def test_frontend_shapes_and_synthetic_embeds():
    cfg = ARCHS["llava-next-mistral-7b"].reduced()
    jcfg = _jx_cfg(cfg)
    assert multimodal.frontend_shape(cfg, 3) == \
        jx_multimodal.frontend_shape(jcfg, 3) == (3, 8, cfg.d_model)
    assert multimodal.frontend_shape(ARCHS["llama3-8b"], 3) is None
    a = multimodal.synth_frontend(cfg, 3, torch.Generator().manual_seed(1))
    b = multimodal.synth_frontend(cfg, 3, torch.Generator().manual_seed(1))
    assert a.shape == (3, 8, cfg.d_model) and a.dtype == torch.bfloat16
    assert torch.equal(a, b) and 0 < float(a.float().std()) < 0.05


def test_shard_ctx_is_one_rank(tmp_path):
    """Without a mesh and over a data-parallel mesh (a gloo group of one
    rank in this process, `make_mesh_for(1, 1)`) the `shard_*` functions
    return their input; a mesh whose model dim is above 1 raises naming
    ROADMAP queue 1 item 4c (a stand-in with a mesh's `shape` and dim
    names: one process cannot build it; `tests/test_torch_dp.py` builds
    it over two and four ranks)."""
    import types
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh_for
    x = torch.ones(2, 3, 4)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh_for(1, 1)
        for ctx in (ShardCtx(), ShardCtx(mesh)):
            assert ctx.tp_size == 1
            for f in (sharding.shard_residual, sharding.shard_heads,
                      sharding.shard_logits, sharding.shard_cache):
                assert f(x, ctx) is x
        assert ShardCtx().mesh is None and ShardCtx(mesh).mesh is mesh
        assert dist.get_process_group_ranks(
            ShardCtx(mesh).group(("data",))) == [0]
    finally:
        dist.destroy_process_group()
    tp = types.SimpleNamespace(shape=(1, 2), mesh_dim_names=("data", "model"))
    with pytest.raises(NotImplementedError, match="queue 1 item 4c"):
        ShardCtx(mesh=tp)
    with pytest.raises(NotImplementedError, match="queue 1 item 4c"):
        ShardCtx(mesh=types.SimpleNamespace(
            shape=(2, 1), mesh_dim_names=("data", "model")),
            fsdp_axis="data")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_standard_attention_layers_count_the_routed_calls(arch, monkeypatch):
    """`standard_attention_layers` (the launches a forward makes on the
    card, per prefill and per decode step) equals the calls a reduced
    forward makes to the two routed attention functions."""
    cfg = ARCHS[arch].reduced(dtype="float32")
    calls = {"prefill": 0, "decode": 0}

    def counted(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(attention, "_prefill_attention",
                        counted("prefill", attention._prefill_attention))
    monkeypatch.setattr(attention, "_decode_attention",
                        counted("decode", attention._decode_attention))
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    B, S = 2, 12
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, S + 1)).astype(np.int32))
    fe = (None if not cfg.frontend_tokens else
          multimodal.synth_frontend(cfg, B, torch.Generator().manual_seed(1)))
    caches = init_caches(cfg, B, 32, "float32", "cpu")
    _, caches = prefill_step(params, cfg, toks[:, :S], CTX, caches, fe)
    decode_step(params, cfg, toks[:, S:], torch.full((B,), S,
                                                     dtype=torch.int32),
                CTX, caches)
    n = standard_attention_layers(cfg)
    assert calls == {"prefill": n, "decode": n}
    assert n == (0 if cfg.use_mla else cfg.n_layers - sum(
        kind == "m" for kind in cfg.block_pattern) * cfg.n_periods)


def test_cpu_forward_launches_no_kernel():
    cfg = ARCHS["gemma3-12b"].reduced(dtype="float32")
    _, _, params = _weights(cfg, 0)
    build.reset_launches()
    caches = init_caches(cfg, 1, 32, "float32", "cpu")
    toks = torch.zeros(1, 8, dtype=torch.int32)
    _, caches = prefill_step(params, cfg, toks, CTX, caches)
    decode_step(params, cfg, toks[:, :1], torch.tensor([8], dtype=torch.int32),
                CTX, caches)
    assert all(n == 0 for n in build.LAUNCHES.values())


# ---------------------------------------------------------------------------
# decode attention in the model layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_bshd_plain_version_matches_the_reference(G, dtype):
    """`ops.decode_attention_bshd` on CPU tensors (its plain version)
    against the JAX package's decode oracle on the repeated kv heads,
    over a ring read through a period slice of a stacked cache; no
    launch."""
    from repro.kernels import ref as jx_ref
    from repro_torch.kernels import ops
    th = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    rng = np.random.default_rng(G)
    B, S, Hkv, D = 3, 40, 2, 64
    q = torch.from_numpy(rng.standard_normal((B, 1, Hkv * G, D)).astype(
        np.float32)).to(th)
    k, v = (torch.from_numpy(rng.standard_normal((2, B, S, Hkv, D)).astype(
        np.float32)).to(th)[1] for _ in range(2))
    lens = torch.tensor([0, 17, S], dtype=torch.int32)
    build.reset_launches()
    got = ops.decode_attention_bshd(q, k, v, lens)
    assert got.shape == q.shape and got.dtype == th
    assert all(n == 0 for n in build.LAUNCHES.values())

    def bhsd(t):
        return jnp.asarray(np.repeat(t.float().numpy(), G if t is not q
                                     else 1, axis=2).transpose(0, 2, 1, 3))
    want = jx_ref.decode_attention_ref(bhsd(q), bhsd(k), bhsd(v),
                                       jnp.asarray(lens.numpy()))
    tol = {"float32": 1e-5, "bfloat16": 2e-2}[dtype]
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32).transpose(
            0, 2, 1, 3), rtol=tol, atol=tol)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.decode_attention_bshd(q.to("meta"), k.to("meta"), v.to("meta"),
                                  lens.to("meta"))
