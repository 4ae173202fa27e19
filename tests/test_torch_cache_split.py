"""The sequence-split caches on the CPU, in one process: the layout rule
(`sharding.cache_split`) against the reference's `shard_cache`, a rank's
cache writes against the whole ring's, the bytes a rank holds, the
decode kernel's log-sum-exp entry (its plain version) and the merge of
partial softmaxes (`attention.merge_partials`).

A rank is a stand-in context: a mesh with a `shape`, dim names and the
rank's coordinate, which is all the rule and the writes read.  The
split forwards and serving run over gloo ranks in
`tests/test_torch_tp.py` and `tests/test_torch_tp_fsdp.py`.

Tolerances (float32: the rescaled sums and the softmax round
otherwise): the merge of 2 and 4 partials against one partial over the
whole within MERGE_TOL times the largest |v| (measured 2.4e-7 absolute,
|v| up to 4.6); the plain log-sum-exp entry's output against the plain
decode entry within MERGE_TOL (measured 3.6e-7), its log-sum-exp
against a float64 one within 1e-6.
"""
import types

import numpy as np
import pytest
import torch

from repro.parallel import sharding as jx_sharding
from repro_torch.configs import ARCHS
from repro_torch.kernels import ops, ref
from repro_torch.models import (init_caches, shard_caches, tree_items,
                                tree_unflatten)
from repro_torch.models.attention import (_cache_write, _ring,
                                          decode_lengths, merge_partials)
from repro_torch.parallel import ShardCtx, sharding

MERGE_TOL = 2e-6


def _rank(tp: int, r: int) -> ShardCtx:
    """Rank r of a (data 1, model tp) mesh."""
    return ShardCtx(mesh=types.SimpleNamespace(
        shape=(1, tp), mesh_dim_names=("data", "model"),
        get_local_rank=lambda dim: r))


def _ref_axis(shape, tp: int) -> str:
    """What the reference's `shard_cache` splits of a leaf of `shape` at a
    model dim of `tp`: "heads", "slots" or "whole" (its sharding
    constraint stubbed to hand back the spec)."""
    ctx = jx_sharding.ShardCtx(mesh=types.SimpleNamespace(
        shape={"data": 1, "model": tp}))
    got = jx_sharding.shard_cache(np.zeros(shape, np.float32), ctx,
                                  kv_heads_axis=2)
    if isinstance(got, np.ndarray):
        return "whole"
    return {2: "heads", 1: "slots"}[tuple(got).index("model")]


@pytest.mark.parametrize("tp", [2, 4])
def test_cache_split_picks_what_the_reference_picks(tp, monkeypatch):
    """K/V leaves (B, S, Hkv, D) and latent leaves (B, S, kv_lora) over
    rings and kv-head counts that divide the model dim and that do not:
    the port's rule picks the reference's axis, its range is the rank's
    even share, and `shard_cache` cuts a K/V leaf to its kv heads, keeps
    a whole one and refuses a split along S (a leaf alone cannot carry
    the ring's size; `shard_caches` cuts those, below)."""
    monkeypatch.setattr(jx_sharding, "_constraint",
                        lambda x, ctx, spec: spec)
    for S in (1, 2, 3, 6, 8, 12, 32, 48):
        for H in (1, 2, 3, 4, 8):
            want = _ref_axis((2, S, H, 4), tp)
            for r in range(tp):
                split = sharding.cache_split(S, _rank(tp, r), H)
                assert split.axis == want, (S, H)
                if want == "slots":
                    assert (split.start, split.size) == (r * S // tp,
                                                         S // tp)
                x = torch.arange(2 * S * H * 4.0).reshape(2, S, H, 4)
                if want == "slots":
                    with pytest.raises(ValueError, match="shard_caches"):
                        sharding.shard_cache(x, _rank(tp, r))
                    continue
                cut = sharding.shard_cache(x, _rank(tp, r))
                if want == "heads":
                    assert torch.equal(cut, x[:, :, r * H // tp:
                                              (r + 1) * H // tp])
                else:
                    assert cut is x
        want = _ref_axis((2, S, 32), tp)
        assert sharding.cache_split(S, _rank(tp, 0)).axis == want
    assert sharding.cache_split(8, ShardCtx(), 1).axis == "whole"


def _whole_and_ranks(tp: int, S: int, B: int = 3, H: int = 2, D: int = 4):
    whole = {"k": torch.zeros(B, S, H, D), "v": torch.zeros(B, S, H, D),
             "pos": torch.full((B, S), -1, dtype=torch.int32)}
    size = S // tp
    ranks = [{"k": torch.zeros(B, size, H, D),
              "v": torch.zeros(B, size, H, D),
              "pos": torch.full((B, size), -1, dtype=torch.int32),
              "ring": _ring(B, S, "cpu")} for _ in range(tp)]
    return whole, ranks


@pytest.mark.parametrize("tp,S", [(2, 8), (4, 8), (4, 12)])
@pytest.mark.parametrize("prompt", ["below", "equal", "wraps",
                                    "wraps_evenly"])
def test_cache_write_of_a_rank_is_the_whole_write_sliced(tp, S, prompt):
    """A prompt shorter than the ring, as long, longer without wrapping
    evenly and a whole number of rings, then decode steps of rows at
    different positions, past the wrap: every rank's K, V and positions
    are its slots of the whole ring's, bit for bit."""
    P = {"below": S - 3, "equal": S, "wraps": S + 3,
         "wraps_evenly": 2 * S}[prompt]
    B, H, D = 3, 2, 4
    gen = torch.Generator().manual_seed(S + P)
    whole, ranks = _whole_and_ranks(tp, S, B, H, D)
    ctxs = [_rank(tp, r) for r in range(tp)]
    positions = torch.arange(P, dtype=torch.int32)[None].expand(B, P)
    steps = [positions]
    for i in range(S + 2):
        steps.append((P + i + torch.arange(B, dtype=torch.int32)
                      * 3)[:, None])
    for pos in steps:
        k, v = (torch.randn((B, pos.shape[1], H, D), generator=gen)
                for _ in range(2))
        whole = _cache_write(whole, ("k", "v"), (k, v), pos, ShardCtx())
        ranks = [_cache_write(c, ("k", "v"), (k, v), pos, ctx)
                 for c, ctx in zip(ranks, ctxs)]
        size = S // tp
        for r, c in enumerate(ranks):
            for n in ("k", "v", "pos"):
                assert torch.equal(c[n], whole[n][:, r * size:
                                                  (r + 1) * size]), (r, n)
            assert c["ring"].shape == (B, S, 0)


@pytest.mark.parametrize("arch", ["gemma-2b", "deepseek-v2-236b",
                                  "gemma3-12b"])
@pytest.mark.parametrize("tp", [2, 4])
def test_split_caches_hold_a_tp_th_of_the_bytes(arch, tp):
    """`init_caches` under each rank of a model dim of 2 and 4: every
    cache the reference splits along S (gemma-2b's single kv head,
    gemma3's with one kv head, deepseek-v2's latent cache) holds S / tp
    slots of each leaf, positions included, its bytes the whole's / tp,
    the ranks' ranges tiling the ring; `shard_caches` of the whole tree
    gives each rank the same shapes and its slots' values."""
    over = {"n_kv_heads": 1} if arch == "gemma3-12b" else {}
    cfg = ARCHS[arch].reduced(dtype="float32", **over)
    whole = init_caches(cfg, 2, 48, "float32", "cpu")
    filled = tree_unflatten(whole, [
        torch.arange(x.numel()).reshape(x.shape).to(x.dtype)
        for _, x in tree_items(whole)])
    for r in range(tp):
        held = dict(tree_items(init_caches(cfg, 2, 48, "float32", "cpu",
                                           _rank(tp, r))))
        cut = dict(tree_items(shard_caches(filled, _rank(tp, r))))
        assert held.keys() == cut.keys()
        for path, x in tree_items(filled):
            pos = held[path[:-1] + ("pos",)]
            S = pos.shape[-1] * tp
            assert held[path[:-1] + ("ring",)].shape == \
                pos.shape[:-1] + (S, 0)
            axis = x.ndim - (1 if path[-1] == "pos" else
                             3 if path[-1] in ("k", "v") else 2)
            assert x.shape[axis] == S
            assert held[path].shape == cut[path].shape
            assert held[path].numel() * held[path].element_size() * tp \
                == x.numel() * x.element_size()
            assert torch.equal(cut[path], x.narrow(axis, r * S // tp,
                                                   S // tp))


def _partials(q, k, v, pos, n):
    """The log-sum-exp entry's plain version over n even slot ranges of
    the ring, each with its local lengths: stacked (outs, lses)."""
    S = k.shape[1]
    size = S // n
    parts = [ops.decode_attention_bshd_lse(
        q, k[:, r * size:(r + 1) * size], v[:, r * size:(r + 1) * size],
        decode_lengths(pos, size, r * size, S)) for r in range(n)]
    return (torch.stack([o for o, _ in parts]),
            torch.stack([lse[:, None] for _, lse in parts]))


def test_merge_partials_of_slot_ranges_is_the_whole_softmax():
    """One partial merges to itself bit for bit; 2 and 4 slot ranges of a
    GQA ring merge to the whole within MERGE_TOL, rows whose valid slots
    lie on the first range only (the others weigh 0) included; an empty
    partial (output anything finite, log-sum-exp -inf) changes no bit of
    a merge; a row with no key anywhere merges to 0."""
    gen = torch.Generator().manual_seed(0)
    B, S, Hq, Hkv, D = 4, 64, 8, 2, 64
    q = torch.randn((B, 1, Hq, D), generator=gen)
    k, v = (torch.randn((B, S, Hkv, D), generator=gen) for _ in range(2))
    pos = torch.tensor([[63], [200], [10], [40]], dtype=torch.int32)
    whole, whole_lse = _partials(q, k, v, pos, 1)
    assert torch.equal(merge_partials(whole, whole_lse), whole[0])
    want = ref.decode_attention_bshd_ref(q, k, v, decode_lengths(pos, S))
    assert float((whole[0] - want).abs().max()) <= MERGE_TOL
    for n in (2, 4):
        outs, lses = _partials(q, k, v, pos, n)
        assert bool((lses[1:, 2] == -torch.inf).all())       # row of 11
        err = float((merge_partials(outs, lses) - whole[0]).abs().max())
        assert err <= MERGE_TOL * float(v.abs().max()), (n, err)
    empty_out = torch.randn(whole.shape, generator=gen)
    empty_lse = torch.full(whole_lse.shape, -torch.inf)
    assert torch.equal(merge_partials(torch.cat([whole, empty_out]),
                                      torch.cat([whole_lse, empty_lse])),
                       whole[0])
    assert torch.equal(merge_partials(empty_out, empty_lse),
                       torch.zeros_like(whole[0]))


@pytest.mark.parametrize("G", [1, 4])
def test_lse_entry_plain_version_is_the_decode_softmax(G):
    """Rows of 0, 1, some and all of a ring's slots: the output is the
    plain decode entry's (within MERGE_TOL) where a row has a key, 0
    where it has none; the log-sum-exp is a float64 one's (within 1e-6),
    -inf for the empty row."""
    gen = torch.Generator().manual_seed(G)
    B, S, Hkv, D = 4, 40, 2, 64
    q = torch.randn((B, 1, Hkv * G, D), generator=gen)
    k, v = (torch.randn((B, S, Hkv, D), generator=gen) for _ in range(2))
    lens = torch.tensor([0, 1, 17, 40], dtype=torch.int32)
    out, lse = ops.decode_attention_bshd_lse(q, k, v, lens)
    want = ref.decode_attention_bshd_ref(q, k, v, lens)
    assert float((out[1:] - want[1:]).abs().max()) <= MERGE_TOL
    assert not out[0].any() and bool((lse[0] == -torch.inf).all())
    s = torch.einsum("bhd,bkhd->bhk", q[:, 0].double(),
                     k.double().repeat_interleave(G, dim=2)) / D ** 0.5
    for b in range(1, B):
        want_lse = torch.logsumexp(s[b, :, :int(lens[b])], -1)
        assert float((lse[b].double() - want_lse).abs().max()) <= 1e-6


# arch: (bytes of one sequence's caches at 32,768 slots in bfloat16, the
# positions included, whole; the same a rank at a model dim of 8), from
# the configs' shapes (meta tensors): deepseek-v2's latent cache, 60
# layers x (512 + 64) x 2 bytes + 4 a slot; granite-20b's one kv head, 52
# layers x 2 x 128 x 2 bytes + 4 a slot
LONG_CONTEXT = {"deepseek-v2-236b": (2_272_788_480, 284_098_560),
                "granite-20b": (879_230_976, 109_903_872)}


@pytest.mark.parametrize("arch", sorted(LONG_CONTEXT))
def test_a_long_sequence_cache_over_8_ranks(arch):
    """One sequence of 32,768 slots at full width: the bytes of its caches
    whole and a rank's at a model dim of 8 (LONG_CONTEXT, PERF.md's
    per-rank cache bytes), an eighth, every layer's cache split along
    S."""
    from repro_torch.configs import get_config
    from repro_torch.models.blocks import init_block_cache
    cfg = get_config(arch)
    whole, held = LONG_CONTEXT[arch]
    for ctx, want in ((ShardCtx(), whole), (_rank(8, 3), held)):
        one = init_block_cache(cfg, "a", 1, 32768, torch.bfloat16, "meta",
                               ctx)
        assert ("ring" in one) == (ctx.mesh is not None)
        assert cfg.n_layers * sum(x.numel() * x.element_size()
                                  for x in one.values()) == want
