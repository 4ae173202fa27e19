"""The port's sharding rules (`repro_torch.parallel.sharding`) against the
JAX package's, in one process, and what stays out of tensor parallelism.

For every arch at full width, each leaf's logical axes and shape go
through the reference's `spec_for_axes` and the port's (and the port's
`param_shardings`, leaf by leaf), on meshes (data, model) (1, 2),
(1, 4), (1, 8), (1, 16), (2, 4) and (pod, data, model) (2, 2, 4), with
the default rules and with `make_rules("data")`: the specs are equal by
value.  Both `spec_for_axes` read only the mesh's dim sizes, so a
stand-in with a `shape` (a dict for the reference, a tuple beside
`mesh_dim_names` for the port) serves; the reference's
`param_shardings` wraps the same specs in `NamedSharding`s, which need
a real mesh, so the specs are compared.  The split of a tree and its
gather back, bit for bit, run over ranks in `tests/test_torch_tp.py`.

MLA, SSM and hybrid SSM configs under a model dim above 1 take their
specs, and each mixer's own specs (`sharding.leaf_specs`, what its
forward reads its columns by) are the stacked leaves' without the
layers dim; an SSM cache holds a rank's heads, MLA's latent cache its
slots of the ring.  An FSDP context builds
with the reference's plane axes, and `launch.specs.make_ctx` picks FSDP
for exactly the configs the reference's does.  The forwards run over
ranks in `tests/test_torch_tp_fsdp.py`.
"""
import dataclasses
import types

import pytest
import torch

from repro.models import logical_axes as jx_logical_axes
from repro.models.config import ModelConfig as JxModelConfig
from repro.parallel import sharding as jx_sharding
from repro_torch.configs import ARCHS
from repro_torch.models import (logical_axes, param_shapes, param_specs,
                                tree_items)
from repro_torch.parallel import ShardCtx, param_shardings, sharding
from repro_torch.parallel.sharding import spec_leaves

MESHES = (((1, 2), ("data", "model")), ((1, 4), ("data", "model")),
          ((1, 8), ("data", "model")), ((1, 16), ("data", "model")),
          ((2, 4), ("data", "model")),
          ((2, 2, 4), ("pod", "data", "model")))


def _axes_items(tree, path=()):
    """(path, axes) pairs of a logical-axes tree (a tuple of names is a
    leaf), dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _axes_items(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, x in enumerate(tree):
            yield from _axes_items(x, path + (i,))
    else:
        yield path, tree


def _ctxs(shape, names, rules):
    port = ShardCtx(mesh=types.SimpleNamespace(shape=shape,
                                               mesh_dim_names=names),
                    rules=rules)
    ref = jx_sharding.ShardCtx(mesh=types.SimpleNamespace(
        shape=dict(zip(names, shape))), rules=rules)
    return port, ref


def _ref_spec(axes, ctx, shape):
    """The reference's spec as a tuple of one entry a dim."""
    spec = tuple(jx_sharding.spec_for_axes(tuple(axes), ctx, shape))
    return spec + (None,) * (len(axes) - len(spec))


@pytest.mark.parametrize("fsdp", [None, "data"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_specs_match_the_reference(arch, fsdp):
    cfg = ARCHS[arch]
    jaxes = dict(_axes_items(jx_logical_axes(
        JxModelConfig(**dataclasses.asdict(cfg)))))
    axes = dict(_axes_items(logical_axes(cfg)))
    shapes = dict(tree_items(param_shapes(cfg)))
    assert axes.keys() == jaxes.keys() == shapes.keys()
    sharded = 0
    for shape, names in MESHES:
        port, ref = _ctxs(shape, names, sharding.make_rules(fsdp))
        by_leaf = spec_leaves(param_shardings(logical_axes(cfg), port,
                                              param_shapes(cfg)))
        for (path, ax), spec in zip(sorted(axes.items()), by_leaf):
            shp = tuple(shapes[path].shape)
            want = _ref_spec(jaxes[path], ref, shp)
            assert tuple(sharding.spec_for_axes(tuple(ax), port, shp)) == \
                want, (path, want)
            assert tuple(spec) == want, (path, spec, want)
            assert tuple(sharding.spec_for_axes(tuple(ax), port)) == \
                _ref_spec(jaxes[path], ref, None), path
            sharded += any(spec)
    assert sharded > 0


def test_spec_leaves_follow_the_tree_order():
    cfg = ARCHS["llama3-8b"].reduced()
    port, _ = _ctxs((1, 2), ("data", "model"), sharding.make_rules())
    specs = spec_leaves(param_shardings(logical_axes(cfg), port,
                                        param_shapes(cfg)))
    shapes = [s for _, s in tree_items(param_shapes(cfg))]
    assert len(specs) == len(shapes)
    for spec, s in zip(specs, shapes):
        assert len(spec) == len(s.shape)
        for n, name in zip(s.shape, spec):
            assert name is None or n % 2 == 0


def test_full_shape_of_a_slice():
    mesh = types.SimpleNamespace(shape=(2, 4), mesh_dim_names=("data",
                                                               "model"))
    spec = sharding.Spec((None, "model", "data"), mesh)
    assert sharding.full_shape((3, 2, 3), spec) == (3, 8, 6)
    assert sharding.full_shape((3, 8), sharding.Spec((None, None))) == (3, 8)


# name: (arch, the family kind)
OUT_OF_SCOPE = {"deepseek-v2-236b": "MLA", "mamba2-780m": "SSM",
                "jamba-v0.1-52b": "SSM"}


@pytest.mark.parametrize("arch", sorted(OUT_OF_SCOPE))
def test_mla_and_ssm_under_tp_raise_naming_4c_ii(arch):
    """(Named for the raise these cases held before MLA and SSM blocks
    came under the model dim.)  At (data 1, model 2) the MLA and SSM
    configs take their specs; each mixer's `leaf_specs` are the stacked
    leaves' specs without the layers dim; rank 1's caches hold its SSM
    heads (the state of half the heads, the conv inputs of their x
    channels and of every B/C channel) and its half of the latent
    cache's slots (slots 4-7 of 8: `ckv`, `kr` and `pos`, with a "ring"
    leaf recording the 8), and `shard_caches` cuts a whole cache tree to
    those."""
    from repro_torch.models import (init_caches, shard_caches, tree_leaves,
                                    tree_map)
    from repro_torch.models.attention import init_mla
    from repro_torch.models.ssm import init_mamba
    cfg = ARCHS[arch].reduced(dtype="float32")
    port, _ = _ctxs((1, 2), ("data", "model"), sharding.make_rules())
    specs = param_specs(cfg, port)
    init = init_mla if OUT_OF_SCOPE[arch] == "MLA" else init_mamba
    for pos, kind in enumerate(cfg.block_pattern):
        if OUT_OF_SCOPE[arch] == "SSM" and kind != "m":
            continue
        stacked = specs["period"][pos]["mixer"]
        own = sharding.leaf_specs(init, cfg, port)
        assert own.keys() == stacked.keys()
        for k in own:
            assert stacked[k][0] is None
            assert tuple(stacked[k])[1:] == tuple(own[k]), k
    assert any(any(s) for s in spec_leaves(specs))
    rank1 = ShardCtx(mesh=types.SimpleNamespace(
        shape=(1, 2), mesh_dim_names=("data", "model"),
        get_local_rank=lambda name: 1))
    caches = init_caches(cfg, 2, 8, "float32", "cpu", rank1)
    whole = init_caches(cfg, 2, 8, "float32", "cpu")
    for k in whole:
        whole[k] = [tree_map(c, lambda a: a + torch.arange(
            a.shape[-1], dtype=a.dtype)) for c in whole[k]]
    cut = shard_caches(whole, rank1)
    pos = cfg.block_pattern.index("m" if OUT_OF_SCOPE[arch] == "SSM"
                                  else "a")
    assert [a.shape for a in tree_leaves(cut)] == \
        [a.shape for a in tree_leaves(caches)]
    c = caches["period"][pos]
    if OUT_OF_SCOPE[arch] == "MLA":
        assert c["ckv"].shape == (cfg.n_periods, 2, 4, cfg.kv_lora)
        assert c["kr"].shape == (cfg.n_periods, 2, 4, cfg.rope_head_dim)
        assert c["pos"].shape == (cfg.n_periods, 2, 4)
        assert c["ring"].shape == (cfg.n_periods, 2, 8, 0)
        for k in ("ckv", "kr", "pos"):
            want = whole["period"][pos][k]
            assert torch.equal(cut["period"][pos][k],
                               want.narrow(2, 4, 4))
    else:
        half = cfg.ssm_heads // 2
        assert c["ssm"].shape == (cfg.n_periods, 2, half, cfg.ssm_head_dim,
                                  cfg.ssm_state)
        assert c["conv"].shape[-1] == (half * cfg.ssm_head_dim +
                                       2 * cfg.ssm_groups * cfg.ssm_state)
        # rank 1's conv inputs: its heads' x channels, then every B/C one
        din = cfg.ssm_heads * cfg.ssm_head_dim
        want = list(range(half * cfg.ssm_head_dim, din)) + list(
            range(din, din + 2 * cfg.ssm_groups * cfg.ssm_state))
        assert cut["period"][pos]["conv"][0, 0, 0].tolist() == want


def test_fsdp_raises_naming_4c_ii():
    """(Named for the raise it held before FSDP came under the mesh.)  An
    FSDP context over (data 2, model 2) builds, with the reference's
    plane axes and an FSDP dim of 2, and takes `make_rules("data")`'s
    specs, which split the d_model dims of llama3-8b's weights over
    "data" (`sharding.names_dim`); an FSDP axis outside the DP axes is
    refused."""
    mesh = types.SimpleNamespace(shape=(2, 2), mesh_dim_names=("data",
                                                               "model"))
    ctx = ShardCtx(mesh=mesh, fsdp_axis="data",
                   rules=sharding.make_rules("data"))
    ref = jx_sharding.ShardCtx(mesh=types.SimpleNamespace(
        shape={"data": 2, "model": 2}), fsdp_axis="data",
        rules=sharding.make_rules("data"))
    assert ctx.plane_axes == ref.plane_axes == ()
    assert ctx.fsdp_size == 2 and ctx.tp_size == 2
    cfg = ARCHS["llama3-8b"].reduced(dtype="float32")
    specs = spec_leaves(param_specs(cfg, ctx))
    split = [sharding.names_dim(s, "data") for s in specs]
    assert sum(split) == len(specs) - 1            # all but the table
    assert not sharding.names_dim(param_specs(cfg, ctx)["embed"]["tok"],
                                  "data")
    with pytest.raises(ValueError, match="not one of the DP axes"):
        ShardCtx(mesh=mesh, fsdp_axis="model")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_make_ctx_picks_fsdp_where_the_reference_does(arch):
    """`launch.specs.make_ctx` on a (data, model) and a (pod, data,
    model) mesh: the DP axes, the FSDP axis (above FSDP_PARAM_THRESHOLD
    parameters) and the rules are the reference's, and so is the
    analytic parameter count."""
    from repro.launch import specs as jx_specs
    from repro_torch.launch import specs
    cfg = ARCHS[arch]
    jcfg = JxModelConfig(**dataclasses.asdict(cfg))
    assert specs.analytic_param_count(cfg) == \
        jx_specs.analytic_param_count(jcfg)
    assert specs.FSDP_PARAM_THRESHOLD == jx_specs.FSDP_PARAM_THRESHOLD
    for shape, names in (((2, 2), ("data", "model")),
                         ((2, 2, 2), ("pod", "data", "model"))):
        port = specs.make_ctx(types.SimpleNamespace(
            shape=shape, mesh_dim_names=names), cfg)
        ref = jx_specs.make_ctx(types.SimpleNamespace(
            shape=dict(zip(names, shape)), axis_names=names), jcfg)
        assert (port.dp_axes, port.tp_axis, port.fsdp_axis, port.rules) == \
            (ref.dp_axes, ref.tp_axis, ref.fsdp_axis, ref.rules)
        assert port.plane_axes == ref.plane_axes
    assert specs.make_ctx(None, cfg).mesh is None
