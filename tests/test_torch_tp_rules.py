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

MLA, SSM and hybrid SSM configs under a model dim above 1 raise
`NotImplementedError` naming ROADMAP queue 1 item 4c-ii at
`param_specs` and at the first forward, and so does an FSDP axis when
its context is built.
"""
import dataclasses
import types

import pytest
import torch

from repro.models import logical_axes as jx_logical_axes
from repro.models.config import ModelConfig as JxModelConfig
from repro.parallel import sharding as jx_sharding
from repro_torch.configs import ARCHS
from repro_torch.models import (logical_axes, loss_fn, param_shapes,
                                param_specs, tree_items)
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
    cfg = ARCHS[arch].reduced(dtype="float32")
    port, _ = _ctxs((1, 2), ("data", "model"), sharding.make_rules())
    with pytest.raises(NotImplementedError,
                       match=f"{OUT_OF_SCOPE[arch]} .*queue 1 item 4c-ii"):
        param_specs(cfg, port)
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="queue 1 item 4c-ii"):
        loss_fn({}, cfg, {"tokens": toks, "labels": toks}, port)


def test_fsdp_raises_naming_4c_ii():
    mesh = types.SimpleNamespace(shape=(2, 2), mesh_dim_names=("data",
                                                               "model"))
    with pytest.raises(NotImplementedError, match="queue 1 item 4c-ii"):
        ShardCtx(mesh=mesh, fsdp_axis="data")
    # FSDP's rules without the axis are refused at the first forward
    cfg = ARCHS["llama3-8b"].reduced(dtype="float32")
    ctx = ShardCtx(mesh=mesh, rules=sharding.make_rules("data"))
    with pytest.raises(NotImplementedError, match="queue 1 item 4c-ii"):
        param_specs(cfg, ctx)
