"""The LM's parameter layout: embeddings, prefix layers, and the pattern
periods whose parameters are stacked along a leading `n_periods` axis.

The tree keeps the reference's nested dicts and lists and its stacked
`period` leaves, so a leaf's key path, shape and dtype are the
reference's, and its leaves come in `jax.tree.leaves` order
(`tree_leaves`: dict keys sorted, lists in order).  That order and that
stacking decide how the plane-sharded gradient sync chunks the model
(`core.collectives.stream_report` cuts each leaf along axis 0), so the
training-step schedule (`repro_torch.comms`) reads its gradient bytes
from `param_shapes`, which holds no memory.  `params_from_jax` carries
the reference's weights across, bit for bit.

The forward (attention, MoE dispatch, the SSD scan, caches, the losses)
arrives with ROADMAP queue 1 item 8; a later slice may wrap the tree in
an `nn.Module` whose `state_dict` keys are these key paths.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .blocks import init_block
from .config import ModelConfig
from .layers import axes_builder, init_embed, meta_builder, tensor_builder

KeyPath = Tuple                # dict keys (str) and list indices (int)


def _stacked_builder(make, n: int):
    def smake(name, shape, axes, scale):
        return make(name, (n,) + tuple(shape), ("layers",) + tuple(axes),
                    scale)
    return smake


def _init_tree(make, cfg: ModelConfig) -> Dict:
    p: Dict = {"embed": init_embed(make, cfg.vocab, cfg.d_model,
                                   cfg.tie_embeddings),
               "final_ln": make("final_ln", (cfg.d_model,), ("embed",), 0.0)}
    p["prefix"] = [
        init_block(make, cfg, "a", False, f"prefix{i}")
        for i in range(cfg.n_prefix_layers)
    ]
    smake = _stacked_builder(make, cfg.n_periods)
    p["period"] = [
        init_block(smake, cfg, kind, cfg.is_moe_pos(pos), f"pat{pos}")
        for pos, kind in enumerate(cfg.block_pattern)
    ]
    if cfg.frontend != "none":
        p["frontend_proj"] = make("frontend_proj",
                                  (cfg.d_model, cfg.d_model),
                                  ("embed", "embed2"), 1.0)
    return p


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name ('float32', 'bfloat16',
    ...)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def init_params(cfg: ModelConfig,
                generator: Optional[torch.Generator] = None,
                device=None) -> Dict:
    """Random parameters at `cfg.param_dtype` (`layers.tensor_builder`),
    drawn from `generator` (seed 0 on the CPU by default) in the tree's
    build order.  `device` defaults to CUDA (and raises without a GPU).
    The draws are not the reference's: carry its weights across with
    `params_from_jax`."""
    from repro_torch.netsim.engine import resolve_device
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return _init_tree(tensor_builder(generator, torch_dtype(cfg.param_dtype),
                                     device), cfg)


def param_shapes(cfg: ModelConfig) -> Dict:
    """The parameter tree as `device="meta"` tensors at
    `cfg.param_dtype`: every key path, shape and dtype, no memory (the
    counterpart of `jax.eval_shape(init_params)`)."""
    return _init_tree(meta_builder(torch_dtype(cfg.param_dtype)), cfg)


def logical_axes(cfg: ModelConfig) -> Dict:
    return _init_tree(axes_builder(), cfg)


def tree_items(tree, path: KeyPath = ()) -> Iterator[Tuple[KeyPath, object]]:
    """(key path, leaf) pairs in `jax.tree.leaves` order: dict keys
    sorted, lists and tuples in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from tree_items(x, path + (i,))
    else:
        yield path, tree


def tree_leaves(tree) -> List:
    """The leaves in `jax.tree.leaves` order."""
    return [leaf for _, leaf in tree_items(tree)]


def _map_items(tree, fn: Callable, path: KeyPath = ()):
    """`tree` with each leaf replaced by `fn(key path, leaf)`."""
    if isinstance(tree, dict):
        return {k: _map_items(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_items(x, fn, path + (i,))
                          for i, x in enumerate(tree))
    return fn(path, tree)


def param_count(params: Dict) -> int:
    return sum(x.numel() for x in tree_leaves(params))


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    """A copy of `a` as a tensor; numpy has no bfloat16 of its own, so a
    bfloat16 array (ml_dtypes') crosses as its 16-bit pattern."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_jax(tree, cfg: ModelConfig, device=None) -> Dict:
    """The reference's parameter tree (nested dicts and lists of arrays,
    e.g. `jax.device_get(init_params(key, cfg))`) as the port's tree of
    tensors on `device` (CUDA by default), bit for bit.  Every key path,
    shape and dtype must be the port's layout for `cfg` (`param_shapes`);
    raises `ValueError` on any mismatch."""
    from repro_torch.netsim.engine import resolve_device
    device = resolve_device(device)
    shapes = param_shapes(cfg)
    layout = dict(tree_items(shapes))
    given = dict(tree_items(tree))
    missing = sorted(map(str, layout.keys() - given.keys()))
    extra = sorted(map(str, given.keys() - layout.keys()))
    if missing or extra:
        raise ValueError(f"{cfg.name}: parameter key paths differ: missing "
                         f"{missing}, unexpected {extra}")

    def carry(path, meta):
        a = np.asarray(given[path])
        want = str(meta.dtype).removeprefix("torch.")
        if tuple(a.shape) != tuple(meta.shape) or a.dtype.name != want:
            raise ValueError(
                f"{cfg.name}: leaf {path} is {a.dtype.name}{list(a.shape)},"
                f" the layout has {want}{list(meta.shape)}")
        return _from_numpy(a).to(device)

    return _map_items(shapes, carry)
