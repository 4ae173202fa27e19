"""Checkpointing with atomic commit; a copy of the reference's
`checkpoint/ckpt.py` in its on-disk format, so either package restores
the other's checkpoints.

Layout:  <dir>/step_<k>/
            manifest.json       keys, shapes, dtypes, step, extras
            arrays.npz          every leaf, gathered to the host
         <dir>/LATEST           committed pointer (written last — atomic)

Leaves are addressed by their key path, dict keys and list indices
joined by "/" (`params/period/0/attn/wq`), as the reference's
`tree_flatten_with_path` names them, so a restore works even if
auxiliary fields were added or removed.  A bfloat16 leaf is saved as
float32 (numpy has no bfloat16 of its own; the widening is exact) and
cast back to its target's dtype on restore, as every leaf is.

Under a mesh (`shardings`, a tree of `sharding.Spec`s over the
target's structure, e.g. `param_shardings`; tensor parallelism, FSDP
or both): a save gathers every split leaf over the group of each dim
that splits it and the mesh's first rank writes the one-rank format
(the others wait for the commit), so a checkpoint taken under a mesh
restores into a one-rank run and back; a restore reads each whole leaf
and returns the rank's slice of it.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.transformer import _from_numpy, _map_items, tree_items
from repro_torch.parallel.sharding import (full_shape, gather_params,
                                           local_slice, spec_leaves)


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.cpu().numpy()
    return np.asarray(t)


def _mesh_of(shardings):
    """The mesh a tree of specs names (None without one)."""
    return next((s.mesh for s in spec_leaves(shardings)
                 if s.mesh is not None), None)


def save_checkpoint(directory: str, step: int, tree,
                    extras: Optional[Dict] = None, shardings=None) -> str:
    """Gather every leaf to the host and commit atomically.  With
    `shardings` naming a mesh every rank takes part: the split leaves
    are gathered, the mesh's first rank writes, and every rank returns
    once the commit is written."""
    mesh = None if shardings is None else _mesh_of(shardings)
    if mesh is not None:
        import torch.distributed as dist
        tree = gather_params(tree, shardings)
        if all(c == 0 for c in mesh.get_coordinate()):
            _write(directory, step, tree, extras)
        dist.barrier()
        return os.path.join(directory, f"step_{step:08d}")
    return _write(directory, step, tree, extras)


def _write(directory: str, step: int, tree, extras: Optional[Dict]) -> str:
    os.makedirs(directory, exist_ok=True)
    arrays = {_key(path): _to_numpy(leaf) for path, leaf in tree_items(tree)}
    manifest = {
        "step": step,
        "keys": sorted(arrays.keys()),
        "shapes": {k: list(a.shape) for k, a in arrays.items()},
        "dtypes": {k: str(a.dtype) for k, a in arrays.items()},
        "extras": extras or {},
    }
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    with open(os.path.join(directory, "LATEST.tmp"), "w") as f:
        f.write(f"step_{step:08d}")
    os.replace(os.path.join(directory, "LATEST.tmp"),
               os.path.join(directory, "LATEST"))
    return final


def latest_step(directory: str) -> Optional[int]:
    ptr = os.path.join(directory, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(directory, name)):
        return None
    return int(name.split("_")[1])


def restore_checkpoint(directory: str, target_tree, shardings=None,
                       step: Optional[int] = None,
                       ) -> Tuple[Any, int, Dict]:
    """Restore into the structure of `target_tree`: each leaf takes its
    target's dtype and device; missing keys keep the target's value,
    extra keys are ignored (forward-compatible).  With `shardings` the
    targets are the rank's slices: each whole leaf is read and the
    rank's slice of it returned.  Raises `ValueError` when a leaf's
    shape differs from its target's (whole) shape."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "arrays.npz"))

    specs = {} if shardings is None else dict(zip(
        (p for p, _ in tree_items(target_tree)), spec_leaves(shardings)))

    def restore(pth, tgt):
        key = _key(pth)
        if key not in data.files:
            return tgt
        arr = data[key]
        spec = specs.get(pth)
        whole = tuple(tgt.shape) if spec is None else \
            full_shape(tgt.shape, spec)
        if list(arr.shape) != list(whole):
            raise ValueError(
                f"checkpoint leaf {key} shape {arr.shape} != target "
                f"{whole} — reshard topology mismatch")
        x = _from_numpy(arr)
        if spec is not None:
            x = local_slice(x, spec)
        return x.to(device=tgt.device, dtype=tgt.dtype)

    return _map_items(target_tree, restore), step, manifest["extras"]


def prune_checkpoints(directory: str, keep: int = 3) -> None:
    if not os.path.isdir(directory):
        return
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                   if d.startswith("step_"))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)
