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
cast back to its target's dtype on restore, as every leaf is.  The
reference's `shardings` re-shard a restore onto a mesh; the port runs on
one rank (ROADMAP queue 1 item 4), so it takes none.
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


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.cpu().numpy()
    return np.asarray(t)


def save_checkpoint(directory: str, step: int, tree,
                    extras: Optional[Dict] = None) -> str:
    """Gather every leaf to the host and commit atomically."""
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
    extra keys are ignored (forward-compatible).  Raises `ValueError`
    when a leaf's shape differs from its target's."""
    if shardings is not None:
        raise NotImplementedError(
            "restore_checkpoint(shardings=...): the port runs on one rank; "
            "sharding is ROADMAP queue 1 item 4")
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "arrays.npz"))

    def restore(pth, tgt):
        key = _key(pth)
        if key not in data.files:
            return tgt
        arr = data[key]
        if list(arr.shape) != list(tgt.shape):
            raise ValueError(
                f"checkpoint leaf {key} shape {arr.shape} != target "
                f"{tuple(tgt.shape)} — reshard topology mismatch")
        return _from_numpy(arr).to(device=tgt.device, dtype=tgt.dtype)

    return _map_items(target_tree, restore), step, manifest["extras"]


def prune_checkpoints(directory: str, keep: int = 3) -> None:
    if not os.path.isdir(directory):
        return
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                   if d.startswith("step_"))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)
