"""The port's AdamW (`repro_torch.optim`) and checkpoints
(`repro_torch.checkpoint`) against the JAX package's on the CPU.

AdamW: the same float32 gradients, moments and parameters go through
both updates; parameters, moments and the global norm agree within 1e-6
relative (each leaf's sum of squares is reduced in another order by the
two frameworks; the rest is elementwise in the reference's float32
order).  Checkpoints are the reference's on-disk format: either
package's checkpoint restores in the other bit for bit.
"""
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import (latest_step, prune_checkpoints,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.models import tree_items, tree_leaves
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_schedule, global_norm)
from repro_torch.parallel import local_ctx, param_shardings

RTOL = 1e-6
SHAPES = {"w": (16, 8), "b": (8,), "layers": [{"g": (3, 4, 5)},
                                               {"g": (3, 4, 5)}]}


def _tree(shapes, rng, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(v, rng, scale) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_tree(v, rng, scale) for v in shapes]
    return (rng.standard_normal(shapes) * scale).astype(np.float32)


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(got, want, rtol=RTOL):
    got_leaves = tree_leaves(got)
    want_leaves = jax.tree.leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=rtol,
                                   atol=rtol * float(np.abs(w).max() + 1e-30))


@pytest.mark.parametrize("clip,gscale", [(1.0, 1.0), (1.0, 1e-3),
                                         (0.0, 1.0), (50.0, 3.0)])
def test_adamw_update_matches_reference(clip, gscale):
    """Five updates from a warm state: parameters, moments, count and
    the grad norm; with the clip on and off."""
    rng = np.random.default_rng(7)
    cfg = AdamWConfig(lr=1e-2, clip_norm=clip)
    jcfg = jadamw.AdamWConfig(lr=1e-2, clip_norm=clip)
    p = _tree(SHAPES, rng)
    tp, jp = _torch(p), _jax(p)
    ts, js = adamw_init(tp), jadamw.adamw_init(jp)
    assert ts["count"].dtype == torch.int32 and ts["count"].shape == ()
    for step in range(5):
        g = _tree(SHAPES, rng, gscale)
        lr_scale = cosine_schedule(step, 2, 10)
        jlr = jadamw.cosine_schedule(jnp.asarray(step, jnp.int32), 2, 10)
        np.testing.assert_allclose(float(lr_scale), float(jlr), rtol=RTOL)
        tp, ts, tm = adamw_update(_torch(g), ts, tp, cfg, lr_scale)
        jp, js, jm = jadamw.adamw_update(_jax(g), js, jp, jcfg, jlr)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=RTOL)
        _close(tp, jp)
        _close(ts["m"], js["m"])
        _close(ts["v"], js["v"])
        assert int(ts["count"]) == int(js["count"]) == step + 1


def test_global_norm_and_schedule_match_reference():
    rng = np.random.default_rng(1)
    t = _tree(SHAPES, rng, 5.0)
    np.testing.assert_allclose(float(global_norm(_torch(t))),
                               float(jadamw.global_norm(_jax(t))),
                               rtol=RTOL)
    for warmup, total in ((0, 10), (3, 20), (100, 1000), (5, 5)):
        for step in (0, 1, 2, 3, 7, 19, 50, 400, 999, 2000):
            np.testing.assert_allclose(
                float(cosine_schedule(torch.tensor(step, dtype=torch.int32),
                                      warmup, total)),
                float(jadamw.cosine_schedule(jnp.asarray(step, jnp.int32),
                                             warmup, total)),
                rtol=RTOL, atol=1e-7)


def test_adamw_update_leaves_its_inputs():
    rng = np.random.default_rng(2)
    p = _torch(_tree(SHAPES, rng))
    before = [x.clone() for x in tree_leaves(p)]
    st = adamw_init(p)
    adamw_update(_torch(_tree(SHAPES, rng)), st, p, AdamWConfig())
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(p)))
    assert int(st["count"]) == 0


def _state(seed):
    """A parameter and optimizer tree as the trainer saves it."""
    rng = np.random.default_rng(seed)
    p = _tree(SHAPES, rng)
    return {"params": p, "opt": {"m": _tree(SHAPES, rng),
                                 "v": _tree(SHAPES, rng),
                                 "count": np.array(seed + 3, np.int32)}}


def _bits_equal(got, want):
    for (path, g), w in zip(tree_items(got), jax.tree.leaves(want)):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert g.tobytes() == w.tobytes(), path


def test_reference_checkpoint_restores_bit_equal_in_the_port():
    with tempfile.TemporaryDirectory() as d:
        saved = _state(1)
        jckpt.save_checkpoint(d, 12, _jax(saved), extras={"model": "x"})
        target = _torch(_state(0))
        got, step, extras = restore_checkpoint(d, target)
        assert step == 12 and extras == {"model": "x"}
        assert got["opt"]["count"].dtype == torch.int32
        assert got["opt"]["count"].shape == ()
        _bits_equal(got, saved)


def test_port_checkpoint_restores_bit_equal_in_the_reference():
    with tempfile.TemporaryDirectory() as d:
        saved = _state(2)
        save_checkpoint(d, 7, _torch(saved), extras={"model": "y"})
        with open(os.path.join(d, "LATEST")) as f:
            assert f.read() == "step_00000007"
        got, step, extras = jckpt.restore_checkpoint(d, _jax(_state(0)))
        assert step == 7 and extras == {"model": "y"}
        _bits_equal(_torch(jax.tree.map(np.asarray, got)), saved)
        # the manifests of both packages name the same keys and dtypes
        man = jckpt.json.load(open(os.path.join(d, "step_00000007",
                                                "manifest.json")))
        e = tempfile.mkdtemp(dir=d)
        jckpt.save_checkpoint(e, 7, _jax(saved), extras={"model": "y"})
        assert man == jckpt.json.load(open(os.path.join(
            e, "step_00000007", "manifest.json")))


def test_checkpoint_roundtrip_latest_and_older_step():
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 10, _torch(_state(1)), extras={"note": "x"})
        save_checkpoint(d, 20, _torch(_state(2)))
        assert latest_step(d) == 20 == jckpt.latest_step(d)
        got, step, _ = restore_checkpoint(d, _torch(_state(0)))
        assert step == 20
        _bits_equal(got, _state(2))
        got, step, extras = restore_checkpoint(d, _torch(_state(0)), step=10)
        assert step == 10 and extras == {"note": "x"}
        _bits_equal(got, _state(1))
    with tempfile.TemporaryDirectory() as d:
        assert latest_step(d) is None
        with pytest.raises(FileNotFoundError):
            restore_checkpoint(d, _torch(_state(0)))


def test_checkpoint_shape_mismatch_raises():
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 1, {"a": torch.zeros(4)})
        with pytest.raises(ValueError, match="shape"):
            restore_checkpoint(d, {"a": torch.zeros(5)})


def test_checkpoint_prune_keeps_latest():
    with tempfile.TemporaryDirectory() as d:
        for s in (1, 2, 3, 4, 5):
            save_checkpoint(d, s, {"a": torch.zeros(2)})
        prune_checkpoints(d, keep=2)
        steps = sorted(int(x.split("_")[1]) for x in os.listdir(d)
                       if x.startswith("step_"))
        assert steps == [4, 5]
        assert latest_step(d) == 5
        prune_checkpoints(os.path.join(d, "absent"))


def test_checkpoint_forward_compatible_extra_field():
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 1, {"a": torch.ones(3)})
        tgt = {"a": torch.zeros(3), "new_field": torch.full((2,), 7.0)}
        got, _, _ = restore_checkpoint(d, tgt)
        assert torch.equal(got["a"], torch.ones(3))
        assert torch.equal(got["new_field"], torch.full((2,), 7.0))


def test_checkpoint_keeps_target_dtypes():
    """A bfloat16 leaf is stored widened to float32 and comes back
    bit for bit into a bfloat16 target; a restore with the shardings of
    one rank (every spec empty) returns the leaves whole."""
    with tempfile.TemporaryDirectory() as d:
        x = torch.randn(4, 3, generator=torch.Generator().manual_seed(0))
        tree = {"bf": x.to(torch.bfloat16), "f": x}
        save_checkpoint(d, 1, tree)
        got, _, _ = restore_checkpoint(
            d, {"bf": torch.zeros(4, 3, dtype=torch.bfloat16),
                "f": torch.zeros(4, 3)})
        assert got["bf"].dtype == torch.bfloat16
        assert torch.equal(got["bf"], tree["bf"])
        assert torch.equal(got["f"], x)
        specs = param_shardings({"bf": ("embed", "mlp"),
                                 "f": ("vocab", "embed_t")}, local_ctx(),
                                tree)
        whole, _, _ = restore_checkpoint(
            d, {"bf": torch.zeros(4, 3, dtype=torch.bfloat16),
                "f": torch.zeros(4, 3)}, shardings=specs)
        assert whole["bf"].dtype == torch.bfloat16
        assert torch.equal(whole["bf"], tree["bf"])
        assert torch.equal(whole["f"], x)
