"""The port's `plane_allreduce` (`repro_torch.core.collectives`) over
gloo ranks on the CPU against the JAX package's over a mesh of the same
data-parallel size.

Each rank holds its own gradient tree: the reduced llama3-8b's parameter
shapes and three leaves that reach the branches the config does not (a
scalar and a leaf of at most `microchunks` elements, synced whole; chunks
with no dim the ranks divide, which fall back to one sum), drawn from a
numpy seed per rank.  The port runs 2, 4 and 8 ranks (`torch_dist_workers`,
spawned processes over gloo and a `file://` store; (data 2), (pod 2,
data 2), (pod 2, data 4)); the reference runs `plane_allreduce` inside a
`shard_map` over 8 forced host devices in a subprocess, on the same
per-rank trees and the same mesh shapes.  Every rank's result is
compared.

Tolerances, as measured: "psum" and "rs_ag" within 1e-6 of each leaf's
largest magnitude (the two packages sum the ranks in other orders;
measured up to 2.1e-7; 0 at 2 ranks).  "rs_ag_int8" on the reference's
own noise draws (`jax.random.uniform(fold_in(key, k), ...)`, handed to
the port in place of `chunk_noise`): every compressed element within one
code step (its row's scale over the ranks) of the reference's, every
other element within 1e-6 of its leaf's largest; codes differ only where the two sums
round a value across a code boundary, in at most CODE_SHARE of the
compressed elements (measured 0 at 2, 4 and 8 ranks).  On the port's own
draws every element is still within a code step (rounding picks one of
the two codes around the value whatever the draw), but a third of the
codes differ (measured 0.324-0.329): the share is what tells the draws
apart.  "One code step" allows 1e-4 of the step for the two packages'
scales, which may differ in their last bits.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.core.collectives import _scatter_dim as jx_scatter_dim
from repro_torch.configs import ARCHS
from repro_torch.core.collectives import MODES, _chunk_bounds, _scatter_dim
from repro_torch.models import param_shapes, tree_leaves

import torch_dist_workers as w

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4, 8)
MICROCHUNKS = 8
SEED = 7
SUM_TOL = 1e-6
CODE_SHARE = 2e-3
OWN_SHARE = (0.2, 0.5)

REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.core import PlaneConfig, plane_allreduce

inputs, out_path = sys.argv[1], sys.argv[2]
world, micro, seed = (int(a) for a in sys.argv[3:6])
z = np.load(inputs)
out = {}
if True:
    if world == 2:
        shape, names, dp_axes = (2, 1), ("data", "model"), ("data",)
    else:
        shape, names = (2, world // 2, 1), ("pod", "data", "model")
        dp_axes = ("pod", "data")
    mesh = Mesh(np.array(jax.devices()[:world]).reshape(shape), names)
    n = len([k for k in z.files if k.startswith(f"{world}/0/")])
    stacked = [jnp.stack([z[f"{world}/{r}/{i}"] for r in range(world)])
               for i in range(n)]
    for mode in ("psum", "rs_ag", "rs_ag_int8"):
        def body(tree, key, mode=mode):
            tree = [x[0] for x in tree]
            g = plane_allreduce(tree, dp_axes, PlaneConfig(4, micro),
                                key=key, mode=mode)
            return [x[None] for x in g]
        f = jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=([P(dp_axes)] * n, P()),
            out_specs=[P(dp_axes)] * n, axis_names=set(dp_axes),
            check_vma=False))
        res = f(stacked, jax.random.PRNGKey(seed))
        for i, x in enumerate(res):
            out[f"{world}/{mode}/{i}"] = np.asarray(x)
np.savez(out_path, **out)
print("ok")
"""


def _shapes():
    cfg = ARCHS["llama3-8b"].reduced(dtype="float32")
    shapes = [tuple(t.shape) for t in tree_leaves(param_shapes(cfg))]
    return shapes + [(), (5,), (24, 3, 5)]


def _inputs(world: int):
    """Per-rank leaves: rank r's from seed 1000 x world + r, each leaf at
    its own scale."""
    out = {}
    for r in range(world):
        rng = np.random.default_rng(1000 * world + r)
        for i, s in enumerate(_shapes()):
            scale = 10.0 ** rng.uniform(-4, 0)
            out[f"{world}/{r}/{i}"] = (rng.standard_normal(s) * scale
                                       ).astype(np.float32)
    return out


def _chunks(shape, world):
    """(lo, hi, compressed) of each chunk of a leaf, or None for a leaf
    synced whole."""
    if len(shape) == 0 or int(np.prod(shape)) <= MICROCHUNKS:
        return None
    out = []
    for lo, hi in _chunk_bounds(shape[0], MICROCHUNKS):
        sd = _scatter_dim((hi - lo,) + tuple(shape[1:]), world)
        out.append((lo, hi, 0 <= sd < len(shape) - 1))
    return out


def _ref_draws(world: int):
    """The reference's noise for each compressed chunk (by its running
    index) at this world: `uniform(fold_in(PRNGKey(SEED), k), shard
    shape, -0.5, 0.5)`."""
    key = jax.random.PRNGKey(SEED)
    draws, kidx = {}, 0
    for s in _shapes():
        for lo, hi, compressed in _chunks(s, world) or ():
            kidx += 1
            shard = [hi - lo] + list(s[1:])
            sd = _scatter_dim(tuple(shard), world)
            if not compressed:
                continue
            shard[sd] //= world
            draws[str(kidx)] = np.asarray(jax.random.uniform(
                jax.random.fold_in(key, kidx), tuple(shard),
                minval=-0.5, maxval=0.5))
    return draws


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' results: {world: (port ranks' results, reference
    {mode: [leaves (world, ...)]})}."""
    d = tmp_path_factory.mktemp("allreduce")
    inputs = {}
    for world in WORLDS:
        inputs.update(_inputs(world))
    np.savez(d / "inputs.npz", **inputs)
    for world in WORLDS:
        np.savez(d / f"noise{world}.npz", **_ref_draws(world))
        np.savez(d / f"in{world}.npz", **{
            k[len(f"{world}/"):]: v for k, v in inputs.items()
            if k.startswith(f"{world}/")})
    # the reference, one subprocess a world, beside the port's ranks
    refs = [subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, str(d / "inputs.npz"),
         str(d / f"ref{world}.npz"), str(world), str(MICROCHUNKS),
         str(SEED)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
        for world in WORLDS]
    port = {}
    for world in WORLDS:       # one group at a time: at most 8 processes
        port[world] = w.start_ranks(
            w.allreduce_rank, world, str(d / f"in{world}.npz"),
            str(d / f"noise{world}.npz"), MICROCHUNKS, SEED).results()
    want = {}
    for world, ref in zip(WORLDS, refs):
        _, err = ref.communicate(timeout=300)
        assert ref.returncode == 0, err[-3000:]
        with np.load(d / f"ref{world}.npz") as z:
            want.update({k: z[k] for k in z.files})
    n = len(_shapes())
    return {world: (port[world], {
        mode: [want[f"{world}/{mode}/{i}"] for i in range(n)]
        for mode in MODES}) for world in WORLDS}


@pytest.mark.parametrize("shape", [(), (1,), (7,), (8,), (2, 64), (3, 5),
                                   (4, 6, 5), (6, 4), (16, 3), (5, 8, 3),
                                   (1, 4, 16), (9, 9, 9)],
                         ids=str)
def test_scatter_dim_matches_the_reference(shape):
    for dp in (1, 2, 3, 4, 8):
        assert _scatter_dim(shape, dp) == jx_scatter_dim(shape, dp)


def _leaf_errors(got, want):
    return [float(np.abs(g - v).max(initial=0.0)) /
            max(float(np.abs(v).max(initial=0.0)), 1e-30)
            for g, v in zip(got, want)]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("mode", ["psum", "rs_ag"])
def test_plane_allreduce_matches_the_reference(runs, world, mode):
    port, ref = runs[world]
    for r in range(world):
        got = [x.numpy() for x in port[r][mode]]
        want = [x[r] for x in ref[mode]]
        assert [g.shape for g in got] == [v.shape for v in want]
        assert max(_leaf_errors(got, want)) <= SUM_TOL, (r, mode)
        # the ranks agree bit for bit, and "none" compression is psum
        for a, b in zip(port[r][mode], port[0][mode]):
            assert np.array_equal(a.numpy(), b.numpy())
    for a, b in zip(port[0]["default"], port[0]["psum"]):
        assert np.array_equal(a.numpy(), b.numpy())


def _int8_share(got, want, world):
    """(worst excess over one code step, share of compressed elements
    whose codes differ, worst relative error of the other elements)."""
    worst, differ, total, other = 0.0, 0, 0, 0.0
    for s, g, v in zip(_shapes(), got, want):
        chunks = _chunks(s, world)
        big = max(float(np.abs(v).max(initial=0.0)), 1e-30)
        if chunks is None:
            other = max(other, float(np.abs(g - v).max()) / big)
            continue
        for lo, hi, compressed in chunks:
            gc, vc = g[lo:hi], v[lo:hi]
            err = np.abs(gc - vc)
            if not compressed:
                other = max(other, float(err.max(initial=0.0)) / big)
                continue
            # one code step of the mean: the row's largest |value| / 127
            step = np.abs(vc).max(axis=-1, keepdims=True) / 127.0
            worst = max(worst, float((err - step * (1 + 1e-4)).max()))
            differ += int((err > 0.5 * step).sum())
            total += err.size
    return worst, differ / total, other


@pytest.mark.parametrize("world", WORLDS)
def test_int8_allreduce_matches_the_reference_on_its_draws(runs, world):
    port, ref = runs[world]
    for r in range(world):
        got = [x.numpy() for x in port[r]["rs_ag_int8_ref"]]
        want = [x[r] for x in ref["rs_ag_int8"]]
        worst, share, other = _int8_share(got, want, world)
        assert worst <= 0.0 and other <= SUM_TOL, (r, worst, other)
        assert share <= CODE_SHARE, (r, share)
        for a, b in zip(port[r]["rs_ag_int8_ref"],
                        port[0]["rs_ag_int8_ref"]):
            assert np.array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("world", WORLDS)
def test_int8_allreduce_on_the_ports_draws(runs, world):
    """The port's own noise: within a code step, but other codes."""
    port, ref = runs[world]
    got = [x.numpy() for x in port[0]["rs_ag_int8"]]
    worst, share, other = _int8_share(got, [x[0] for x in ref["rs_ag_int8"]],
                                      world)
    assert worst <= 0.0 and other <= SUM_TOL
    assert OWN_SHARE[0] <= share <= OWN_SHARE[1], share
    for r in range(world):
        for a, b in zip(port[r]["rs_ag_int8"], port[0]["rs_ag_int8"]):
            assert np.array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("shape", [(6, 5), (3, 4, 16), (2, 3, 8, 33)],
                         ids=str)
def test_int8_codec_matches_the_reference_twin(shape):
    """`core.int8_encode` / `int8_decode` on a leaf of any rank (rows on
    the last dim) against the reference's jnp twin on its own draw: the
    codes and scales bit for bit, the decode too."""
    import jax.numpy as jnp
    import torch
    from repro.core import collectives as jx_coll
    from repro_torch.core import int8_decode, int8_encode
    x = np.random.default_rng(len(shape)).standard_normal(shape).astype(
        np.float32)
    key = jax.random.PRNGKey(3)
    noise = np.array(jax.random.uniform(key, shape, minval=-0.5,
                                        maxval=0.5))
    jq, js = jx_coll.int8_encode(jnp.asarray(x), key)
    q, scale = int8_encode(torch.from_numpy(x), torch.from_numpy(noise))
    assert q.shape == shape and scale.shape == shape[:-1] + (1,)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(js))
    np.testing.assert_array_equal(int8_decode(q, scale).numpy(),
                                  np.asarray(jx_coll.int8_decode(jq, js)))


def test_chunk_noise_is_the_same_on_every_call():
    """(seed, chunk) decides the draw: U(-0.5, 0.5) float32 of the shard's
    shape, equal for equal keys, other for another chunk or seed."""
    import torch
    from repro_torch.core.collectives import chunk_noise, fold_seed
    a = chunk_noise(5, 3, (64, 33), "cpu")
    assert a.dtype == torch.float32 and a.shape == (64, 33)
    assert float(a.min()) >= -0.5 and float(a.max()) < 0.5
    assert abs(float(a.mean())) < 0.02
    assert torch.equal(a, chunk_noise(5, 3, (64, 33), "cpu"))
    assert not torch.equal(a, chunk_noise(5, 4, (64, 33), "cpu"))
    assert not torch.equal(a, chunk_noise(6, 3, (64, 33), "cpu"))
    assert fold_seed(17, 0) != fold_seed(17, 1) != fold_seed(18, 1)
    assert 0 <= fold_seed(2**40, 7) < 2**63
