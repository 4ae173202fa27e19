"""The PyTorch port's attention and int8-codec entry points on the CPU.

On the CPU `repro_torch.kernels.ops.{flash_attention,
flash_attention_bshd, decode_attention, int8_encode, int8_decode}` run
their plain PyTorch versions (`repro_torch.kernels.ref`).  Each is held
here to the JAX package twice, on the same numpy inputs from a seed: to
its jnp oracle (`repro.kernels.ref`) and to its Pallas kernel run in
interpret mode through `repro.kernels.ops`, as `tests/test_kernels.py`
runs it.  Tolerances are the JAX tests' own: 1e-5 in float32 (the
frameworks sum the q.k products and the softmax in other orders) and
2e-2 in bfloat16 (the outputs round to bfloat16 apart).  The codec is
exact: q equal to both, scale bit-equal to the oracle and within 1e-6
of Pallas interpret, whose division by 127 is not correctly rounded in
every row; decode bit-equal to both.

The CUDA kernels run only on a GPU: `tests/test_torch_gpu.py` holds them
against these plain versions there, and `chip_smoke.py` does so at the
llama3-8b and gemma3-12b widths.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jx_ops
from repro.kernels import ref as jx_ref
from repro_torch.kernels import build, ops

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
_TH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _normal(seed, *shapes, dtype="float32", scale=1.0):
    """Standard normal arrays from numpy, rounded to `dtype` once, as
    float32 numpy (exact in either dtype) for both frameworks."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in shapes:
        a = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                             * np.float32(scale))
        out.append(a.to(_TH[dtype]).float().numpy())
    return out


def _th(dtype, *arrays):
    return [torch.from_numpy(a).to(_TH[dtype]) for a in arrays]


def _jx(dtype, *arrays):
    return [jnp.asarray(a).astype(_JX[dtype]) for a in arrays]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("against", ["oracle", "pallas"])
@pytest.mark.parametrize("shape", [(1, 2, 128, 64), (2, 4, 256, 128),
                                   (1, 1, 384, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 64)])
def test_flash_attention_vs_jax(shape, dtype, causal, window, against):
    q, k, v = _normal(sum(shape), shape, shape, shape, dtype=dtype)
    got = ops.flash_attention(*_th(dtype, q, k, v), causal=causal,
                              window=window)
    assert got.dtype == _TH[dtype] and got.shape == shape
    S = shape[2]
    if against == "oracle":
        want = jx_ref.flash_attention_ref(*_jx(dtype, q, k, v),
                                          causal=causal, window=window)
    else:
        want = jx_ops.flash_attention(*_jx(dtype, q, k, v), causal=causal,
                                      window=window, bq=min(128, S),
                                      bk=min(128, S))
    _close(got, want, dtype)


@pytest.mark.parametrize("against", ["oracle", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_sq_ne_sk_top_left_causal(dtype, against):
    """Sq=128 queries over Sk=256 keys: query i sees keys 0..i."""
    q, = _normal(5, (1, 2, 128, 64), dtype=dtype)
    k, v = _normal(6, (1, 2, 256, 64), (1, 2, 256, 64), dtype=dtype)
    got = ops.flash_attention(*_th(dtype, q, k, v), causal=True)
    if against == "oracle":
        want = jx_ref.flash_attention_ref(*_jx(dtype, q, k, v), causal=True)
    else:
        want = jx_ops.flash_attention(*_jx(dtype, q, k, v), causal=True,
                                      bq=128, bk=128)
    _close(got, want, dtype)
    # keys past the diagonal change nothing
    k2, v2 = k.copy(), v.copy()
    k2[:, :, 128:] = 7.0
    v2[:, :, 128:] = -3.0
    again = ops.flash_attention(*_th(dtype, q, k2, v2), causal=True)
    assert torch.equal(got, again)


@pytest.mark.parametrize("against", ["oracle", "pallas"])
def test_flash_attention_bshd_gqa(against):
    B, S, Hq, Hkv, D = 2, 128, 8, 2, 64
    q, k, v = _normal(1, (B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D))
    got = ops.flash_attention_bshd(*_th("float32", q, k, v))
    assert got.shape == (B, S, Hq, D) and got.is_contiguous()
    qj, kj, vj = _jx("float32", q, k, v)
    if against == "oracle":
        kr = jnp.repeat(kj, Hq // Hkv, 2).transpose(0, 2, 1, 3)
        vr = jnp.repeat(vj, Hq // Hkv, 2).transpose(0, 2, 1, 3)
        want = jx_ref.flash_attention_ref(qj.transpose(0, 2, 1, 3), kr, vr
                                          ).transpose(0, 2, 1, 3)
    else:
        want = jx_ops.flash_attention_bshd(qj, kj, vj, bq=64, bk=64)
    _close(got, want, "float32")


# ---------------------------------------------------------------------------
# decode_attention
# ---------------------------------------------------------------------------

def _decode_case(S, dtype, lengths, seed):
    B, H, D = 2, 4, 64
    q, k, v = _normal(seed, (B, H, 1, D), (B, H, S, D), (B, H, S, D),
                      dtype=dtype)
    lens = np.asarray(lengths, np.int32)
    got = ops.decode_attention(*_th(dtype, q, k, v), torch.from_numpy(lens))
    assert got.dtype == _TH[dtype] and got.shape == (B, H, 1, D)
    return got, _jx(dtype, q, k, v) + [jnp.asarray(lens)], v


@pytest.mark.parametrize("against", ["oracle", "pallas"])
@pytest.mark.parametrize("S,bk", [(256, 64), (512, 512), (384, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_vs_jax(S, bk, dtype, against):
    got, args, _ = _decode_case(S, dtype, [S // 2, S], seed=S)
    want = (jx_ref.decode_attention_ref(*args) if against == "oracle"
            else jx_ops.decode_attention(*args, bk=bk))
    _close(got, want, dtype)


@pytest.mark.parametrize("against", ["oracle", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_length_zero_row(dtype, against):
    """A row of length 0 masks every key with the finite NEG_INF, so it
    averages v uniformly over the whole cache."""
    got, args, v = _decode_case(256, dtype, [0, 100], seed=7)
    want = (jx_ref.decode_attention_ref(*args) if against == "oracle"
            else jx_ops.decode_attention(*args, bk=64))
    _close(got, want, dtype)
    mean = torch.from_numpy(v[0]).mean(1, keepdim=True)
    _close(got[0], mean.to(_TH[dtype]), dtype)


# ---------------------------------------------------------------------------
# int8 codec
# ---------------------------------------------------------------------------

def _codec_inputs(shape, dtype):
    x, = _normal(shape[0] + shape[1], shape, dtype=dtype, scale=5.0)
    rng = np.random.default_rng(shape[0])
    noise = rng.uniform(-0.5, 0.5, shape).astype(np.float32)
    return x, noise


@pytest.mark.parametrize("shape", [(256, 128), (512, 64), (1024, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_encode_vs_jax(shape, dtype):
    x, noise = _codec_inputs(shape, dtype)
    q, scale = ops.int8_encode(_th(dtype, x)[0], torch.from_numpy(noise))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    assert scale.shape == (shape[0], 1)
    xj, nj = _jx(dtype, x)[0], jnp.asarray(noise)
    q_or, s_or = jx_ref.int8_encode_ref(xj, nj)
    q_pl, s_pl = jx_ops.int8_encode(xj, nj)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_or))
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_pl))
    np.testing.assert_array_equal(scale.numpy().view(np.uint32),
                                  np.asarray(s_or).view(np.uint32))
    np.testing.assert_allclose(scale.numpy(), np.asarray(s_pl), rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("shape", [(256, 128), (512, 64), (1024, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_decode_vs_jax(shape, dtype):
    x, noise = _codec_inputs(shape, "float32")
    q, scale = jx_ref.int8_encode_ref(jnp.asarray(x), jnp.asarray(noise))
    got = ops.int8_decode(torch.from_numpy(np.array(q)),
                          torch.from_numpy(np.array(scale)),
                          dtype=_TH[dtype])
    assert got.dtype == _TH[dtype]
    bits = np.int16 if dtype == "bfloat16" else np.int32
    got_bits = got.view(torch.int16 if dtype == "bfloat16"
                        else torch.int32).numpy()
    for want in (jx_ref.int8_decode_ref(q, scale, dtype=_JX[dtype]),
                 jx_ops.int8_decode(q, scale, dtype=_JX[dtype])):
        np.testing.assert_array_equal(got_bits, np.asarray(want).view(bits))


def test_int8_round_trip_within_one_step():
    """Stochastic rounding moves each value by less than one step."""
    x, noise = _codec_inputs((64, 300), "float32")
    q, scale = ops.int8_encode(torch.from_numpy(x), torch.from_numpy(noise))
    err = (ops.int8_decode(q, scale) - torch.from_numpy(x)).abs()
    assert bool((err <= scale * 1.001 + 1e-6).all())


def test_entry_points_launch_nothing_on_cpu():
    build.reset_launches()
    q, = _normal(3, (1, 2, 64, 64))
    ops.flash_attention(*_th("float32", q, q, q))
    ops.flash_attention_bshd(*_th("float32", q, q, q))
    ops.decode_attention(*_th("float32", q[:, :, :1], q, q),
                         torch.tensor([5], dtype=torch.int32))
    qi, s = ops.int8_encode(*_th("float32", q[0, 0], q[0, 1]))
    ops.int8_decode(qi, s)
    assert all(n == 0 for n in build.LAUNCHES.values())
