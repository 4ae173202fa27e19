"""`REPRO_JX_STRICT_F32`: the float32 `bytes_total` overflow guard as a
hard error, in the port as in the reference.

A spec whose `bytes_total` exceeds float32's integer resolution (2^24)
prepared for a float32 run is logged and warned about once per spec
name (`tests/test_torch_experiments.py`); with `REPRO_JX_STRICT_F32=1`
both packages log it and then raise `ValueError` (the reference under
JAX's default float32, the port with `dtype=torch.float32`), and any
other value but the true ones keeps the warning.
"""
import dataclasses
import warnings

import jax
import pytest
import torch

from repro.experiments import apply_override as jx_apply_override
from repro.netsim.jx import engine as jx_engine
from repro.scenarios import compile_scenario as jx_compile
from repro.scenarios import get_scenario as jx_get
from repro_torch.experiments import apply_override
from repro_torch.netsim import engine
from repro_torch.scenarios import compile_scenario, get_scenario


def _probe(get, override, name):
    return dataclasses.replace(
        override(get("fig9_victim_noise").with_sim(slots=6),
                 "workloads[0].bytes_total", 3e7), name=name)


@pytest.mark.parametrize("value", ["1", "true", "ON", "y"])
def test_strict_f32_raises_after_logging_in_both_packages(monkeypatch,
                                                          value):
    monkeypatch.setenv("REPRO_JX_STRICT_F32", value)
    assert engine.strict_f32() and jx_engine.strict_f32()
    name = f"strict_f32_probe_{value}"
    rc = jx_compile(_probe(jx_get, jx_apply_override, name))
    n_ref = len(jx_engine.f32_overflow_log())
    with jax.enable_x64(False), pytest.raises(ValueError, match="2\\^24"):
        rc.run(backend="jax")
    assert jx_engine.f32_overflow_log()[n_ref:] == (
        {"spec": name, "max_bytes": 3e7},)
    c = compile_scenario(_probe(get_scenario, apply_override, name))
    n = len(engine.f32_overflow_log())
    with pytest.raises(ValueError, match="2\\^24"):
        c.run(device="cpu", dtype=torch.float32)
    assert engine.f32_overflow_log()[n:] == (
        {"spec": name, "max_bytes": 3e7},)
    # float64 has the resolution: no error, nothing logged
    n = len(engine.f32_overflow_log())
    c.run(device="cpu", dtype=torch.float64)
    assert len(engine.f32_overflow_log()) == n


@pytest.mark.parametrize("value", [None, "0", "off", ""])
def test_strict_f32_unset_or_false_only_warns(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("REPRO_JX_STRICT_F32", raising=False)
    else:
        monkeypatch.setenv("REPRO_JX_STRICT_F32", value)
    assert not engine.strict_f32()
    assert engine.strict_f32() == jx_engine.strict_f32()
    name = f"strict_f32_warn_probe_{value}"
    c = compile_scenario(_probe(get_scenario, apply_override, name))
    with pytest.warns(UserWarning, match="2\\^24"):
        c.run(device="cpu", dtype=torch.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        c.run(device="cpu", dtype=torch.float32)
