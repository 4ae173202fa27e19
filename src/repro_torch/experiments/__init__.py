"""Unified experiment API on the port's slot engine: arbitrary-axis
sweeps over `ScenarioSpec` override paths, columnar `ResultSet`
results, and a content-hashed run cache with resume — the counterpart
of the reference's `repro.experiments` (see README "PyTorch/CUDA
port")."""
from .axes import Axis, Chain, Product, Zip, chain, product, zip_axes
from .cache import RunCache, canonicalize, spec_key
from .execute import DISPATCH_MODES, execute_points
from .experiment import (EXPERIMENTS, Experiment, ExperimentPoint,
                         engine_salt, get_experiment, list_experiments,
                         register_experiment, run_experiment)
from .overrides import OverridePathError, apply_override, get_path
from .resultset import ResultSet, axis_column
from . import library  # noqa: F401  (populates the experiment registry)
