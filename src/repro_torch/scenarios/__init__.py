from .spec import (FaultBoundsError, FaultSpec, ScenarioSpec, SimSpec,
                   TenantSpec, TopologySpec, WorkloadSpec)
from .compile import CompiledScenario, compile_scenario
from .registry import SCENARIOS, get_scenario, list_scenarios
from .runner import ScenarioMetrics, distill_metrics, run_point
