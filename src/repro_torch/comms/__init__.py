"""Collective-schedule co-simulation: compile a real training step's
parallelism plan (DP/TP/PP/EP over a `repro_torch.configs` model) into
the slot engine's flow + demand-timeline representation.

Pipeline:
  `ScheduleSpec` (pure data, `scenarios.spec`)
    -> `plan_schedule`  (byte accounting + static step skeleton, here)
    -> `lower_schedule` (flows + (T, K) phase-multiplier timeline +
                         `TrainSchedule` step metadata, `comms.lower`)
    -> the slot engine, via `WorkloadSpec(kind='schedule')`.

The gradient bytes come from the model's parameter layout as meta
tensors (`models.param_shapes`): no weights are built.
"""
from .schedule import (LANES_PER_SCHEDULE, Phase, SchedulePlan,
                       TrainSchedule, plan_schedule, sim_bytes)
from .lower import lower_schedule

__all__ = [
    "LANES_PER_SCHEDULE", "Phase", "SchedulePlan", "TrainSchedule",
    "plan_schedule", "sim_bytes", "lower_schedule",
]
