"""Simulation parameters of one run."""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.trace import TraceSpec


@dataclass
class SimConfig:
    slots: int = 2000
    slot_us: float = 10.0
    routing: str = "ar"          # 'ar' | 'war' | 'ecmp'
    nic: str = "spx"             # 'spx' | 'dcqcn' | 'global' | 'esr' | 'swlb'
    base_rtt_us: float = 4.0
    warmup_frac: float = 0.25
    sw_lb_delay_ms: float = 1000.0
    seed: int = 0
    record_every: int = 1
    trace: TraceSpec = TraceSpec()

    def sw_lb_delay_slots(self) -> int:
        """swlb reaction delay in slots (0 for hardware-PLB stacks)."""
        return (int(self.sw_lb_delay_ms * 1000 / self.slot_us)
                if self.nic == "swlb" else 0)
