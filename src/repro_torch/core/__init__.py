"""The framework-level core: planes and their payload split, the NIC
plane load balancer and its congestion control, switch adaptive
routing, failover control, telemetry, and the plane-sharded gradient
sync: `plane_allreduce` over a data-parallel process group, its int8
codec and the stream accounting."""
from .adaptive_routing import (ar_scores, ecmp_fractions, ecmp_select,
                               jsq_select, quantize_queue, spray_fractions)
from .collectives import (int8_decode, int8_encode, plane_allreduce,
                          stream_report)
from .congestion import DcqcnConfig, SpxCCConfig, dcqcn_update, spx_cc_update
from .fault_tolerance import (FailoverController, RecoveryRecord,
                              concurrent_failure_pmf, elastic_mesh_plan,
                              poisson_flaps)
from .planes import PlaneConfig, apportion, effective_bandwidth, plane_loads
from .plb import PLBState, plane_weights, plb_init, plb_update, select_plane
from .telemetry import HFTBuffer, StepTimeTracker

__all__ = ["PlaneConfig", "apportion", "plane_loads", "effective_bandwidth",
           "PLBState", "plb_init", "plb_update", "select_plane",
           "plane_weights", "SpxCCConfig", "DcqcnConfig", "spx_cc_update",
           "dcqcn_update", "plane_allreduce", "stream_report",
           "int8_encode", "int8_decode", "FailoverController",
           "RecoveryRecord", "poisson_flaps", "concurrent_failure_pmf",
           "elastic_mesh_plan", "HFTBuffer", "StepTimeTracker",
           "quantize_queue", "ar_scores", "jsq_select", "ecmp_select",
           "spray_fractions", "ecmp_fractions"]
