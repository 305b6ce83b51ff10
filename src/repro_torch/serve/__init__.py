"""repro_torch.serve — the continuous aggregation service (LIFL serving
plane): ingress admission control, rolling rounds, multi-job
fair-share over one fleet, on the card unless the caller names another
device."""
from repro_torch.obs.live import FleetMonitor, SLOTarget, SLOTracker
from repro_torch.serve.gateway import AdmissionPolicy, IngressGateway
from repro_torch.serve.scheduler import (
    DeadlinePolicy,
    GoalPolicy,
    MinCohortIdleGap,
    RoundScheduler,
)
from repro_torch.serve.service import AggregationService

__all__ = [
    "AdmissionPolicy",
    "AggregationService",
    "DeadlinePolicy",
    "FleetMonitor",
    "GoalPolicy",
    "IngressGateway",
    "MinCohortIdleGap",
    "RoundScheduler",
    "SLOTarget",
    "SLOTracker",
]
