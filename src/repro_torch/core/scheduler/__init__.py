"""Time/space/overlay shifting and the joint SLA planner."""
from repro_torch.core.scheduler.forecast import (HarmonicForecaster,
                                                 PersistenceForecaster)
from repro_torch.core.scheduler.time_shift import best_start_time
from repro_torch.core.scheduler.space_shift import best_source
from repro_torch.core.scheduler.overlay import OverlayScheduler, best_ftn
from repro_torch.core.scheduler.planner import (SLA, Plan,
                                                TorchCarbonPlanner,
                                                TransferJob)
from repro_torch.core.scheduler.queue import CarbonAwareQueue

__all__ = [
    "HarmonicForecaster", "PersistenceForecaster", "best_start_time",
    "best_source", "OverlayScheduler", "best_ftn", "TorchCarbonPlanner",
    "Plan", "TransferJob", "SLA", "CarbonAwareQueue",
]
