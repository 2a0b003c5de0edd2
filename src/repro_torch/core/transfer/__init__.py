"""Transfer throughput model and the resumable transfer engine."""
from repro_torch.core.transfer.throughput import ThroughputModel
from repro_torch.core.transfer.engine import (StepObs, TransferEngine,
                                              TransferState)

__all__ = ["ThroughputModel", "TransferEngine", "TransferState", "StepObs"]
