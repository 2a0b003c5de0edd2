"""Transfer throughput model, the resumable transfer engine and
mid-transfer FTN migration."""
from repro_torch.core.transfer.throughput import ThroughputModel
from repro_torch.core.transfer.engine import (StepObs, TransferEngine,
                                              TransferState)
from repro_torch.core.transfer.migrate import migrate_transfer

__all__ = ["ThroughputModel", "TransferEngine", "TransferState", "StepObs",
           "migrate_transfer"]
