"""Mid-transfer FTN migration [paper §4.3]: checkpoint the offsets on the
current FTN, re-plan on the overlay, resume the remaining bytes on the new
node. The previously moved bytes are NOT re-transferred (the point of
checkpointing — cf. the mobile-offloading lineage [25]).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.carbon.score import TransferLedger
from repro_torch.core.scheduler.overlay import FTN, OverlayScheduler
from repro_torch.core.transfer.engine import TransferEngine, TransferState


@dataclasses.dataclass
class MigratedTransfer:
    final_state: TransferState
    ledger: TransferLedger
    migrations: int
    ftn_sequence: Tuple[str, ...]


def migrate_transfer(engine: TransferEngine, overlay: OverlayScheduler,
                     *, job_uuid: str, source: str, first_ftn: FTN,
                     size_bytes: float, t0: float,
                     check_every_s: float = 900.0,
                     max_migrations: int = 4) -> MigratedTransfer:
    """Run source→FTN with threshold-triggered hand-offs."""
    ledger = TransferLedger(job_uuid)
    current = first_ftn
    seq = [current.name]
    st = engine.start(job_uuid, source, current.name, size_bytes, t0)
    migrations = 0

    while not st.finished and migrations <= max_migrations:
        next_check = st.t_now + check_every_s
        pending: dict = {}

        def on_step(state: TransferState, ci: float) -> bool:
            if state.t_now < next_check:
                return True
            choice = overlay.maybe_migrate(
                source=source, current=current, t=state.t_now,
                current_ci=ci, bytes_done=state.bytes_done)
            if choice is None:
                return True
            pending["choice"] = choice
            return False                      # pause for hand-off

        st = engine.run(st, ledger=ledger, on_step=on_step)
        if st.finished:
            break
        choice = pending.get("choice")
        if choice is None:
            continue
        # hand-off: checkpoint offsets, resume on the new FTN
        token = st.checkpoint()
        migrations += 1
        current = choice.ftn
        seq.append(current.name)
        st = engine.start(job_uuid, source, current.name, size_bytes,
                          st.t_now, resume=token)
    return MigratedTransfer(final_state=st, ledger=ledger,
                            migrations=migrations, ftn_sequence=tuple(seq))
