"""train_host_ms.train: host ms a Trainer step in the program's
train_loop.data (the batch) and train_loop.account (fleet time, carbon,
the sync cadence, checkpoint, migration and history) spans."""
from cellbench import program


def read(tc):
    snap = program.snapshot()
    if snap is None:
        return None
    n = program.span_count(snap, "train_loop.step_fn")
    if not n:
        return None
    return program.span_seconds(
        snap, ("train_loop.data", "train_loop.account")) / n * 1e3
