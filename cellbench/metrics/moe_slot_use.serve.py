"""moe_slot_use.serve: the share of the expert products' rows that hold
an assignment in decode: 100 x the program's moe.kept over moe.slots
(E x capacity a MoE layer a step), counted inside serve_loop.decode."""
from cellbench import program


def read(tc):
    snap = program.snapshot()
    if snap is None:
        return None
    slots = program.counter(snap, "moe.slots", "serve_loop.decode")
    if not slots:
        return None
    return 100.0 * program.counter(snap, "moe.kept",
                                   "serve_loop.decode") / slots
