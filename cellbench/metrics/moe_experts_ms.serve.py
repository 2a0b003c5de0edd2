"""moe_experts_ms.serve: device ms an epoch of the MoE layers' expert
products: the kernels launched under the program's moe.experts ranges
over the number of serve_loop.epoch spans."""
from cellbench import program

TAGS = ("moe.experts",)


def read(tc):
    snap = program.snapshot()
    if snap is None:
        return None
    return program.tagged_ms_per(tc, "moe.experts",
                                 program.span_count(snap, "serve_loop.epoch"))
