"""adamw_ms.train: device ms a step of the kernels launched under the
program's adamw.update range (clipping and the per-leaf update)."""
from cellbench import program

TAGS = ("adamw.update",)


def read(tc):
    return program.tagged_ms_per(tc, "adamw.update", tc.counts["steps"])
