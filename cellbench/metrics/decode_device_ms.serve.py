"""decode_device_ms.serve: device ms a decode step: the kernels launched
under the program's serve_loop.decode ranges (a decode_step call and its
argmax) over the number of those spans."""
from cellbench import program

TAGS = ("serve_loop.decode",)


def read(tc):
    snap = program.snapshot()
    if snap is None:
        return None
    return program.tagged_ms_per(tc, "serve_loop.decode",
                                 program.span_count(snap, "serve_loop.decode"))
