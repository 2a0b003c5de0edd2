"""serve_host_ms.serve: host ms an epoch in the program's serve_loop.batch
(the queue, the site, padding, the copy to the device) and
serve_loop.account (carbon and completions) spans."""
from cellbench import program


def read(tc):
    snap = program.snapshot()
    if snap is None:
        return None
    n = program.span_count(snap, "serve_loop.epoch")
    if not n:
        return None
    return program.span_seconds(
        snap, ("serve_loop.batch", "serve_loop.account")) / n * 1e3
