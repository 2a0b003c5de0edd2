"""decode_host_ms.serve: host ms a call of decode_step inside
Server.step_epoch's decode loop (the benchmark's span
serve.decode_step, no synchronisation)."""
from cellbench.trace import Span

SPANS = (Span("repro_torch.runtime.serve_loop", "decode_step",
              "serve.decode_step"),)


def read(tc):
    return tc.span_ms("serve.decode_step") if tc.on_card else None
