"""prefill_ms.serve: ms a call of the model's prefill inside
Server.step_epoch, the device synchronised on both sides (the
benchmark's span serve.prefill)."""
from cellbench.trace import Span

SPANS = (Span("repro_torch.runtime.serve_loop", "prefill", "serve.prefill",
              sync=True),)


def read(tc):
    return tc.span_ms("serve.prefill") if tc.on_card else None
