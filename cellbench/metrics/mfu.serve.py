"""mfu.serve: 2·N_active·(prompt tokens without padding + generated
tokens) of the requests completed in the window, over the window at the
bf16 peak."""
from cellbench.shares import mfu


def read(tc):
    return mfu(tc, False, tc.counts["prompt_tokens"] + tc.counts["tokens"])
