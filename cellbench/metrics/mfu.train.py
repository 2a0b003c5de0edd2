"""mfu.train: 6·N·tokens trained in the window over the window at the
bf16 peak (N without the embedding table; counts/model.py)."""
from cellbench.shares import mfu


def read(tc):
    return mfu(tc, True, tc.counts["tokens"])
