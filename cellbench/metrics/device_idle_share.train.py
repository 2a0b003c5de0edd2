"""device_idle_share.train: the share of the traced window in which no
device event ran (1 - busy / window)."""
from cellbench.shares import idle


def read(tc):
    return idle(tc)
