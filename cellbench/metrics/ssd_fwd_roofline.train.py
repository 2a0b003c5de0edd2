"""ssd_fwd_roofline.train: the SSD chunk-scan kernels (forward and the
remat recompute) at their share of the least time the frozen counts give
(counts/ssd.py)."""
from cellbench.shares import SSD_SPAN, ssd_roofline

SPANS = (SSD_SPAN,)


def read(tc):
    return ssd_roofline(tc)
