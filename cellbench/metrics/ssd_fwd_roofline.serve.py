"""ssd_fwd_roofline.serve: the SSD chunk-scan kernel in the prefills, at
its share of the least time the frozen counts give (counts/ssd.py)."""
from cellbench.shares import SSD_SPAN, ssd_roofline

SPANS = (SSD_SPAN,)


def read(tc):
    return ssd_roofline(tc)
