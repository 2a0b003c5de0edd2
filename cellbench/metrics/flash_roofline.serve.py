"""flash_roofline.serve: the flash kernel in the prefills, at its share
of the least time the frozen counts give (counts/flash.py)."""
from cellbench.shares import FLASH_SPAN, flash_roofline

SPANS = (FLASH_SPAN,)


def read(tc):
    return flash_roofline(tc)
