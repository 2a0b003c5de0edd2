"""ssd_bwd_ms.train: device ms a step of the kernels launched under the
profiler's _SSDScanBackward node (the SSD scan's plain recompute backward)."""

TAGS = ("_SSDScanBackward",)


def read(tc):
    if not tc.on_card or tc.trace is None:
        return None
    s = tc.trace["tagged_s"].get("_SSDScanBackward", 0.0)
    return s / tc.counts["steps"] * 1e3 if s > 0 else None
