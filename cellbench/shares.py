"""Shares of the card that per-layer readers report, in percent: a
kernel's least time by the frozen counts over its profiled device time,
the model FLOPs over the window at the bf16 peak, and the device's idle
share. Each returns None where the run left nothing to read (no card, no
trace, no call of the kernel), never 0."""
from __future__ import annotations

from typing import Optional

from cellbench.counts.flash import flash_work
from cellbench.counts.model import flops_per_token
from cellbench.counts.ssd import ssd_work
from cellbench.peaks import BF16_FLOPS, least_seconds
from cellbench.trace import Span

# the spans that the roofline readers declare around the port's kernel
# entries (``kernels/ops.py``), with each call's arguments, and the
# kernels' names
SSD_SPAN = Span("repro_torch.kernels.ops", "ssd_scan", "kernel.ssd_scan",
                calls=True)
FLASH_SPAN = Span("repro_torch.kernels.ops", "flash_attention",
                  "kernel.flash_attention", calls=True)
SSD_KERNELS, FLASH_KERNEL = "ssd_scan_", "flash_fwd_wgmma"


def ssd_roofline(tc) -> Optional[float]:
    """The SSD kernels (its four passes) against the least time of the
    calls the trace recorded, each counted from its shapes."""
    calls, t = tc.op_calls(SSD_SPAN.name), tc.kernel_seconds(SSD_KERNELS)
    if not tc.on_card or not calls or t <= 0:
        return None
    least = 0.0
    for x, _, _, bm, _, chunk in calls:          # x, dt, A, Bm, Cm, chunk
        B, S, nh, hd = x
        least += least_seconds(*ssd_work(B, S, nh, hd, bm[3], bm[2], chunk))
    return 100.0 * least / t


def flash_roofline(tc) -> Optional[float]:
    """The flash kernel against the least time of the calls the trace
    recorded, each counted over its causal band and window."""
    calls, t = tc.op_calls(FLASH_SPAN.name), tc.kernel_seconds(FLASH_KERNEL)
    if not tc.on_card or not calls or t <= 0:
        return None
    least = 0.0
    for q, k, _, causal, window in calls:          # q, k, v, causal, window
        B, T, Hq, d = q
        least += least_seconds(*flash_work(B, T, k[1], Hq, k[2], d, causal,
                                           window))
    return 100.0 * least / t


def mfu(tc, train: bool, tokens: float) -> Optional[float]:
    """Model FLOPs of ``tokens`` over the window at the bf16 peak."""
    w = tc.counts.get("window_s")
    if not tc.on_card or not w or tokens <= 0:
        return None
    return 100.0 * flops_per_token(tc.model, train) * tokens / (w * BF16_FLOPS)


def idle(tc) -> Optional[float]:
    """The share of the traced window in which no device event ran."""
    if not tc.on_card or tc.trace is None or tc.trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tc.trace["busy_s"] / tc.trace["window_s"])
