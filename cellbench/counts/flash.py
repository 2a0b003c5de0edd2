"""Work of one flash-attention call: the (query, key) products that the
causal band and the window need, and q, k, v and o moved once each."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def band_pairs(T: int, S: int, causal: bool, window: Optional[int]) -> int:
    """(query, key) pairs attended: query i and key j at positions
    ``0..T-1`` and ``0..S-1`` with ``j <= i`` when causal and ``i - j <
    window`` when a window is given (the port's mask)."""
    i = np.arange(T, dtype=np.int64)
    hi = np.minimum(i, S - 1) if causal else np.full(T, S - 1, np.int64)
    lo = (np.maximum(i - window + 1, 0) if window is not None
          else np.zeros(T, np.int64))
    return int(np.clip(hi - lo + 1, 0, None).sum())


def flash_work(B: int, T: int, S: int, Hq: int, Hkv: int, d: int,
               causal: bool, window: Optional[int], elt: int = 2
               ) -> Tuple[int, int]:
    """(FLOPs, bytes): 2·d for q·k and 2·d for p·v a pair and query head;
    q and o [B, T, Hq, d] and k and v [B, S, Hkv, d] once, ``elt`` bytes an
    element (bf16)."""
    flops = 4 * d * Hq * B * band_pairs(T, S, causal, window)
    bytes_ = elt * (2 * B * T * Hq * d + 2 * B * S * Hkv * d)
    return flops, bytes_
