"""LR schedules (pure functions of the step)."""
from __future__ import annotations

import math


def lr_schedule(step: int, *, base_lr: float, warmup_steps: int,
                total_steps: int, min_ratio: float = 0.1) -> float:
    """Linear warmup then cosine decay to min_ratio * base_lr."""
    warm = min(1.0, (step + 1) / max(warmup_steps, 1))
    prog = min(max((step - warmup_steps) / max(total_steps - warmup_steps, 1),
                   0.0), 1.0)
    cos = 0.5 * (1 + math.cos(math.pi * prog))
    return base_lr * warm * (min_ratio + (1 - min_ratio) * cos)
