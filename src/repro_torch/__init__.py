"""PyTorch/CUDA port of the carbon-aware data-movement planner.

Mirrors the reference package's paths (``repro_torch.core.carbon``,
``repro_torch.core.scheduler``, ...) and imports nothing of it. Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``; with no
GPU and no explicit device they raise (see :func:`resolve_device`).
"""
from repro_torch._device import resolve_device

__all__ = ["resolve_device"]
