"""Device selection for the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``cuda`` by default; an explicit device is taken as given.

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and no GPU is visible: the port never carries on quietly on
    the CPU. Pass ``device="cpu"`` to run the plain torch versions there.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to plan on the "
            "CPU with the kernels' plain torch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {dev}")
    return dev


def require_free(device: torch.device, need: int, what: str) -> None:
    """Raise ``MemoryError`` before anything is allocated if ``need``
    bytes (``what`` takes them) exceed the free memory of ``device``, a
    CUDA device; the CPU is not checked."""
    if device.type != "cuda":
        return
    free, _ = torch.cuda.mem_get_info(device)
    if need > free:
        raise MemoryError(f"{what} take {need:,} bytes; {device} has "
                          f"{free:,} bytes free")
