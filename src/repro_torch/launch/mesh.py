"""Host meshes (the reference's ``launch/mesh.py``).

Functions, never module-level constants, so importing this module
touches no device.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch._device import resolve_device
from repro_torch.runtime.pspec import AbstractMesh, HostMesh


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The reference's production mesh as a shape-only mesh: one pod,
    ``(data=16, model=16)`` = 256 chips, or two, ``(pod=2, data=16,
    model=16)`` = 512, whose 'pod' axis is pure data parallelism. It has no
    devices: one process cannot hold 256 cards. It resolves specs and
    shard shapes (``pspec.named_sharding``) and places nothing."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def make_host_mesh(n_devices: int = 0, *,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> HostMesh:
    """A ``(n, 1)`` ``("data", "model")`` mesh: over the visible ``cuda:i``
    (``n_devices`` of them, 0 for all), or with ``device="cpu"`` over
    ``n_devices`` copies of the CPU device (0 for one), the counterpart of
    the reference's forced host-device count."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        devs = [dev] * (n_devices or 1)
    else:
        visible = torch.cuda.device_count()
        if n_devices > visible:
            raise ValueError(f"{n_devices} devices asked for, {visible} "
                             f"visible")
        devs = [torch.device("cuda", i) for i in range(n_devices or visible)]
    return HostMesh([[d] for d in devs], ("data", "model"))
