"""Host meshes (the reference's ``launch/mesh.py``).

A function, never a module-level constant, so importing this module
touches no device. The production meshes (``make_production_mesh``) wait
for ROADMAP.md queue 1 item 11.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch._device import resolve_device
from repro_torch.runtime.pspec import HostMesh


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
