"""The card's energy over a window, read from the card itself.

NVML's cumulative energy counter (``nvmlDeviceGetTotalEnergyConsumption``,
mJ since the driver loaded), through ``libnvidia-ml`` with ``ctypes``. The
counter moves in steps of about 100 ms on an H100, so each end of the
window is taken on a step: :meth:`Meter.tick` waits for the counter to
move and returns its new value. The source and the card's power limit are
printed to standard error before the window. The card is found by the UUID
of the CUDA device the run uses (NVML numbers every card of the host and
ignores ``CUDA_VISIBLE_DEVICES``). A card that NVML cannot find by that
UUID, or whose counter cannot be read, fails the run (``OSError``) rather
than report energy from another card.
"""
from __future__ import annotations

import ctypes
import sys
import time


def nvml_uuid(device) -> bytes:
    """NVML's UUID of the torch CUDA ``device`` (``GPU-`` and the UUID that
    CUDA gives the card)."""
    import torch
    return f"GPU-{torch.cuda.get_device_properties(device).uuid}".encode()


class _NVML:
    def __init__(self, uuid: bytes):
        lib = self.lib = ctypes.CDLL("libnvidia-ml.so.1")
        ptr, rc = ctypes.POINTER, ctypes.c_int
        lib.nvmlInit_v2.argtypes, lib.nvmlInit_v2.restype = [], rc
        f = lib.nvmlDeviceGetHandleByUUID
        f.argtypes, f.restype = [ctypes.c_char_p, ptr(ctypes.c_void_p)], rc
        f = lib.nvmlDeviceGetTotalEnergyConsumption
        f.argtypes = [ctypes.c_void_p, ptr(ctypes.c_ulonglong)]
        f.restype = rc
        f = lib.nvmlDeviceGetPowerManagementLimit
        f.argtypes, f.restype = [ctypes.c_void_p, ptr(ctypes.c_uint)], rc
        if lib.nvmlInit_v2() != 0:
            raise OSError("nvmlInit failed")
        self.uuid = uuid.decode()
        self.h = ctypes.c_void_p()
        rc = lib.nvmlDeviceGetHandleByUUID(uuid, ctypes.byref(self.h))
        if rc != 0:
            raise OSError(f"NVML finds no card with the UUID {self.uuid} "
                          f"of the run's CUDA device (nvml error {rc})")
        self.energy_mj()

    def energy_mj(self) -> int:
        e = ctypes.c_ulonglong()
        rc = self.lib.nvmlDeviceGetTotalEnergyConsumption(self.h,
                                                          ctypes.byref(e))
        if rc != 0:
            raise OSError(f"nvmlDeviceGetTotalEnergyConsumption: {rc}")
        return int(e.value)

    def limit_w(self) -> float:
        v = ctypes.c_uint()
        if self.lib.nvmlDeviceGetPowerManagementLimit(self.h,
                                                      ctypes.byref(v)):
            return float("nan")
        return v.value / 1e3


class Meter:
    """``start()`` and ``stop()`` around the window; ``joules`` between
    them, of the card that runs torch's CUDA ``device``."""

    source = "nvml_total_energy_counter"

    def __init__(self, device):
        self.nvml = _NVML(nvml_uuid(device))
        self.e0 = self.e1 = 0

    def announce(self) -> None:
        print(f"energy source: {self.source}; card {self.nvml.uuid}, "
              f"power.limit {self.nvml.limit_w()} W", file=sys.stderr,
              flush=True)

    def tick(self) -> int:
        """Wait (at most 0.5 s) for the counter to move: its new value."""
        e = self.nvml.energy_mj()
        deadline = time.perf_counter() + 0.5
        while time.perf_counter() < deadline:
            e2 = self.nvml.energy_mj()
            if e2 != e:
                return e2
            time.sleep(0.0005)
        return e

    def start(self) -> None:
        self.e0 = self.tick()

    def stop(self) -> None:
        self.e1 = self.tick()

    @property
    def joules(self) -> float:
        return (self.e1 - self.e0) / 1e3
