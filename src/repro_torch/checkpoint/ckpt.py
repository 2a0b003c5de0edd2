"""Checkpointing: atomic local save/restore + carbon-aware mirroring.

Local saves are atomic (write to <dir>.tmp, fsync, rename) so a failure
mid-save never corrupts the latest checkpoint. Mirroring to remote sites
(disaster recovery / elastic migration source) is a bulk DCN transfer —
exactly the movement class the paper schedules: the manager emits a
``TransferJob`` whose deadline is the next checkpoint interval, and the
carbon planner picks the start hour / target replica (time + space shift).

The reference's ``checkpoint/ckpt.py`` layout: ``step_XXXXXXXX/`` with
``arrays.npz`` and ``meta.json``, a ``LATEST`` pointer, the last ``keep``
steps kept. The arrays are the port's state dicts, keyed
``params/<name>``, ``opt/step`` and ``opt/{master,m,v}/<name>``; bf16
tensors are stored as f32 (numpy has no bf16) and come back bit for bit.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
import uuid
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.scheduler.planner import SLA, TransferJob
from repro_torch.optim.adamw import OptState

_OPT_TREES = ("master", "m", "v")


def _arrays(params: Mapping[str, torch.Tensor],
            opt_state: Optional[OptState]) -> Dict[str, np.ndarray]:
    def host(t: torch.Tensor) -> np.ndarray:
        t = t.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    out = {f"params/{k}": host(t) for k, t in params.items()}
    if opt_state is not None:
        out["opt/step"] = np.asarray(opt_state.step, dtype=np.int32)
        for tree in _OPT_TREES:
            for k, t in getattr(opt_state, tree).items():
                out[f"opt/{tree}/{k}"] = host(t)
    return out


def _fsync_write(path: str, text: str) -> None:
    with open(path, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())


def save_checkpoint(ckpt_dir: str, step: int,
                    params: Mapping[str, torch.Tensor],
                    opt_state: Optional[OptState] = None,
                    extra: Optional[Dict] = None) -> str:
    """Atomic save; returns the final directory path."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    arrays = _arrays(params, opt_state)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    meta = {"step": step, "time": time.time(), "extra": extra or {},
            "n_arrays": len(arrays)}
    _fsync_write(os.path.join(tmp, "meta.json"), json.dumps(meta))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    # update the LATEST pointer atomically too
    latest_tmp = os.path.join(ckpt_dir, "LATEST.tmp")
    _fsync_write(latest_tmp, os.path.basename(final))
    os.rename(latest_tmp, os.path.join(ckpt_dir, "LATEST"))
    return final


def load_checkpoint(ckpt_dir: str, step: Optional[int] = None,
                    params_template: Optional[Mapping[str, torch.Tensor]]
                    = None, opt_template: Optional[OptState] = None
                    ) -> Tuple[int, Optional[Dict[str, torch.Tensor]],
                               Optional[OptState], Dict[str, Any]]:
    """Returns (step, params, opt_state, extra). The templates give the
    names, dtypes and devices; opt_state is None when the template is, or
    when the checkpoint holds no optimizer state."""
    if step is None:
        with open(os.path.join(ckpt_dir, "LATEST")) as f:
            path = os.path.join(ckpt_dir, f.read().strip())
    else:
        path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        def rebuild(prefix, template):
            return {k: torch.from_numpy(data[f"{prefix}/{k}"]).to(
                dtype=t.dtype, device=t.device) for k, t in template.items()}
        params = (None if params_template is None
                  else rebuild("params", params_template))
        opt = None
        if opt_template is not None and "opt/step" in data.files:
            opt = OptState(int(data["opt/step"]),
                           *(rebuild(f"opt/{tree}",
                                     getattr(opt_template, tree))
                             for tree in _OPT_TREES))
    return meta["step"], params, opt, meta.get("extra", {})


def state_bytes(params: Mapping[str, torch.Tensor],
                opt_state: Optional[OptState] = None) -> int:
    """Bytes of the parameters and optimizer state, counting the step
    counter as the reference's int32 scalar."""
    n = sum(t.numel() * t.element_size() for t in params.values())
    if opt_state is not None:
        n += 4 + sum(t.numel() * t.element_size()
                     for tree in _OPT_TREES
                     for t in getattr(opt_state, tree).values())
    return n


@dataclasses.dataclass
class CheckpointManager:
    ckpt_dir: str
    interval_steps: int = 100
    keep: int = 3
    mirror_replicas: Tuple[str, ...] = ()     # remote sites to mirror to
    mirror_deadline_s: float = 6 * 3600.0

    def __post_init__(self):
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.pending_mirrors: List[TransferJob] = []

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.interval_steps == 0

    def save(self, step: int, params: Mapping[str, torch.Tensor],
             opt_state: Optional[OptState] = None,
             extra: Optional[Dict] = None, *, src_site: str = "site_or",
             now: float = 0.0) -> str:
        path = save_checkpoint(self.ckpt_dir, step, params, opt_state, extra)
        self._gc()
        if self.mirror_replicas:
            # the mirror is shiftable bulk movement: give it to the planner
            self.pending_mirrors.append(TransferJob(
                uuid=str(uuid.uuid4()),
                size_bytes=float(state_bytes(params, opt_state)),
                replicas=(src_site,), dst=self.mirror_replicas[0],
                sla=SLA(deadline_s=self.mirror_deadline_s),
                submitted_t=now))
        return path

    def restore_latest(self, params_template, opt_template=None):
        return load_checkpoint(self.ckpt_dir, None, params_template,
                               opt_template)

    def has_checkpoint(self) -> bool:
        return os.path.exists(os.path.join(self.ckpt_dir, "LATEST"))

    def _gc(self) -> None:
        steps = sorted(d for d in os.listdir(self.ckpt_dir)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for d in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, d))
