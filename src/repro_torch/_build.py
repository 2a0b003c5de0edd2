"""Build the port's CUDA sources and load them through ``ctypes``.

Each ``repro_torch/csrc/<name>.cu`` has a plain C interface and is built
by ``nvcc`` for ``sm_90a`` into its own shared library under
``build/repro_torch_kernels/``, named by a hash of the source and the
flags, so an edited source or flag set never loads a stale build. Nothing
is built at import: a wrapper builds its library at first use, and
:func:`build` starts several ``nvcc`` processes at once.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" \
    / "repro_torch_kernels"
_BASE_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")


@dataclasses.dataclass(frozen=True)
class KernelSource:
    """``csrc/<name>.cu`` and the nvcc flags it needs beyond the base
    ones."""
    name: str
    flags: Tuple[str, ...] = ()

    @property
    def path(self) -> Path:
        return CSRC / f"{self.name}.cu"

    def nvcc_flags(self) -> Tuple[str, ...]:
        return _BASE_FLAGS + self.flags

    def library(self) -> Path:
        tag = hashlib.sha256(self.path.read_bytes()
                             + " ".join(self.nvcc_flags()).encode())
        return BUILD_DIR / f"lib{self.name}_{tag.hexdigest()[:16]}.so"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: the port's kernels are built "
                           "from source and need the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(*sources: KernelSource) -> Dict[str, Tuple[Path, str]]:
    """Build every source whose library does not exist yet, all ``nvcc``
    processes started together. Returns, per source name, the library
    path and nvcc's output (``-Xptxas -v``: registers, shared memory and
    spills per kernel), kept beside the library so that a build that was
    already there reports it too."""
    out: Dict[str, Tuple[Path, str]] = {}
    running = []
    for src in sources:
        lib = src.library()
        if lib.exists():
            log = lib.with_suffix(".log")
            out[src.name] = (lib, log.read_text() if log.exists() else "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc(), *src.nvcc_flags(), "-o", str(tmp), str(src.path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((src, lib, tmp, proc))
    failed: Optional[str] = None
    for src, lib, tmp, proc in running:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed = failed or f"nvcc failed to build {src.path}:\n{log}"
            continue
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)           # atomic: a reader never sees half
        out[src.name] = (lib, log)
    if failed:
        raise RuntimeError(failed)
    return out


@functools.lru_cache(maxsize=None)
def load(src: KernelSource) -> ctypes.CDLL:
    """The source's library, built first if needed; the caller declares
    each function's ``argtypes`` and ``restype``."""
    return ctypes.CDLL(str(build(src)[src.name][0]))
