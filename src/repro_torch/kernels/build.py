"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds).
Every source starts compiling at once, in parallel.  Libraries land in
``build/repro_torch/<hash>/`` at the repository root, keyed by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
loaded as it is.  Nothing here runs at import time: ``nvcc`` exists only on
the machine with the card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

from repro_torch.obs import metrics as obs_metrics

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
#: seconds the last build took (0.0 when every library was already built)
last_build_seconds = 0.0
#: ptxas resource report of the last build, per source
last_build_log: Dict[str, str] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source; the message carries its output."""


class LaunchCounter:
    """Launches of one kernel: the wrapper adds one where it launches the
    kernel, and nowhere else."""

    def __init__(self, name: str):
        self.name = name
        self.n = 0

    def reset(self) -> None:
        """Set the count to 0."""
        self.n = 0


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH or the toolkit's."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise KernelBuildError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every source that is not built yet (all in parallel), load
    every library, and return them by source name."""
    global last_build_seconds
    if _LIBS:
        return _LIBS
    out_dir = BUILD_ROOT / _digest()
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = {}
    t0 = obs_metrics.now()
    for src in sorted(CSRC.glob("*.cu")):
        lib = out_dir / f"lib{src.stem}.so"
        if lib.exists():
            continue
        tmp = out_dir / f".lib{src.stem}.{os.getpid()}.so"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        todo[src.stem] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, lib)
    errors = []
    for name, (proc, tmp, lib) in todo.items():
        log, _ = proc.communicate()
        last_build_log[name] = log
        if proc.returncode != 0:
            errors.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n"
                          f"{log}")
            continue
        os.replace(tmp, lib)
    last_build_seconds = obs_metrics.now() - t0
    if errors:
        raise KernelBuildError("CUDA kernel build failed:\n" +
                               "\n".join(errors))
    for src in sorted(CSRC.glob("*.cu")):
        _LIBS[src.stem] = ctypes.CDLL(str(out_dir / f"lib{src.stem}.so"))
    return _LIBS


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built."""
    return BUILD_ROOT / _digest() / f"lib{name}.so"


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (builds at first
    use)."""
    return build_all()[name]


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on ``device`` (a tensor's device, so
    its index is set), as an integer.  PyTorch's raw-stream query skips
    building a Stream object, a few microseconds of every launch."""
    import torch
    return torch._C._cuda_getCurrentRawStream(device.index)
