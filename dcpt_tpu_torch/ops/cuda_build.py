"""Build a CUDA source of ``dcpt_tpu_torch/csrc`` with ``nvcc`` and load it with ctypes.

Each library is built at first use into ``build/kernels/<name>-<hash>/`` at the
root of the checkout (listed in ``.gitignore``); the hash covers the sources,
the shared headers of ``csrc`` and the compiler flags, so an edited kernel is
rebuilt and an unchanged one is loaded as it is.  The sources expose a plain C interface: no PyTorch headers,
so a build takes seconds.  Nothing here runs at import time.

Two helpers give the wrappers one host path a call: ``entry`` resolves a C
entry point of a build once per process, and ``on_device`` runs a launch on
a tensor's device and current stream without a device switch when that
device is the current one (a B = 1 call is set by the host).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of dcpt_tpu_torch build only where the CUDA toolkit is")


def build_library(name: str, sources: list[str]) -> tuple[Path, float]:
    """Compile ``sources`` (file names under csrc/) into ``lib<name>.so``.

    Returns the library path and the seconds spent compiling (0.0 when the
    library for these exact sources was already built).  The compiler's
    resource report (registers, shared memory, spills) lands in ``build.log``
    beside the library.
    """
    paths = [CSRC / s for s in sources]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths + sorted(CSRC.glob("*.cuh")):  # the sources and every header they may include
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    out_dir = BUILD_ROOT / f"{name}-{digest.hexdigest()[:16]}"
    lib_path = out_dir / f"lib{name}.so"
    if lib_path.exists():
        return lib_path, 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # compile to a temporary name, then rename: a concurrent build never loads a half-written file
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, paths)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / "build.log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name} ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, lib_path)
    return lib_path, time.perf_counter() - t0


def load_library(name: str, sources: list[str]) -> ctypes.CDLL:
    lib_path, _ = build_library(name, sources)
    return ctypes.CDLL(str(lib_path))


@functools.cache
def entry(lib, name: str):
    """The C function ``name`` of ``lib()``, an ops module's cached loader, resolved once."""
    return getattr(lib(), name)


# the current stream's handle as an int, without building a torch.cuda.Stream (a CUDA build of
# PyTorch has it; the public path below stands in where it does not)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def on_device(x: torch.Tensor, run):
    """``run(stream)`` on x's device and its current stream: no device switch when x
    is on the current device."""
    index = x.get_device()
    if index == torch.cuda.current_device():
        return run(_raw_stream(index) if _raw_stream else torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(index):
        return run(torch.cuda.current_stream().cuda_stream)
