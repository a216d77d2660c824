"""Build a CUDA source of dcpt_tpu_torch/csrc for the CPU, to check a kernel where there is no GPU.

    python -m dcpt_tpu_torch.tools.cuda_emu.build naf_block_bwd.cu [more.cu ...]

Each source is rewritten (kernel launches ``k<<<g, b, smem, stream>>>(...)``
become ``emu::Launcher(k, g, b, smem)(...)``, ``extern __shared__`` arrays
become the block's shared buffer) and compiled with g++ against the headers
in ``include/``, which run a block's CUDA threads as fibers on the calling
thread, each as far as its next barrier (``__syncthreads``, or its warp's in
a shuffle or an MMA), and poison shared memory with NaN.  A csrc header that
wraps PTX (``ptx.cuh``: TF32 rounding, ``mma.sync``, ``cp.async``) is replaced
by its emulation of the same name in ``include/``.  The
library lands in ``build/cuda_emu/lib<name>.so`` with the same C entry
points as nvcc's build: load it with ctypes and call an ops wrapper's
``_launch(lib, ...)`` on CPU tensors (their data pointers are host memory),
then compare with the plain version (``tests/test_torch_cuda_emu.py`` does
this for K3).  One CPU core runs every CUDA thread: use shapes of a few tiles.
Static ``__shared__`` arrays are not emulated.  It catches indexing and
barrier faults, and a launch past the card's limits (1024 threads, 232448
bytes of shared memory, 65535 blocks along y or z), not nvcc's own
complaints.  Each library also exports ``cuda_emu_launches()``: the kernel
launches it has run, for a test to count.  A library is compiled once for
each content of its inputs (every rewritten csrc file, the emulation headers
and the command): later builds of the same content, from any process, copy
it from ``build/cuda_emu/cache/<hash>``.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
INCLUDE = Path(__file__).resolve().parent / "include"
OUT = Path(__file__).resolve().parents[3] / "build" / "cuda_emu"


def rewrite(text: str) -> str:
    text = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?float (\w+)\[\];", r"float* \1 = emu::tl_smem;", text)
    return re.sub(r"([A-Za-z_]\w*(?:<[^<>;]*>)?)<<<(.*?)>>>\(", r"emu::Launcher(\1, \2)(", text, flags=re.S)


def build(source: str, out: Path = OUT) -> Path:
    """Rewrite every csrc file into ``out`` and compile ``source`` there (or copy
    the library compiled from the same content before); returns the library's
    path, or raises with g++'s errors."""
    out.mkdir(parents=True, exist_ok=True)
    inputs = {f.name: rewrite(f.read_text()) for f in sorted(CSRC.glob("*.cu*"))}
    # the emulations of csrc's PTX headers, and the headers g++ reads from include/
    inputs.update({f.name: f.read_text() for f in sorted(INCLUDE.glob("*.cuh"))})
    for name, text in inputs.items():
        (out / name).write_text(text)
    lib = out / f"lib{Path(source).stem}.so"
    cmd = ["g++", "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread", "-w", f"-I{INCLUDE}",
           "-include", "cuda_runtime.h", "-x", "c++", str(out / source), "-o", str(lib)]
    key = hashlib.sha256(repr((source, cmd[:-4], sorted(inputs.items()),
                               sorted((f.name, f.read_bytes()) for f in INCLUDE.rglob("*") if f.is_file())))
                         .encode()).hexdigest()[:24]
    cached = OUT / "cache" / key / lib.name
    if cached.exists():
        shutil.copyfile(cached, lib)
        return lib
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {source}:\n{proc.stderr[-4000:]}")
    cached.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=cached.parent, suffix=".so.tmp")  # another process may be writing it too
    os.close(fd)
    shutil.copyfile(lib, tmp)
    os.replace(tmp, cached)
    return lib


def main(sources: list[str]) -> int:
    failed = 0
    for src in sources:
        try:
            print(f"{src}: built {build(src)}")
        except RuntimeError as e:
            print(e)
            failed += 1
    return failed


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
