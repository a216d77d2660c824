"""Build a CUDA source of dcpt_tpu_torch/csrc for the CPU, to check a kernel where there is no GPU.

    python -m dcpt_tpu_torch.tools.cuda_emu.build naf_block_bwd.cu [more.cu ...]

Each source is rewritten (kernel launches ``k<<<g, b, smem, stream>>>(...)``
become ``emu::Launcher(k, g, b, smem)(...)``, ``extern __shared__`` arrays
become the block's shared buffer) and compiled with g++ against the headers
in ``include/``, which run a block's CUDA threads as fibers on the calling
thread, each as far as its next barrier (``__syncthreads``, or its warp's in
a shuffle), and poison shared memory with NaN.  The
library lands in ``build/cuda_emu/lib<name>.so`` with the same C entry
points as nvcc's build: load it with ctypes and call an ops wrapper's
``_launch(lib, ...)`` on CPU tensors (their data pointers are host memory),
then compare with the plain version (``tests/test_torch_cuda_emu.py`` does
this for K3).  One CPU core runs every CUDA thread: use shapes of a few tiles.
Static ``__shared__`` arrays are not emulated.  It catches indexing and
barrier faults, not nvcc's own complaints.
"""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
INCLUDE = Path(__file__).resolve().parent / "include"
OUT = Path(__file__).resolve().parents[3] / "build" / "cuda_emu"


def rewrite(text: str) -> str:
    text = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?float (\w+)\[\];", r"float* \1 = emu::tl_smem;", text)
    return re.sub(r"([A-Za-z_]\w*(?:<[^<>;]*>)?)<<<(.*?)>>>\(", r"emu::Launcher(\1, \2)(", text, flags=re.S)


def build(source: str, out: Path = OUT) -> Path:
    """Rewrite every csrc file into ``out`` and compile ``source`` there; returns
    the library's path, or raises with g++'s errors."""
    out.mkdir(parents=True, exist_ok=True)
    for f in CSRC.glob("*.cu*"):
        (out / f.name).write_text(rewrite(f.read_text()))
    lib = out / f"lib{Path(source).stem}.so"
    cmd = ["g++", "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread", "-w", f"-I{INCLUDE}",
           "-include", "cuda_runtime.h", "-x", "c++", str(out / source), "-o", str(lib)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {source}:\n{proc.stderr[-4000:]}")
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
