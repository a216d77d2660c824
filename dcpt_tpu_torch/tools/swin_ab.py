"""Time K8 and K10 built from several copies of ``csrc`` side by side on one card.

    python -m dcpt_tpu_torch.tools.swin_ab [NAME=CSRC_DIR ...]

Builds ``swin_block.cu`` and ``window_attention.cu`` from the package's own
``csrc`` (named ``tree``) and from each other directory given (a parent
commit's ``dcpt_tpu_torch/csrc`` unpacked with ``git archive``, or a copy with
one change), all with nvcc's flags of ``ops/cuda_build.py``, into
``build/swin_ab/<name>``.  Then, at SwinIR's shipped width (C 180, 6 heads,
8 x 8 windows, hidden 360) on a 128 x 128 map at B = 1 shifted by 4, in fp32
(TF32 off) and bf16: each version's K8 and K10 (without its LayerNorm)
against the plain version, and its ms a call by CUDA events over 20
back-to-back calls, in turns (every version, then every version in reverse
order), beside ``nn.TransformerEncoderLayer`` and
``F.multi_head_attention_forward`` on the same inputs.  Prints the card's name
and power limit first.  Needs the card and nvcc.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

from ..ops import cuda_build
from ..ops import window_attention as wa

C, HEADS, WS, HIDDEN, SHIFT = 180, 6, 8, 360, 4
OUT = Path(__file__).resolve().parents[2] / "build" / "swin_ab"


def _build(name: str, csrc: Path) -> dict:
    out = OUT / name
    out.mkdir(parents=True, exist_ok=True)

    def one(src: str) -> ctypes.CDLL:
        lib = out / f"lib{src}.so"
        proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib), str(csrc / f"{src}.cu")],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}/{src}.cu:\n{proc.stderr[-3000:]}")
        report = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines() if "registers" in ln or "spill" in ln]
        print(f"{name} {src}: " + "; ".join(report), flush=True)
        bind = wa._bind_block if src == "swin_block" else wa._bind_attn
        return bind(ctypes.CDLL(str(lib)))

    with ThreadPoolExecutor(2) as pool:
        block, attn = pool.map(one, ("swin_block", "window_attention"))
    return {"K8": block, "K10": attn}


def _ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _params(gen, dtype):
    def r(*shape, scale=0.3, shift=0.0):
        return (torch.randn(*shape, generator=gen) * scale + shift).to("cuda", dtype)

    return [r(C, shift=1.0), r(C), r(3 * C, C, scale=C ** -0.5).t(), r(3 * C), r(C, C, scale=C ** -0.5).t(), r(C),
            r(C, shift=1.0), r(C), r(HIDDEN, C, scale=C ** -0.5).t(), r(HIDDEN), r(C, HIDDEN, scale=HIDDEN ** -0.5).t(),
            r(C)]


def main(argv: list[str]) -> int:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dirs = {"tree": cuda_build.CSRC, **{a.split("=", 1)[0]: Path(a.split("=", 1)[1]) for a in argv}}
    libs = {name: _build(name, path) for name, path in dirs.items()}
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(13)
    with torch.no_grad():
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            x = torch.randn(1, 128, 128, C, generator=gen).to("cuda", dtype)
            p = _params(gen, dtype)
            pf = [t.float() for t in p]
            refs = {"K8": wa.swin_block_map_ref(x.float(), *pf, HEADS, WS, SHIFT),
                    "K10": wa.window_attention_map_ref(x.float(), *pf[2:6], HEADS, WS, SHIFT)}
            stream = torch.cuda.current_stream().cuda_stream
            calls = {}
            for name, lib in libs.items():
                calls[(name, "K8")] = (lambda lib=lib: wa._launch_block(lib["K8"], x, p, HEADS, WS, SHIFT, 1e-5, stream))
                calls[(name, "K10")] = (lambda lib=lib: wa._launch_attn(lib["K10"], x, p[2:6], HEADS, WS, SHIFT, None,
                                                                        stream))
            for (name, kernel), fn in calls.items():
                z = fn()
                torch.cuda.synchronize()
                ref = refs[kernel]
                err = (z.float() - ref).abs().max().item() / max(1.0, ref.abs().max().item())
                print(f"{dname} {name} {kernel}: error {err:.3e} relative to max(1, max|ref|)", flush=True)
            times = {key: [] for key in calls}
            for key in [*calls, *reversed(list(calls))]:
                times[key].append(_ms(calls[key]))
            win = wa.window_partition(torch.roll(x, (-SHIFT, -SHIFT), dims=(1, 2)), WS)
            layer = torch.nn.TransformerEncoderLayer(C, HEADS, HIDDEN, dropout=0.0, activation="gelu",
                                                     batch_first=True, norm_first=True).to("cuda", dtype).eval()
            win_t = win.transpose(0, 1)
            library = {"nn.TransformerEncoderLayer": lambda: layer(win),
                       "F.multi_head_attention_forward": lambda: F.multi_head_attention_forward(
                           win_t, win_t, win_t, C, HEADS, p[2].t(), p[3], None, None, False, 0.0, p[4].t(), p[5],
                           training=False, need_weights=False)}
            for (name, kernel), ms in times.items():
                print(f"{dname} {name} {kernel}: " + " / ".join(f"{t:.4f}" for t in ms) + " ms a call", flush=True)
            for name, fn in library.items():
                print(f"{dname} {name}: {_ms(fn):.4f} ms a call", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
