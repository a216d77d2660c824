"""Time the block kernels built from several copies of ``csrc`` side by side on one card.

    python -m dcpt_tpu_torch.tools.swin_ab [--k9 | --k7 | --k2 | --k6 | --k1 | --k45 | --k14 | --k13]
        [--bits] [NAME=CSRC_DIR ...]

Builds the kernels from the package's own ``csrc`` (named ``tree``) and from
each other directory given (a parent commit's ``dcpt_tpu_torch/csrc``
unpacked with ``git archive``, or a copy with one change), all with nvcc's
flags of ``ops/cuda_build.py``, into ``build/swin_ab/<name>``.  Then, in fp32
(TF32 off) and bf16: each version against the plain version and against the
tree's output bit for bit, and its ms a call by CUDA events over
back-to-back calls, in turns (every version, then every version in reverse
order).  Prints the card's name and power limit first.  Needs the card and
nvcc.

* without a flag: K8 and K10 (``swin_block.cu``, ``window_attention.cu``;
  K10 without its LayerNorm) at SwinIR's shipped width (C 180, 6 heads, 8 x 8
  windows, hidden 360) on a 128 x 128 map shifted by 4 at B = 1, beside
  ``nn.TransformerEncoderLayer`` and ``F.multi_head_attention_forward`` on the
  same inputs;
* ``--k9``: K9 (``swin_block_bwd.cu``) at that width at B = 2 and B = 8;
* ``--k7``: K7 (``mdta_block_bwd.cu``) from the tree's K6 residuals at
  Restormer's (C, H = W, heads) = (96, 128, 1) and (384, 16, 8) in both
  flavours (ReLU / BiasFree and softmax / WithBias), B = 2 and B = 8;
* ``--k2``: K2 (``naf_block_bwd.cu``) from the tree's K1 residuals at
  NAFNet-w64's C = 64 on 128 x 128 and C = 512 on 16 x 16, B = 2 and B = 8;
* ``--k6``: K6 (``mdta_block.cu``) at Restormer's (C, H = W, heads) = (48,
  128, 1) and (384, 16, 8) in the ReLU / BiasFree flavour and (96, 128, 1) in
  the softmax / WithBias one, B = 1, 2 and 8;
* ``--k1``: K1 (``naf_block.cu``) at NAFNet-w64's C = 64 on 128 x 128 and
  C = 512 on 16 x 16, B = 1, 2 and 8;
* ``--k45``: K4 (``naf_prefix.cu``) and K5 (``naf_ffn.cu``) at NAFNet-w64's
  C = 512 on 16 x 16, B = 1, 2 and 8 (ten pairs of turns below B = 8, where
  the host sets a call's time, with each version's median);
* ``--k14``: K14 (``fused_ln_proj``) and K5' (``naf_expand``), the two entries
  of ``ln_proj.cu``, at B = 1 and 8: K14 at Restormer's first level (C 48 on
  128 x 128 -> 144 and 254, BiasFree) and its latent (C 384 on 16 x 16 ->
  1152, WithBias), K5' at NAFNet-w64's C = 512 on 16 x 16 -> 1024; the
  weight contiguous (c, c_out), and for the tree also as the transposed view
  a module passes (bit for bit the same output); beside each, ``F.layer_norm``
  + ``F.linear`` on the same inputs; each build's tile at each shape
  (``ln_proj_tile``), and each build that picks one also at each of its tiles
  forced (the same bits), ten pairs of turns at B = 1, and at B = 8 the device
  time by pass of each build and of the library calls;
* ``--k13``: K13 (``mdta.cu``) at (BH, c, L) = (8, 48, 16384) ReLU (Restormer's
  enc1 at the train ymls' batch), (4, 176, 256) softmax (PromptIR's
  noise_level3), (1, 96, 16384) softmax (PromptIR's dec1 and refinement) and
  (1, 48, 16384) ReLU (enc1 at B = 1), fp32, and bf16 at enc1 and Restormer's
  latent (8, 48, 256); each build at its own tile and the tree at each tile
  forced (the same bits), beside ``F.normalize``, ``torch.bmm``, act,
  ``torch.bmm`` on the same inputs, and the tree through its wrapper
  ``mdta_attention`` (the host path a caller takes); ten pairs of turns, and
  the device time by pass of each build and of the library composition; the
  tree's wrapper and the library at every K13 shape of a 128 x 128 Restormer
  and PromptIR forward, summed per forward;
  then K11 (``window_process.cu``) through its wrappers at B = 1 on SwinIR's
  128 x 128 x 180 map, shifts 0 and 4, beside ``permute().contiguous()``
  and ``torch.roll`` + ``permute().contiguous()``, and beside the same launch
  under a ``torch.cuda.device`` context with the library looked up on every
  call (the host path K11's wrappers took before they shared K14's); ten
  pairs of turns, and each one's device time by pass;

and for these six, at B = 8 (K4 and K5 at every batch), each version's
device time by pass (``pass_split``: each launch of one call in order,
torch.profiler).  A K6, K1, K4 or K5 build from before its scratch-size
entry (``mdta_block_scratch_floats``, ``naf_block_scratch_floats``,
``naf_prefix_scratch_floats``, ``naf_ffn_scratch_floats``) is sized by the
entry it had (K4's then took no scratch, K5's an (N, C) hidden map), and a
``ln_proj.cu`` build from before the weight's layout arguments by its old
entries (a contiguous weight only).  ``--bits`` runs the checks alone: each
build's error against the plain version and whether it has the tree's bits,
no timing.
"""

from __future__ import annotations

import ctypes
import functools
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

from ..ops import cuda_build
from ..ops import ln_proj as lp
from ..ops import mdta as md
from ..ops import mdta_block as mb
from ..ops import mdta_block_bwd as mbb
from ..ops import naf_block as nb
from ..ops import naf_block_bwd as nbb
from ..ops import naf_ffn as nff
from ..ops import naf_prefix as npf
from ..ops import swin_block_bwd as sbb
from ..ops import window_attention as wa
from ..ops import window_process as wp

C, HEADS, WS, HIDDEN, SHIFT = 180, 6, 8, 360, 4
OUT = Path(__file__).resolve().parents[2] / "build" / "swin_ab"
# the kernels of each mode: label -> (source, binder)
FORWARD = {"K8": ("swin_block", wa._bind_block), "K10": ("window_attention", wa._bind_attn)}
class _Sized:
    """A build from before its scratch-size entry: the entry points in ``entries``
    (the scratch size, and where the arguments changed, the kernel's own)
    answered by those callables, every other one by the build itself."""

    def __init__(self, lib: ctypes.CDLL, entries: dict):
        self._lib, self._entries = lib, entries

    def __getattr__(self, attr: str):
        return self._entries[attr] if attr in self._entries else getattr(self._lib, attr)


def _bind_k6(lib: ctypes.CDLL):
    if not hasattr(lib, "mdta_block_scratch_floats"):  # the Gram partials were all its scratch
        old = lib.mdta_block_part_floats
        old.argtypes, old.restype = [ctypes.c_int] * 5, ctypes.c_longlong
        lib = _Sized(lib, {"mdta_block_scratch_floats": lambda b, h, w, c, f, heads: old(b, h, w, c, heads)})
    return mb._bind(lib)


def _bind_k1(lib: ctypes.CDLL):
    if not hasattr(lib, "naf_block_scratch_floats"):  # (B, tiles, C) tile sums were all its scratch
        old = lib.naf_block_num_tiles
        old.argtypes, old.restype = [ctypes.c_int] * 2, ctypes.c_int
        lib = _Sized(lib, {"naf_block_scratch_floats": lambda b, h, w, c: b * old(h, w) * c})
    return nb._bind(lib)


def _bind_k4(lib: ctypes.CDLL):
    if hasattr(lib, "naf_prefix_scratch_floats"):
        return npf._bind(lib)
    entries = {"naf_prefix_scratch_floats": lambda b, h, w, c: 0}
    for name in npf._ENTRY.values():  # (x, 6 parameters, g, ..., eps, stream): no scratch argument
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        entries[name] = lambda *a, fn=fn: fn(*a[:8], *a[9:])
    return _Sized(lib, entries)


def _bind_k5(lib: ctypes.CDLL):
    if hasattr(lib, "naf_ffn_scratch_floats"):
        return nff._bind(lib)
    for name in nff._ENTRY.values():  # the same arguments, the scratch an (N, C) hidden map
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return _Sized(lib, {"naf_ffn_scratch_floats": lambda n, c: n * c})


def _bind_k14(lib: ctypes.CDLL):
    if hasattr(lib, "ln_proj_tile"):
        return lp._bind(lib)
    entries = {"ln_proj_tile": lambda rows, c, n, which: 0}  # the SIMT kernel: no tensor-core tile
    for suffix in lp._SUFFIX.values():  # no weight layout arguments: w contiguous (c, c_out)
        proj, expand = getattr(lib, "ln_proj_" + suffix), getattr(lib, "naf_expand_" + suffix)
        proj.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        expand.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
        proj.restype = expand.restype = ctypes.c_int

        def old(*a, fn):  # (x, ln_w, ln_b, w, ldw, k_major, ..., tile, stream) -> (x, ln_w, ln_b, w, ..., stream)
            if a[5]:
                raise ValueError("a build from before the weight's layout arguments takes a contiguous weight only")
            return fn(*a[:4], *a[6:-2], a[-1])

        entries["ln_proj_" + suffix] = functools.partial(old, fn=proj)
        entries["naf_expand_" + suffix] = functools.partial(old, fn=expand)
    return _Sized(lib, entries)


class _OldK13:
    """A ``mdta.cu`` build from before its tile argument (the SIMT kernel):
    ``launch`` runs it as its wrapper did, the workspace sized by its own entry."""

    def __init__(self, lib: ctypes.CDLL):
        self.lib = lib
        for suffix in md._SUFFIX.values():
            fn = getattr(lib, "mdta_" + suffix)
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.mdta_workspace_floats.argtypes, lib.mdta_workspace_floats.restype = [ctypes.c_int] * 3, ctypes.c_longlong

    def launch(self, q, k, v, t, use_softmax, stream, tile=-1):
        bh, c, length = q.shape
        out = torch.empty_like(v)
        ws = torch.empty(self.lib.mdta_workspace_floats(bh, c, length), dtype=torch.float32, device=q.device)
        err = getattr(self.lib, "mdta_" + md._SUFFIX[q.dtype])(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                                              t.reshape(bh).contiguous().data_ptr(), out.data_ptr(),
                                                              ws.data_ptr(), bh, c, length, int(use_softmax), stream)
        if err:
            raise RuntimeError(f"mdta kernel launch failed with CUDA error {err}")
        return out


class _NewK13:
    """A ``mdta.cu`` build with its tile argument, run by the tree's ``_launch`` (a candidate must
    cut L into the tree's chunks: the workspace is sized by ``mdta.workspace_floats``)."""

    def __init__(self, lib: ctypes.CDLL):
        self.lib = md._bind(lib)

    def launch(self, q, k, v, t, use_softmax, stream, tile=-1):
        return md._launch(self.lib, q, k, v, t, use_softmax, stream, tile=tile)


def _bind_k13(lib: ctypes.CDLL):
    # both export the same entries; the SIMT build's workspace also holds the chunks' sums and
    # colsum's scratch, so it differs from the tree's reckoning at (1, 1, 1)
    lib.mdta_workspace_floats.argtypes, lib.mdta_workspace_floats.restype = [ctypes.c_int] * 3, ctypes.c_longlong
    return _NewK13(lib) if lib.mdta_workspace_floats(1, 1, 1) == md.workspace_floats(1, 1, 1) else _OldK13(lib)


BLOCK_MODES = {"--k9": {"K9": ("swin_block_bwd", sbb._bind)}, "--k7": {"K7": ("mdta_block_bwd", mbb._bind)},
            "--k2": {"K2": ("naf_block_bwd", nbb._bind)}, "--k6": {"K6": ("mdta_block", _bind_k6)},
            "--k1": {"K1": ("naf_block", _bind_k1)},
            "--k45": {"K4": ("naf_prefix", _bind_k4), "K5": ("naf_ffn", _bind_k5)},
            "--k14": {"K14": ("ln_proj", _bind_k14)}, "--k13": {"K13": ("mdta", _bind_k13)}}
BATCHES = {"K9": (2, 8), "K7": (2, 8), "K2": (2, 8), "K6": (1, 2, 8), "K1": (1, 2, 8), "K4": (1, 2, 8),
           "K5": (1, 2, 8)}
K6_CASES = [(48, 128, 1, "relu"), (96, 128, 1, "softmax"), (384, 16, 8, "relu")]  # (C, H = W, heads, flavour)
K7_SHAPES = [(96, 128, 1), (384, 16, 8)]  # (C, H = W, heads)
K7_FLAVOURS = {"relu": (False, False, 1e-6), "softmax": (True, True, 1e-5)}  # (use_softmax, ln_bias, eps)
K2_SHAPES = [(64, 128), (512, 16)]  # (C, H = W)
_MARKERS = 16  # pass_split's marker launches
# --k14: (kernel, C, H = W, C_out, flavour): Restormer's enc1 qkv and project_in, its latent qkv; K5' at c = 512
K14_CASES = [("K14", 48, 128, 144, "relu"), ("K14", 48, 128, 254, "relu"), ("K14", 384, 16, 1152, "softmax"),
             ("K5'", 512, 16, 1024, None)]
K14_TILES = ["96x96", "64x128", "32x64", "128x128"]  # ln_proj.cu's tiles, in pick_tile's numbering
# --k13: (BH, c, L, softmax) in fp32, then in bf16
K13_CASES = [(8, 48, 16384, False), (4, 176, 256, True), (1, 96, 16384, True), (1, 48, 16384, False)]
K13_BF16 = [(1, 48, 16384, False), (8, 48, 256, False)]
K13_TILES = ["48", "96"]  # mdta.cu's tile families, in its numbering: the Gram's square block tile
# the K13 calls of one 128 x 128 Restormer (ReLU) and PromptIR (softmax) forward: (BH, c, L) -> calls
K13_RESTORMER = {(1, 48, 16384): 4, (2, 48, 4096): 12, (4, 48, 1024): 12, (8, 48, 256): 8, (1, 96, 16384): 8}
K13_PROMPTIR = {**K13_RESTORMER, (4, 176, 256): 1, (4, 80, 1024): 1, (4, 40, 4096): 1}
BITS_ONLY = False  # --bits: the checks alone


def _build(name: str, csrc: Path, kernels: dict) -> dict:
    """{label: bound library} of ``kernels`` built from ``csrc`` (one nvcc a source, in parallel)."""
    out = OUT / name
    out.mkdir(parents=True, exist_ok=True)

    def one(src: str, bind) -> ctypes.CDLL:
        lib = out / f"lib{src}.so"
        proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib), str(csrc / f"{src}.cu")],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}/{src}.cu:\n{proc.stderr[-3000:]}")
        report = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines() if "registers" in ln or "spill" in ln]
        print(f"{name} {src}: " + "; ".join(report), flush=True)
        return bind(ctypes.CDLL(str(lib)))

    with ThreadPoolExecutor(len(kernels)) as pool:
        return dict(zip(kernels, pool.map(lambda item: one(*item), kernels.values())))


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


def _short(name: str) -> str:
    """A kernel's name without its namespaces, return type and argument list."""
    name = name.replace("(anonymous namespace)::", "").replace("tc::", "").replace("void ", "")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):  # the argument list starts at the first '(' outside the template arguments
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0:
            cut = i
            break
    return re.sub(r"\s+", " ", name[:cut])


def pass_split(fn, iters: int = 1) -> list[tuple[str, float]]:
    """Device ms of each launch of one call of ``fn`` in launch order, averaged over
    ``iters`` calls (torch.profiler, after a warm-up call): [(kernel, ms)].  Empty
    when the profiler records no device time.

    In a process that has profiled before, the profile can miss its first few
    launches; so a run of marker launches (fills of a one-element tensor) goes
    first, and the calls' launches are those after the last marker recorded
    (all of them if it recorded none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    marker = torch.empty(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(_MARKERS):
            marker.fill_(1.0)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    launches = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                      key=lambda e: e.time_range.start)
    fills = [i for i, e in enumerate(launches) if "fill" in e.name.lower()]
    launches = launches[fills[-1] + 1:] if fills else launches
    if not launches or len(launches) % iters:
        return []
    per = len(launches) // iters
    return [(_short(launches[i].name), sum(launches[i + k * per].time_range.elapsed_us() for k in range(iters))
             / iters / 1e3) for i in range(per)]


def print_split(label: str, split: list[tuple[str, float]]) -> None:
    total = sum(ms for _, ms in split)
    if not split:
        print(f"{label}: the profiler recorded no device time", flush=True)
        return
    print(f"{label}: {len(split)} launches, {total:.4f} ms of device time", flush=True)
    for name, ms in split:
        print(f"  {ms:>9.4f} ms {100 * ms / total:>5.1f} %  {name}", flush=True)


def _params(gen, dtype):
    def r(*shape, scale=0.3, shift=0.0):
        return (torch.randn(*shape, generator=gen) * scale + shift).to("cuda", dtype)

    return [r(C, shift=1.0), r(C), r(3 * C, C, scale=C ** -0.5).t(), r(3 * C), r(C, C, scale=C ** -0.5).t(), r(C),
            r(C, shift=1.0), r(C), r(HIDDEN, C, scale=C ** -0.5).t(), r(HIDDEN), r(C, HIDDEN, scale=HIDDEN ** -0.5).t(),
            r(C)]


def _compare(label: str, calls: dict, refs: dict) -> None:
    """Run each (version, kernel) call once: its worst error relative to max(1,
    max|ref|) against the plain version, and whether it has the tree's bits."""
    outs = {}
    for (name, kernel), fn in calls.items():
        got = fn()
        got = got if isinstance(got, (tuple, list)) else (got,)
        torch.cuda.synchronize()
        ref = refs[kernel]
        err = max((g.float() - r.float()).abs().max().item() / max(1.0, r.float().abs().max().item())
                  for g, r in zip(got, ref))
        tree = outs.setdefault(kernel, got)
        same = all(torch.equal(a, b) for a, b in zip(got, tree))
        print(f"{label} {name} {kernel}: worst error {err:.3e} relative to max(1, max|ref|); "
              f"{'the' if same else 'not the'} tree's bits", flush=True)


def _turns(label: str, calls: dict, iters: int, pairs: int = 1) -> None:
    """Each call's ms in ``pairs`` pairs of turns (every version, then every version
    in reverse order); with more than one pair, each version's median too."""
    times = {key: [] for key in calls}
    for _ in range(pairs):
        for key in [*calls, *reversed(list(calls))]:
            times[key].append(_ms(calls[key], iters))
    for (name, kernel), ms in times.items():
        median = f" (median {statistics.median(ms):.4f})" if pairs > 1 else ""
        print(f"{label} {name} {kernel}: " + " / ".join(f"{t:.4f}" for t in ms) + f" ms a call{median}", flush=True)


def forward_ab(libs: dict) -> None:
    """K8 and K10 of every build at B = 1, beside the library calls."""
    gen = torch.Generator().manual_seed(13)
    stream = torch.cuda.current_stream().cuda_stream
    with torch.no_grad():
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            x = torch.randn(1, 128, 128, C, generator=gen).to("cuda", dtype)
            p = _params(gen, dtype)
            pf = [t.float() for t in p]
            refs = {"K8": (wa.swin_block_map_ref(x.float(), *pf, HEADS, WS, SHIFT),),
                    "K10": (wa.window_attention_map_ref(x.float(), *pf[2:6], HEADS, WS, SHIFT),)}
            calls = {}
            for name, lib in libs.items():
                calls[(name, "K8")] = (lambda lib=lib: wa._launch_block(lib["K8"], x, p, HEADS, WS, SHIFT, 1e-5, stream))
                calls[(name, "K10")] = (lambda lib=lib: wa._launch_attn(lib["K10"], x, p[2:6], HEADS, WS, SHIFT, None,
                                                                        stream))
            _compare(dname, calls, refs)
            _turns(dname, calls, 20)
            win = wa.window_partition(torch.roll(x, (-SHIFT, -SHIFT), dims=(1, 2)), WS)
            layer = torch.nn.TransformerEncoderLayer(C, HEADS, HIDDEN, dropout=0.0, activation="gelu",
                                                     batch_first=True, norm_first=True).to("cuda", dtype).eval()
            win_t = win.transpose(0, 1)
            library = {"nn.TransformerEncoderLayer": lambda: layer(win),
                       "F.multi_head_attention_forward": lambda: F.multi_head_attention_forward(
                           win_t, win_t, win_t, C, HEADS, p[2].t(), p[3], None, None, False, 0.0, p[4].t(), p[5],
                           training=False, need_weights=False)}
            for name, fn in library.items():
                print(f"{dname} {name}: {_ms(fn):.4f} ms a call", flush=True)


def _rand(gen, dtype, *shape, scale=0.3, shift=0.0):
    return (torch.randn(*shape, generator=gen) * scale + shift).to("cuda", dtype)


def _k9_case(gen, batch, dtype, stream):
    """K9's inputs at SwinIR's width, 128 x 128: (label, plain cotangents, {label: launch(lib)})."""
    x, dz = (_rand(gen, dtype, batch, 128, 128, C, scale=1.0) for _ in range(2))
    p = _params(gen, dtype)
    yield "", sbb.swin_block_bwd_ref(x, *p, dz, HEADS, WS, SHIFT), (
        lambda lib: sbb._launch(lib, x, p, dz, HEADS, WS, SHIFT, 1e-5, stream))


def _k7_case(gen, batch, dtype, stream):
    """K7's inputs at each K7_SHAPES stage and flavour, from the tree's K6 residuals."""
    for c, s, heads in K7_SHAPES:
        p = _k6_params(gen, dtype, c, heads)
        x, dz = (_rand(gen, dtype, batch, s, s, c, scale=1.0) for _ in range(2))
        for act, flavour in K7_FLAVOURS.items():
            _, res = mb._kernel_forward(x, p, heads, *flavour, residuals=True)
            ref = mbb.mdta_block_bwd_ref(x.float(), *[t.float() for t in p], *res[:4], dz.float(), heads, *flavour)
            yield f" C={c} {s}x{s} heads={heads} {act}", ref, (
                lambda lib, res=res, flavour=flavour: mbb._launch(lib, x, p, dz, res, heads, *flavour, stream))


def _k6_params(gen, dtype, c, heads):
    """K6's parameters, drawn in PyTorch's layout and passed as the op-layout views a
    module passes (chip_smoke.mdta_params)."""
    f = int(2.66 * c)
    return [_rand(gen, dtype, c, shift=1.0), _rand(gen, dtype, c), _rand(gen, dtype, 3 * c, c, scale=c ** -0.5).t(),
            _rand(gen, dtype, 3 * c, 3, 3, scale=1 / 3).permute(1, 2, 0), _rand(gen, dtype, heads, 1, 1, shift=1.0),
            _rand(gen, dtype, c, c, scale=c ** -0.5).t(), _rand(gen, dtype, c, shift=1.0), _rand(gen, dtype, c),
            _rand(gen, dtype, 2 * f, c, scale=c ** -0.5).t(), _rand(gen, dtype, 2 * f, 3, 3, scale=1 / 3).permute(1, 2, 0),
            _rand(gen, dtype, c, f, scale=f ** -0.5).t()]


def _k1_params(gen, dtype, c):
    sc = c ** -0.5
    return [_rand(gen, dtype, *shape, scale=scale, shift=shift) for shape, scale, shift in [
        ((c,), 0.5, 1.0), ((c,), 0.5, 0.0), ((c, 2 * c), sc, 0.0), ((2 * c,), 0.5, 0.0),
        ((3, 3, 2 * c), 1 / 3, 0.0), ((2 * c,), 0.5, 0.0), ((c, c), sc, 0.0), ((c,), 0.5, 0.0), ((c, c), sc, 0.0),
        ((c,), 0.5, 0.0), ((c,), 0.5, 0.0), ((c,), 0.5, 1.0), ((c,), 0.5, 0.0), ((c, 2 * c), sc, 0.0),
        ((2 * c,), 0.5, 0.0), ((c, c), sc, 0.0), ((c,), 0.5, 0.0), ((c,), 0.5, 0.0)]]


def _k6_case(gen, batch, dtype, stream):
    """K6's inputs at each K6_CASES stage in its flavour."""
    for c, s, heads, act in K6_CASES:
        p = _k6_params(gen, dtype, c, heads)
        x = _rand(gen, dtype, batch, s, s, c, scale=1.0)
        flavour = K7_FLAVOURS[act]
        ref = mb.mdta_block_ref(x.float(), *[t.float() for t in p], heads, *flavour)
        yield f" C={c} {s}x{s} heads={heads} {act}", (ref,), (
            lambda lib, x=x, p=p, heads=heads, flavour=flavour: mb._launch(lib, x, p, heads, *flavour, stream))


def _k1_case(gen, batch, dtype, stream):
    """K1's inputs at each K2_SHAPES stage."""
    for c, s in K2_SHAPES:
        p = _k1_params(gen, dtype, c)
        x = _rand(gen, dtype, batch, s, s, c, scale=1.0)
        ref = nb.naf_block_ref(x.float(), *[t.float() for t in p])
        yield f" C={c} {s}x{s}", (ref,), (lambda lib, x=x, p=p: nb._launch(lib, x, p, 1e-6, stream))


def _k4_case(gen, batch, dtype, stream):
    """K4's inputs at the c = 512 stage (16 x 16)."""
    p = _k1_params(gen, dtype, 512)[:6]
    x = _rand(gen, dtype, batch, 16, 16, 512, scale=1.0)
    ref = npf.naf_prefix_ref(x.float(), *[t.float() for t in p])
    yield " C=512 16x16", (ref,), (lambda lib: npf._launch(lib, x, p, 1e-6, stream))


def _k5_case(gen, batch, dtype, stream):
    """K5's inputs at the c = 512 stage (16 x 16)."""
    p = _k1_params(gen, dtype, 512)[11:]
    y = _rand(gen, dtype, batch, 16, 16, 512, scale=1.0)
    ref = nff.naf_ffn_ref(y.float(), *[t.float() for t in p])
    yield " C=512 16x16", (ref,), (lambda lib: nff._launch(lib, y, p, 1e-6, stream))


def _k2_case(gen, batch, dtype, stream):
    """K2's inputs at each K2_SHAPES stage, from the tree's K1 residuals."""
    for c, s in K2_SHAPES:
        p = _k1_params(gen, dtype, c)
        x, dz = (_rand(gen, dtype, batch, s, s, c, scale=1.0) for _ in range(2))
        _, (*maps, pooled, att) = nb._kernel_forward(x, p, 1e-6, residuals=True)
        ref = nbb.naf_block_bwd_ref(x.float(), *[t.float() for t in p], pooled, att, dz.float())
        yield f" C={c} {s}x{s}", ref, (lambda lib: nbb._launch(lib, x, p, pooled, att, dz, maps, 1e-6, stream))


CASES = {"K9": _k9_case, "K7": _k7_case, "K2": _k2_case, "K6": _k6_case, "K1": _k1_case, "K4": _k4_case,
         "K5": _k5_case}


def block_ab(libs: dict, kernel: str) -> None:
    """``kernel`` (K9, K7, K2, K6, K1, K4 or K5) of every build at each of its BATCHES, and its passes at B = 8."""
    gen = torch.Generator().manual_seed(14)
    stream = torch.cuda.current_stream().cuda_stream
    for batch in BATCHES[kernel]:
        for dname in ("float32", "bfloat16"):
            for shape, ref, launch in CASES[kernel](gen, batch, getattr(torch, dname), stream):
                calls = {(name, kernel): (lambda lib=lib: launch(lib[kernel])) for name, lib in libs.items()}
                label = f"B={batch} {dname}{shape}"
                _compare(label, calls, {kernel: ref})
                del ref
                if BITS_ONLY:
                    continue
                # K4's and K5's calls below B = 8 are a few launches each, set by the host: ten pairs of turns
                _turns(label, calls, 4 if batch == 8 else 10, 10 if kernel in ("K4", "K5") and batch < 8 else 1)
                if batch == 8 or kernel in ("K4", "K5"):  # K4 and K5 below B = 8: a wave's depth walk, or the host
                    for (name, _), fn in calls.items():
                        print_split(f"{label} {name} by pass", pass_split(fn))
                torch.cuda.empty_cache()


def _k14_case(gen, batch, dtype, stream):
    """K14's and K5''s inputs at each K14_CASES shape: (label, kernel, plain output,
    launch(lib, w), the weight contiguous, its transposed view, the library call,
    (rows, C, C_out))."""
    for kernel, c, s, c_out, act in K14_CASES:
        x = _rand(gen, dtype, batch * s * s, c, scale=2.0, shift=0.5)
        ln_w, ln_b, w_pt = _rand(gen, dtype, c, shift=1.0), _rand(gen, dtype, c), _rand(gen, dtype, c_out, c,
                                                                                       scale=c ** -0.5)
        bias = _rand(gen, dtype, c_out) if kernel == "K5'" else None
        _, ln_bias, eps = K7_FLAVOURS[act] if act else (False, True, 1e-6)
        if not ln_bias:
            ln_b = torch.zeros_like(ln_b)
        dense = w_pt.t().contiguous()
        f32 = [t.float() for t in (x, ln_w, ln_b, dense)]
        ref = nff.naf_expand_ref(*f32, bias.float(), eps) if bias is not None else \
            lp.ln_proj_ref(*f32, eps, not ln_bias)

        def launch(lib, w, tile=-1, eps=eps, ln_bias=ln_bias, x=x, ln_w=ln_w, ln_b=ln_b, bias=bias):
            return lp.launch(lib, x, ln_w, ln_b, w, eps, stream, biasfree=not ln_bias, bias=bias, tile=tile)

        def library(x=x, ln_w=ln_w, ln_b=ln_b, w_pt=w_pt, bias=bias, eps=eps, c=c):
            return F.linear(F.layer_norm(x, (c,), ln_w, ln_b, eps), w_pt, bias)

        label = f" C={c} {s}x{s} -> {c_out} {'WithBias' if ln_bias else 'BiasFree'}"
        yield label, kernel, ref, launch, dense, w_pt.t(), library, (x.shape[0], c, c_out)


def k14_ab(libs: dict) -> None:
    """K14 and K5' of every build at B = 1 and 8 beside the library calls."""
    gen = torch.Generator().manual_seed(15)
    stream = torch.cuda.current_stream().cuda_stream
    with torch.no_grad():
        for batch in (1, 8):
            for dname in ("float32", "bfloat16"):
                for shape, kernel, ref, launch, dense, view, library, dims in _k14_case(gen, batch,
                                                                                         getattr(torch, dname), stream):
                    label = f"B={batch} {dname}{shape}"
                    for name, lib in libs.items():
                        tile = [lib["K14"].ln_proj_tile(*dims, i) for i in range(2)]
                        print(f"{label} {name} tile: " + (f"{tile[0]} x {tile[1]}" if tile[0] else "none (SIMT)"),
                              flush=True)
                    calls = {(name, kernel): (lambda lib=lib: launch(lib["K14"], dense)) for name, lib in libs.items()}
                    for name, lib in libs.items():  # every tile of each build that picks one: the same bits
                        if lib["K14"].ln_proj_tile(*dims, 0):
                            for tile, tname in enumerate(K14_TILES):
                                calls[(f"{name} {tname}", kernel)] = lambda lib=lib, tile=tile: launch(lib["K14"],
                                                                                                       dense, tile)
                    _compare(label, calls, {kernel: (ref,)})
                    same = torch.equal(launch(libs["tree"]["K14"], view), launch(libs["tree"]["K14"], dense))
                    print(f"{label} tree {kernel}: the transposed view's output {'equals' if same else 'DIFFERS FROM'} "
                          "the contiguous weight's bit for bit", flush=True)
                    if BITS_ONLY:
                        continue
                    calls[("tree", kernel + " view")] = lambda: launch(libs["tree"]["K14"], view)
                    calls[("library", "F.layer_norm + F.linear")] = library
                    _turns(label, calls, 10, 10 if batch == 1 else 1)
                    if batch == 8:
                        for (name, what), fn in calls.items():
                            print_split(f"{label} {name} {what} by pass", pass_split(fn))
                    torch.cuda.empty_cache()


def k13_ab(libs: dict) -> None:
    """K13 of every build beside the library composition and the tree's wrapper; then K11's host path."""
    gen = torch.Generator().manual_seed(16)
    stream = torch.cuda.current_stream().cuda_stream
    with torch.no_grad():
        for dname, cases in (("float32", K13_CASES), ("bfloat16", K13_BF16)):
            dtype = getattr(torch, dname)
            for bh, c, length, use_softmax in cases:
                q, k, v = (_rand(gen, dtype, bh, c, length, scale=1.0) for _ in range(3))
                t = (torch.rand(bh, 1, 1, generator=gen) + 0.5).to("cuda", dtype)
                ref = md.mdta_ref(q.float(), k.float(), v.float(), t.float(), use_softmax)
                label = f"{dname} ({bh}, {c}, {length}) {'softmax' if use_softmax else 'relu'}"
                calls = {(name, "K13"): (lambda lib=lib: lib["K13"].launch(q, k, v, t, use_softmax, stream))
                         for name, lib in libs.items()}
                for name, lib in libs.items():  # every tile of each build that picks one: the same bits
                    if isinstance(lib["K13"], _NewK13):
                        for tile, tname in enumerate(K13_TILES):
                            calls[(f"{name} {tname}", "K13")] = (
                                lambda lib=lib, tile=tile: lib["K13"].launch(q, k, v, t, use_softmax, stream, tile))
                _compare(label, calls, {"K13": (ref,)})
                if BITS_ONLY:
                    continue

                def library():
                    a = torch.bmm(F.normalize(q, dim=-1), F.normalize(k, dim=-1).transpose(1, 2)) * t
                    return torch.bmm(a.softmax(-1) if use_softmax else F.relu(a), v)

                calls = {key: fn for key, fn in calls.items() if " " not in key[0]}
                calls[("tree", "K13 wrapper")] = lambda: md.mdta_attention(q, k, v, t, use_softmax)
                calls[("library", "F.normalize + torch.bmm")] = library
                _turns(label, calls, 10, 10)
                for (name, what), fn in calls.items():
                    print_split(f"{label} {name} {what} by pass", pass_split(fn, 10))
                torch.cuda.empty_cache()
        if BITS_ONLY:
            return
        # per forward at B = 1: each shape's ms a call (the tree's wrapper, the library) times its calls
        for net, calls, use_softmax in (("Restormer", K13_RESTORMER, False), ("PromptIR", K13_PROMPTIR, True)):
            totals = [0.0, 0.0]
            for (bh, c, length), n in calls.items():
                q, k, v = (_rand(gen, torch.float32, bh, c, length, scale=1.0) for _ in range(3))
                t = (torch.rand(bh, 1, 1, generator=gen) + 0.5).to("cuda")
                a = md.mdta_attention(q, k, v, t, use_softmax)

                def library():
                    a = torch.bmm(F.normalize(q, dim=-1), F.normalize(k, dim=-1).transpose(1, 2)) * t
                    return torch.bmm(a.softmax(-1) if use_softmax else F.relu(a), v)

                if (a - library()).abs().max().item() > 1e-3 * max(1.0, a.abs().max().item()):
                    raise RuntimeError(f"K13 and the library differ at {(bh, c, length)}")
                ms = [_ms(lambda: md.mdta_attention(q, k, v, t, use_softmax)), _ms(library)]
                print(f"K13 {net} ({bh}, {c}, {length}) x {n}: wrapper {ms[0]:.4f}, library {ms[1]:.4f} ms a call",
                      flush=True)
                totals = [tot + n * m for tot, m in zip(totals, ms)]
            print(f"K13 per {net} forward (B = 1, fp32): {totals[0]:.3f} ms, library {totals[1]:.3f} ms", flush=True)
        wp._lib()  # built before the first timing
        for shift in (0, 4):
            x = _rand(gen, torch.float32, 1, 128, 128, C, scale=1.0)
            win = wp.window_partition_fused(x, WS, shift)
            n = 128 // WS

            def switched(src, reverse, x=x, shift=shift):  # the launch under a device context, the library looked up
                out = torch.empty(n * n, WS * WS, C, device="cuda") if not reverse else torch.empty_like(x)
                with torch.cuda.device(src.device):
                    return wp._launch(wp._lib(), src.contiguous(), out, 1, 128, 128, C, WS, shift, reverse,
                                      torch.cuda.current_stream().cuda_stream)

            calls = {
                ("K11", "partition"): lambda x=x, shift=shift: wp.window_partition_fused(x, WS, shift),
                ("K11 switched", "partition"): lambda x=x: switched(x, False),
                ("library", "partition permute().contiguous()"):
                    lambda x=x: x.view(1, n, WS, n, WS, C).permute(0, 1, 3, 2, 4, 5).contiguous(),
                ("library", "partition roll + permute().contiguous()"):
                    lambda x=x, shift=shift: torch.roll(x, (-shift, -shift), (1, 2)).view(1, n, WS, n, WS, C)
                    .permute(0, 1, 3, 2, 4, 5).contiguous(),
                ("K11", "reverse"): lambda win=win, shift=shift: wp.window_reverse_fused(win, WS, 128, 128, shift),
                ("K11 switched", "reverse"): lambda win=win: switched(win, True),
                ("library", "reverse permute().contiguous()"):
                    lambda win=win: win.view(1, n, n, WS, WS, C).permute(0, 1, 3, 2, 4, 5).contiguous(),
                ("library", "reverse permute().contiguous() + roll"):
                    lambda win=win, shift=shift: torch.roll(win.view(1, n, n, WS, WS, C).permute(0, 1, 3, 2, 4, 5)
                                                            .reshape(1, 128, 128, C), (shift, shift), (1, 2))}
            _turns(f"K11 B=1 shift={shift}", calls, 20, 10)
            for (name, what), fn in calls.items():
                print_split(f"K11 B=1 shift={shift} {name} {what} by pass", pass_split(fn, 10))


def main(argv: list[str]) -> int:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    global BITS_ONLY
    BITS_ONLY = "--bits" in argv
    mode = next((a for a in argv if a in BLOCK_MODES), None)
    dirs = {"tree": cuda_build.CSRC,
            **{a.split("=", 1)[0]: Path(a.split("=", 1)[1]) for a in argv if "=" in a}}
    kernels = BLOCK_MODES[mode] if mode else FORWARD
    with ThreadPoolExecutor(len(dirs)) as pool:
        libs = dict(zip(dirs, pool.map(lambda item: _build(*item, kernels), dirs.items())))
    torch.backends.cuda.matmul.allow_tf32 = False
    if mode == "--k14":
        k14_ab(libs)
    elif mode == "--k13":
        k13_ab(libs)
    elif mode:
        for kernel in kernels:
            block_ab(libs, kernel)
    else:
        forward_ab(libs)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
