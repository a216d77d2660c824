"""Drive the PyTorch/CUDA port (``dcpt_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1):

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel of the main paths from ``dcpt_tpu_torch/csrc`` (one
   nvcc per source, all started together);
3. kernel K1 (``naf_block_fused``) against its plain twin at the five
   NAFNet-w64 stage shapes of a 128 x 128 input at B = 2, plus two ragged
   shapes, in fp32 (and bf16 at C = 64 and 512), TF32 off for both;
4. the eval path: the shipped ``options/all_in_one/test/test_NAFNet_5d.yml``
   through the port's ``test_pipeline`` at full NAFNet-w64 width, on
   synthetic PNGs and seeded random weights, with the kernel's launch count
   checked and one image's output held against the plain path on the card;
5. kernel K2 (``naf_block_bwd``, the NAFBlock backward) against its plain
   version at the same stage and ragged shapes, fp32, and run twice to show
   it is deterministic;
6. kernel K3 (``layer_norm_2d``, forward and backward) against its plain
   version and against ``F.layer_norm`` at the classifier's five row shapes
   of a batch-8 step;
7. the training path: the shipped
   ``options/all_in_one/train/train_NAFNet_dcpt_5d.yml`` through the port's
   ``train_pipeline`` at full width, batch 8, gt_size 128, on synthetic
   160 x 160 PNGs: 4 iterations with a checkpoint, the launch counts of K1,
   K2 and K3 per step checked, a resume for 2 more; then one step's gradients
   through the kernels against the plain path's (``check_step_gradients``),
   and the ms per step and peak memory of both paths.

The line before the last is a JSON object with each kernel's launches, error,
times and bound; the last line is ``{"ok": true, "device": {...}}``.  Without a
CUDA device, or without the repository beside it, the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
YML = ROOT / "options" / "all_in_one" / "test" / "test_NAFNet_5d.yml"
TRAIN_YML = ROOT / "options" / "all_in_one" / "train" / "train_NAFNet_dcpt_5d.yml"
# name, source, the TPU kernel's public function it replaces
KERNELS = {
    "naf_block_fused": ("dcpt_tpu_torch/csrc/naf_block.cu", "dcpt_tpu/ops/naf_block.py:353"),
    "naf_block_bwd": ("dcpt_tpu_torch/csrc/naf_block_bwd.cu", "dcpt_tpu/ops/naf_block_bwd.py:255"),
    "layer_norm_2d": ("dcpt_tpu_torch/csrc/layernorm2d.cu", "dcpt_tpu/ops/layernorm2d.py:140"),
}
# the card's peaks (NVIDIA's H100 SXM data sheet): fp32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# NAFNet-w64 (enc [1,1,1,28], middle 1, dec [1,1,1,1]) on a 128 x 128 input:
# (C, H = W, NAFBlocks at that stage)
STAGES = [(64, 128, 2), (128, 64, 2), (256, 32, 2), (512, 16, 29), (1024, 8, 1)]
RAGGED = [(64, 24, 40), (1024, 1, 1)]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
K2_TOL = 1e-3  # relative to max(1, max|ref|): weight gradients sum up to 32 k pixels in another order
# the classifier's LayerNorms at K3's gate in a batch-8 step: (rows, C) -> calls per step
K3_SHAPES = {(8192, 512): 4, (2048, 1024): 4, (2048, 512): 2, (512, 1024): 4, (512, 512): 2}
TRAIN_ITERS, RESUME_ITERS = 4, 2
# per step of the DCPT yml's net: two forwards through all 36 NAFBlocks, a
# backward through 71 (decoder3.0's output feeds no 'ups' tap in the skip-tail pass)
K1_PER_STEP, K2_PER_STEP, K3_PER_STEP = 72, 71, sum(K3_SHAPES.values())
# each kernel's device functions by name (``colsum_kernel<N>`` is kernel N's fixed-order sum)
DEVICE_FUNCTIONS = {
    "naf_block_fused": {"naf_p1_kernel", "naf_sca_kernel", "naf_p2a_kernel", "naf_p2b_kernel", "naf_p2c_kernel"},
    "naf_block_bwd": {"bwd_f1_kernel", "bwd_prod_kernel", "bwd_a_kernel", "bwd_ln_kernel", "bwd_sca_kernel",
                      "bwd_sca_w_kernel", "bwd_d_kernel", "bwd_w_kernel", "colsum_kernel<2>"},
    "layer_norm_2d": {"ln_fwd_kernel", "ln_bwd_rows_kernel", "ln_bwd_cols_kernel", "colsum_kernel<3>"},
}
# the DCPT step on the network as it is: the kernel path's gradients against the
# plain path in float64, relative to each tensor's max|ref|.  fp32 rounding flips
# the classifier's switches, so the plain fp32 path itself misses by up to 2.3e-2
# (worst) and 6.3e-3 (median); the limits leave room above that and catch a fault
# of order one (readings in PERF.md, section 6).
REAL_GRAD_WORST, REAL_GRAD_MEDIAN = 1e-1, 2e-2


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def build_kernels() -> list[float]:
    """One nvcc per source, all started together; returns each build's seconds."""
    from concurrent.futures import ThreadPoolExecutor

    from dcpt_tpu_torch.ops import cuda_build

    libs = [(Path(src).stem, [Path(src).name]) for src, _ in KERNELS.values()]
    with ThreadPoolExecutor(len(libs)) as pool:
        built = list(pool.map(lambda lib: cuda_build.build_library(*lib), libs))
    for lib_path, _ in built:
        spills = [ln.strip() for ln in (lib_path.parent / "build.log").read_text().splitlines()
                  if "spill" in ln and not ln.strip().startswith("0 bytes stack frame, 0 bytes spill")]
        print(f"  {lib_path.name}: {len(spills)} kernels with spills or stack " + " ".join(spills[:3]))
    return [seconds for _, seconds in built]


def k1_work(c: int, pixels: int) -> tuple[float, float]:
    """(flops, bytes) of one K1 call: 6 C^2 multiply-adds per pixel in the 1x1
    products plus the depthwise 3x3 on 2C channels; x read, the weights read and
    z written once."""
    return pixels * (12 * c * c + 36 * c), 4 * (2 * pixels * c + 6 * c * c + 32 * c)


def k2_work(c: int, pixels: int) -> tuple[float, float]:
    """(flops, bytes) of one K2 call: 12 C^2 multiply-adds per pixel (products into
    pixel space and weight gradients) plus the two depthwise stencils; x, dz and
    the residuals (10 C per pixel) and the weights read, dx and the parameter
    gradients written once."""
    return pixels * (24 * c * c + 72 * c), 4 * (11 * pixels * c + 2 * (6 * c * c + 32 * c))


def k3_work(rows: int, c: int) -> tuple[float, float]:
    """(flops, bytes) of one LayerNorm forward plus backward, counting the bytes the
    function needs: x read and out written, then g and x read and gx written;
    1/sigma per row written and read; w and b read, gw and gb written.  K3's
    own y residual (rows x C written and read again) is not counted."""
    return 20 * rows * c, 4 * (5 * rows * c + 2 * rows + 5 * c)


def bound(calls) -> tuple[float, str]:
    """The least time for calls = [(count, flops, bytes)], each call bound by the
    larger of its operations over the fp32 peak and its bytes over the memory
    rate; and which of the two bounds most of that time."""
    ops = [n * f / PEAK_FP32_FLOPS * 1e3 for n, f, _ in calls]
    mem = [n * b / PEAK_BYTES_PER_S * 1e3 for n, _, b in calls]
    total = sum(max(o, m) for o, m in zip(ops, mem))
    by_ops = sum(o for o, m in zip(ops, mem) if o >= m)
    return total, "operations" if by_ops >= total / 2 else "bytes"


def random_block_params(c: int, gen, dtype, device):
    """NAFBlock parameters in the op's layout, drawn so the whole block body
    shows: beta, gamma and the norm affines are random, not their identity init."""
    import torch

    def r(*shape, scale=0.5, shift=0.0):
        return (torch.randn(*shape, generator=gen) * scale + shift).to(device=device, dtype=dtype)

    s = c ** -0.5
    return [r(c, shift=1.0), r(c), r(c, 2 * c, scale=s), r(2 * c), r(3, 3, 2 * c, scale=1 / 3), r(2 * c),
            r(c, c, scale=s), r(c), r(c, c, scale=s), r(c), r(c), r(c, shift=1.0), r(c), r(c, 2 * c, scale=s),
            r(2 * c), r(c, c, scale=s), r(c), r(c)]


def cuda_ms(fn, iters: int = 10) -> float:
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_id(key: str) -> str:
    """A device function's name from a profiler key: ``void (anonymous
    namespace)::colsum_kernel<2>(float const*, ...)`` -> ``colsum_kernel<2>``;
    template arguments are kept only for colsum, whose argument names its owner."""
    m = re.search(r"(\w+)(<[^()]*>)?\(", key)
    if m is None:
        return key
    return m.group(1) + (m.group(2) or "") if m.group(1) == "colsum_kernel" else m.group(1)


def device_ms_by_function(fn, iters: int) -> tuple[dict[str, float], float]:
    """Device ms per call of ``fn`` by device function (``kernel_id``), from
    torch.profiler over ``iters`` calls after one warm-up call, and the host
    clock's ms per call under the profiler; raises if the profiler records no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / iters
    times: dict[str, float] = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", getattr(evt, "self_cuda_time_total", 0))
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            name = kernel_id(evt.key)
            times[name] = times.get(name, 0.0) + us / 1e3 / iters
    if not times:
        raise RuntimeError("torch.profiler recorded no device time")
    return times, wall_ms


def check_k1() -> dict:
    """K1 against its plain twin on the card; returns per-forward totals."""
    import torch

    from dcpt_tpu_torch.ops.naf_block import _kernel_forward, naf_block_fused, naf_block_ref

    gen = torch.Generator().manual_seed(1)
    cases = [(c, s, s, "float32") for c, s, _ in STAGES] + [(c, h, w, "float32") for c, h, w in RAGGED]
    cases += [(64, 128, 128, "bfloat16"), (512, 16, 16, "bfloat16")]
    per_block = {}
    worst = {"float32": 0.0, "bfloat16": 0.0}
    print(f"  {'C':>5} {'H':>4} {'W':>4} {'dtype':>9} {'max_abs':>10} {'rel':>10} {'kernel_ms':>10} {'plain_ms':>10} "
          f"{'train_ms':>10}")
    for c, h, w, dname in cases:
        dtype = getattr(torch, dname)
        x = torch.randn(2, h, w, c, generator=gen).to(device="cuda", dtype=dtype)
        params = random_block_params(c, gen, dtype, "cuda")
        # the twin computes in fp32 on the same (rounded) inputs; the kernel's math is fp32 too
        xf, pf = x.float(), [p.float() for p in params]
        z = naf_block_fused(x, *params)
        ref = naf_block_ref(xf, *pf)
        torch.cuda.synchronize()
        if z.shape != x.shape or z.dtype != dtype or not torch.isfinite(z).all():
            raise RuntimeError(f"K1 C={c} {h}x{w} {dname}: bad output {z.shape} {z.dtype}")
        err = (z.float() - ref).abs().max().item()
        rel = err / max(1.0, ref.abs().max().item())
        k_ms = cuda_ms(lambda: naf_block_fused(x, *params))
        p_ms = cuda_ms(lambda: naf_block_ref(x, *params))
        # the differentiated forward, which also writes the residuals K2 reads (fp32 only)
        t_ms = cuda_ms(lambda: _kernel_forward(x, params, 1e-6, residuals=True)) if dname == "float32" else float("nan")
        print(f"  {c:>5} {h:>4} {w:>4} {dname:>9} {err:>10.3e} {rel:>10.3e} {k_ms:>10.4f} {p_ms:>10.4f} {t_ms:>10.4f}")
        if rel > TOL[dname]:
            raise RuntimeError(f"K1 C={c} {h}x{w} {dname}: error {rel:.3e} above {TOL[dname]:.0e}")
        worst[dname] = max(worst[dname], err)
        if dname == "float32":
            per_block[(c, h, w)] = (k_ms, p_ms)
    # one NAFNet-w64 forward at B = 2, 128 x 128: every stage's blocks
    ms = sum(n * per_block[(c, s, s)][0] for c, s, n in STAGES)
    plain_ms = sum(n * per_block[(c, s, s)][1] for c, s, n in STAGES)
    bound_ms, bound_by = bound([(n, *k1_work(c, 2 * s * s)) for c, s, n in STAGES])
    return {"max_abs_err": worst["float32"], "bf16_max_abs_err": worst["bfloat16"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def write_datasets(seed: int = 0) -> list[str]:
    """Two synthetic PNG pairs per dataset of the yml (128 x 128, and 120 x 72 to
    exercise the reflect pad), written with the port's codec; returns the
    --force_yml dataroot overrides."""
    import numpy as np

    from dcpt_tpu_torch.utils.img_util import imwrite
    from dcpt_tpu_torch.utils.options import yaml_load

    rng = np.random.default_rng(seed)
    force = []
    for key, ds in yaml_load(str(YML))["datasets"].items():
        gt_dir, lq_dir = WORK / "data" / key / "gt", WORK / "data" / key / "lq"
        for i, (h, w) in enumerate([(128, 128), (120, 72)]):
            yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
            base = 0.5 + 0.4 * np.sin(2 * np.pi * (rng.random(3) * 3 * yy[..., None] + rng.random(3) * 3 * xx[..., None]))
            gt = np.clip(base + rng.normal(0, 0.02, (h, w, 3)), 0, 1)
            imwrite((gt * 255).round().astype(np.uint8), str(gt_dir / f"img{i}.png"))
            if "dataroot_lq" in ds:
                lq = np.clip(0.8 * gt + 0.1 + rng.normal(0, 0.05, (h, w, 3)), 0, 1)
                name = f"img{i}_hazy.png" if ds["type"] == "PairedImageDehazeDataset" else f"img{i}.png"
                imwrite((lq * 255).round().astype(np.uint8), str(lq_dir / name))
        force.append(f"datasets:{key}:dataroot_gt={gt_dir}")
        if "dataroot_lq" in ds:
            force.append(f"datasets:{key}:dataroot_lq={lq_dir}")
    return force


def write_checkpoint(path: Path, seed: int = 0) -> None:
    """Seeded NAFNet-w64 weights of the yml's network_g, with beta, gamma and the
    LayerNorm affines drawn at random (at init every block is the identity)."""
    import torch

    from dcpt_tpu_torch.archs import build_network
    from dcpt_tpu_torch.utils.options import yaml_load

    torch.manual_seed(seed)
    net = build_network(yaml_load(str(YML))["network_g"])
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith(("beta", "gamma")) or ".norm" in name:
                shift = 1.0 if name.endswith(("norm1.weight", "norm2.weight")) else 0.0
                p.copy_(torch.randn(p.shape, generator=gen) * 0.5 + shift)
    torch.save({"params_ema": net.state_dict()}, path)


def _plain_block_forward(self, inp):
    """NAFBlock.forward with the plain twin in place of the kernel."""
    import torch

    from dcpt_tpu_torch.ops.naf_block import naf_block_ref

    x = inp.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
    return naf_block_ref(x, *self.op_args(), self.norm1.eps).permute(0, 3, 1, 2)


def images_per_s(model, lq, iters: int = 20) -> float:
    import torch

    model.lq = lq
    for _ in range(3):
        model.test()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        model.test()
    torch.cuda.synchronize()
    return iters * lq.shape[0] / (time.perf_counter() - t0)


def run_slice() -> None:
    """The shipped yml through the port's test_pipeline, then the kernel path
    against the plain path on one image, and the eval rate at 128 x 128."""
    import shutil

    import numpy as np
    import torch

    from dcpt_tpu_torch.archs.nafnet_arch import NAFBlock
    from dcpt_tpu_torch.data import build_dataloader, build_dataset
    from dcpt_tpu_torch.models import build_model
    from dcpt_tpu_torch.ops.naf_block import naf_block_fused
    from dcpt_tpu_torch.test import test_pipeline
    from dcpt_tpu_torch.utils.options import parse_options, yaml_load

    net_opt = yaml_load(str(YML))["network_g"]
    blocks = sum(net_opt["enc_blk_nums"]) + net_opt["middle_blk_num"] + sum(net_opt["dec_blk_nums"])
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    t0 = time.perf_counter()
    force = write_datasets()
    ckpt = WORK / "net.pth"
    write_checkpoint(ckpt)
    args = ["-opt", str(YML), "--force_yml", *force, f"path:pretrain_network_g={ckpt}"]
    print(f"[4] wrote 5 x 2 synthetic PNGs and seeded NAFNet-w64 weights in {time.perf_counter() - t0:.1f} s",
          flush=True)

    n_images = 10
    naf_block_fused.launches = 0
    t0 = time.perf_counter()
    results = test_pipeline(str(WORK), args=args)
    torch.cuda.synchronize()
    launches = naf_block_fused.launches
    print(f"[4] test_pipeline on {YML.name}: {time.perf_counter() - t0:.1f} s, "
          f"K1 launches {launches} for {n_images} forwards of {blocks} NAFBlocks", flush=True)
    for name, metrics in results.items():
        print(f"    {name}: " + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items()), flush=True)
    if set(results) != {"Rain100L", "CBSD68", "SOTS", "deblur", "LowLight"}:
        raise RuntimeError(f"datasets evaluated: {sorted(results)}")
    if not all(np.isfinite(v) for m in results.values() for v in m.values()):
        raise RuntimeError(f"non-finite metrics: {results}")
    if launches != blocks * n_images:
        raise RuntimeError(f"K1 ran {launches} times for {n_images} forwards, expected {blocks} per forward")

    opt, _ = parse_options(str(WORK), is_train=False, args=args)
    model = build_model(opt)
    rain = next(v for v in opt["datasets"].values() if v["name"] == "Rain100L")
    loader = build_dataloader(build_dataset(rain), rain)
    sample = next(s for s in loader if s["lq"].shape[-2:] == (120, 72))
    model.feed_data(sample)
    model.pre_test()
    model.test()
    kernel_out = model.output.clone()
    with mock.patch.object(NAFBlock, "forward", _plain_block_forward):
        model.test()
    plain_out = model.output
    if kernel_out.shape != (1, 3, 128, 80) or not torch.isfinite(kernel_out).all():
        raise RuntimeError(f"bad network output {tuple(kernel_out.shape)}")
    diff = (kernel_out - plain_out).abs().max().item()
    print(f"[4] one image (120x72, padded to 128x80): kernel path vs plain path max-abs {diff:.3e} "
          f"(limit 1e-3, fp32, TF32 off)", flush=True)
    if diff > 1e-3:
        raise RuntimeError(f"kernel path and plain path differ by {diff:.3e}")

    lq = torch.rand(1, 3, 128, 128, generator=torch.Generator().manual_seed(3)).cuda()
    torch.cuda.reset_peak_memory_stats()
    rate = images_per_s(model, lq)
    peak = torch.cuda.max_memory_allocated() / 2**20
    with mock.patch.object(NAFBlock, "forward", _plain_block_forward):
        plain_rate = images_per_s(model, lq)
    print(f"[4] eval forward at 128x128, batch 1, fp32: kernel path {rate:.2f} images/s "
          f"(peak {peak:.0f} MiB), plain path {plain_rate:.2f} images/s", flush=True)


def check_k2() -> dict:
    """K2 against its plain version at the stage and ragged shapes (B = 2, fp32),
    from K1's residuals; K2 run twice gives the same bits; per-backward totals."""
    import torch

    from dcpt_tpu_torch.ops.naf_block import _kernel_forward
    from dcpt_tpu_torch.ops.naf_block_bwd import naf_block_bwd, naf_block_bwd_ref

    gen = torch.Generator().manual_seed(5)
    per_block, worst = {}, 0.0
    print(f"  {'C':>5} {'H':>4} {'W':>4} {'max_abs':>10} {'rel':>10} {'kernel_ms':>10} {'plain_ms':>10}")
    for c, h, w in [(c, s, s) for c, s, _ in STAGES] + RAGGED:
        x = torch.randn(2, h, w, c, generator=gen).cuda()
        params = random_block_params(c, gen, torch.float32, "cuda")
        dz = torch.randn(x.shape, generator=gen).cuda()
        _, res = _kernel_forward(x, params, 1e-6, residuals=True)
        *maps, pooled, att = res
        got = naf_block_bwd(x, *params, pooled, att, dz, maps)
        ref = naf_block_bwd_ref(x, *params, pooled, att, dz)
        torch.cuda.synchronize()
        errs = [(a - b).abs().max().item() for a, b in zip(got, ref)]
        rels = [e / max(1.0, b.abs().max().item()) for e, b in zip(errs, ref)]
        if not all(torch.isfinite(a).all() for a in got) or max(rels) > K2_TOL:
            raise RuntimeError(f"K2 C={c} {h}x{w}: cotangent {rels.index(max(rels))} error {max(rels):.3e} "
                               f"above {K2_TOL:.0e}")
        if (c, h, w) == (256, 32, 32):
            again = naf_block_bwd(x, *params, pooled, att, dz, maps)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise RuntimeError("K2 is not deterministic: two runs on the same inputs differ")
        k_ms = cuda_ms(lambda: naf_block_bwd(x, *params, pooled, att, dz, maps))
        p_ms = cuda_ms(lambda: naf_block_bwd_ref(x, *params, pooled, att, dz))
        print(f"  {c:>5} {h:>4} {w:>4} {max(errs):>10.3e} {max(rels):>10.3e} {k_ms:>10.4f} {p_ms:>10.4f}", flush=True)
        worst = max(worst, max(errs))
        per_block[(c, h, w)] = (k_ms, p_ms)
    print("  K2 at C=256 32x32 twice: equal bit for bit", flush=True)
    # one backward through NAFNet-w64's 36 blocks at B = 2, 128 x 128
    bound_ms, bound_by = bound([(n, *k2_work(c, 2 * s * s)) for c, s, n in STAGES])
    return {"max_abs_err": worst, "ms": sum(n * per_block[(c, s, s)][0] for c, s, n in STAGES),
            "plain_ms": sum(n * per_block[(c, s, s)][1] for c, s, n in STAGES), "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def check_k3() -> dict:
    """K3 forward + backward against the plain versions and F.layer_norm at the
    classifier's row shapes; per-step totals (16 calls each way) of device time."""
    import torch
    import torch.nn.functional as F

    from dcpt_tpu_torch.ops import layernorm2d as ln

    gen = torch.Generator().manual_seed(6)
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    worst = 0.0
    print(f"  {'rows':>5} {'C':>5} {'calls':>5} {'rel_err':>10} {'lib_err':>10} {'kernel_ms':>10} {'plain_ms':>10} "
          f"{'library_ms':>10} {'bound_ms':>10}  (device ms per forward + backward, torch.profiler)")
    for (rows, c), calls in K3_SHAPES.items():
        x = (torch.randn(rows, c, generator=gen) * 2 + 0.5).cuda()
        w, b = torch.randn(c, generator=gen).cuda(), torch.randn(c, generator=gen).cuda()
        g = torch.randn(rows, c, generator=gen).cuda()
        lib = ln._lib()

        def kernel():
            out, y, rsig = ln._launch_fwd(lib, x, w, b, 1e-6, ln._stream(), residuals=True)
            return (out, *ln._launch_bwd(lib, g, y, rsig, w, ln._stream()))

        def plain():
            out, y, rsig = ln.layer_norm_2d_ref(x, w, b, 1e-6)
            return (out, *ln.layer_norm_2d_bwd_ref(g, y, rsig, w))

        xl, wl, bl = (t.clone().requires_grad_() for t in (x, w, b))

        def library():
            return (F.layer_norm(xl, (c,), wl, bl, 1e-6), *torch.autograd.grad(
                F.layer_norm(xl, (c,), wl, bl, 1e-6), (xl, wl, bl), g))

        got, ref, lib_out = kernel(), plain(), library()
        torch.cuda.synchronize()
        rel = max((a - r).abs().max().item() / max(1.0, r.abs().max().item()) for a, r in zip(got, ref))
        lib_rel = max((a - r).abs().max().item() / max(1.0, r.abs().max().item()) for a, r in zip(got, lib_out))
        if rel > 1e-4 or lib_rel > 1e-4:
            raise RuntimeError(f"K3 ({rows}, {c}): error {rel:.3e} against plain, {lib_rel:.3e} against F.layer_norm")
        # device time only: each call is a few microseconds of work behind tens of host overhead
        k_funcs = device_ms_by_function(kernel, 20)[0]
        if set(k_funcs) != DEVICE_FUNCTIONS["layer_norm_2d"]:
            raise RuntimeError(f"K3's profile shows {sorted(k_funcs)}, expected {sorted(DEVICE_FUNCTIONS['layer_norm_2d'])}")
        times = {"ms": sum(k_funcs.values()), "plain_ms": sum(device_ms_by_function(plain, 20)[0].values()),
                 "library_ms": sum(device_ms_by_function(library, 20)[0].values())}
        print(f"  {rows:>5} {c:>5} {calls:>5} {rel:>10.3e} {lib_rel:>10.3e} {times['ms']:>10.4f} "
              f"{times['plain_ms']:>10.4f} {times['library_ms']:>10.4f} {bound([(1, *k3_work(rows, c))])[0]:>10.4f}",
              flush=True)
        for k, v in times.items():
            totals[k] += calls * v
        worst = max(worst, max((a - r).abs().max().item() for a, r in zip(got, ref)))
    bound_ms, bound_by = bound([(n, *k3_work(rows, c)) for (rows, c), n in K3_SHAPES.items()])
    return dict(totals, max_abs_err=worst, bound_ms=bound_ms, bound_by=bound_by)


def write_train_sets(root: Path, n: int = 8, size: int = 160) -> list[str]:
    """n synthetic size x size PNGs (pairs where the dataset has an lq folder) per
    dataset of the train yml; returns the --force_yml dataroot overrides."""
    import numpy as np

    from dcpt_tpu_torch.utils.img_util import imwrite
    from dcpt_tpu_torch.utils.options import yaml_load

    rng = np.random.default_rng(7)
    force = []
    yy, xx = np.mgrid[0:size, 0:size] / size
    for key, ds in yaml_load(str(TRAIN_YML))["datasets"]["train"]["datasets"].items():
        gt_dir, lq_dir = root / key / "gt", root / key / "lq"
        for i in range(n):
            base = 0.5 + 0.4 * np.sin(2 * np.pi * (rng.random(3) * 3 * yy[..., None] + rng.random(3) * 3 * xx[..., None]))
            gt = np.clip(base + rng.normal(0, 0.02, (size, size, 3)), 0, 1)
            imwrite((gt * 255).round().astype(np.uint8), str(gt_dir / f"img{i}.png"))
            if "dataroot_lq" in ds:
                lq = np.clip(0.7 * gt + 0.15 + rng.normal(0, 0.05, gt.shape), 0, 1)
                name = f"img{i}_hazy.png" if ds["type"] == "PairedImageDehazeDataset" else f"img{i}.png"
                imwrite((lq * 255).round().astype(np.uint8), str(lq_dir / name))
        force.append(f"datasets:train:datasets:{key}:dataroot_gt={gt_dir}")
        if "dataroot_lq" in ds:
            force.append(f"datasets:train:datasets:{key}:dataroot_lq={lq_dir}")
    return force


def _plain_ln_forward(self, x):
    """LayerNorm2d.forward on the plain path, whatever the width."""
    from dcpt_tpu_torch.ops.naf_block import layer_norm_last

    return layer_norm_last(x.permute(0, 2, 3, 1), self.weight, self.bias, self.eps).permute(0, 3, 1, 2)


def plain_path():
    """Every NAFBlock and LayerNorm2d on plain PyTorch (autograd of the plain versions)."""
    from contextlib import ExitStack

    from dcpt_tpu_torch.archs.arch_util import LayerNorm2d
    from dcpt_tpu_torch.archs.nafnet_arch import NAFBlock

    stack = ExitStack()
    stack.enter_context(mock.patch.object(NAFBlock, "forward", _plain_block_forward))
    stack.enter_context(mock.patch.object(LayerNorm2d, "forward", _plain_ln_forward))
    return stack


def smooth_switches():
    """The classifier's ReLUs as GELUs and its max-pools as average pools: the
    same network without the switches that fp32 rounding flips."""
    from contextlib import ExitStack

    import torch.nn.functional as F
    from torch import nn

    stack = ExitStack()
    stack.enter_context(mock.patch.object(F, "relu", lambda x, inplace=False: F.gelu(x)))
    stack.enter_context(mock.patch.object(nn.MaxPool2d, "forward", lambda self, x: F.avg_pool2d(x, 2)))
    return stack


def check_step_gradients(model) -> None:
    """One DCPT step's gradients of net_g and net_dc on the same weights and batch:

    * with the classifier's switches smoothed (``smooth_switches``): the kernel
      path against the plain path in fp32, every gradient within 1e-3 of the
      tensor's max|ref|;
    * the network as it is: its ReLUs and max-pools flip on fp32 rounding, so
      neither fp32 path meets 1e-3 of the float64 plain path on every tensor,
      and which of the two is nearer changes from run to run.  Both paths'
      gradient errors against float64 are reported; the kernel path's losses
      must be within 1e-5 of the float64 ones, and its gradients' worst and
      median errors within ``REAL_GRAD_WORST`` and ``REAL_GRAD_MEDIAN``."""
    import statistics

    import torch

    gen = torch.Generator().manual_seed(8)
    gt = torch.rand(8, 3, 128, 128, generator=gen)
    batch = {"gt": gt, "lq": (0.7 * gt + 0.15 + 0.05 * torch.randn(gt.shape, generator=gen)).clamp(0, 1),
             "dataset_idx": torch.arange(8) % 5}
    nets = {"net_g": model.net_g, "net_dc": model.net_dc}

    def step_grads(dtype=torch.float32):
        for net in nets.values():
            net.to(dtype)
        model.feed_data({k: v.to(dtype) if v.is_floating_point() else v for k, v in batch.items()})
        losses = {k: v.item() for k, v in model.compute_gradients().items()}
        grads = {f"{k}.{n}": p.grad.double() for k, net in nets.items() for n, p in net.named_parameters()}
        for net in nets.values():
            net.float()
        return grads, losses

    def errs(a, b):
        return {n: ((a[n] - b[n]).abs().max() / b[n].abs().max().clamp_min(1e-30)).item() for n in b}

    def over(e):
        return sum(v > 1e-3 for v in e.values())

    with smooth_switches():
        kernel, _ = step_grads()
        with plain_path():
            plain, _ = step_grads()
    ks = errs(kernel, plain)
    ks_name = max(ks, key=ks.get)
    print(f"[7] smoothed classifier, {len(ks)} gradients of net_g and net_dc, kernel path against the plain path in "
          f"fp32, relative to the tensor's max|ref|: worst {ks[ks_name]:.3e} ({ks_name}; limit 1e-3), "
          f"{over(ks)} above 1e-3", flush=True)

    kernel, kernel_losses = step_grads()
    with plain_path():
        plain, _ = step_grads()
        ref, ref_losses = step_grads(torch.float64)
    model.feed_data(batch)
    k64, p64 = errs(kernel, ref), errs(plain, ref)
    k_med, p_med = statistics.median(k64.values()), statistics.median(p64.values())
    k_name, p_name = max(k64, key=k64.get), max(p64, key=p64.get)
    k_max, p_max = k64[k_name], p64[p_name]
    print(f"[7] the network as it is, {len(k64)} gradients against the plain path in float64: kernel path worst "
          f"{k_max:.3e} ({k_name}; limit {REAL_GRAD_WORST:.0e}), median {k_med:.3e} (limit {REAL_GRAD_MEDIAN:.0e}), "
          f"{over(k64)} above 1e-3; plain path in fp32 worst "
          f"{p_max:.3e} ({p_name}), median {p_med:.3e}, {over(p64)} above 1e-3; losses kernel {kernel_losses}, "
          f"float64 {ref_losses}", flush=True)
    if not ks[ks_name] <= 1e-3:
        raise RuntimeError(f"gradient {ks_name} through the kernels differs from the plain path by {ks[ks_name]:.3e}")
    loss_err = max(abs(kernel_losses[k] - v) / max(1.0, abs(v)) for k, v in ref_losses.items())
    if not loss_err <= 1e-5:
        raise RuntimeError(f"kernel path losses {kernel_losses} against float64 {ref_losses}")
    if not (k_max <= REAL_GRAD_WORST and k_med <= REAL_GRAD_MEDIAN):
        raise RuntimeError(f"kernel path gradients against float64: worst {k_max:.3e} ({k_name}), median "
                           f"{k_med:.3e}, limits {REAL_GRAD_WORST:.0e} and {REAL_GRAD_MEDIAN:.0e}")


def ms_per_step(model, iters: int) -> tuple[float, float]:
    """Host clock around ``iters`` optimizer steps ended by a synchronize, after one
    warm-up step; and the peak device memory of those steps in MiB."""
    import torch

    model.optimize_parameters(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(iters):
        model.optimize_parameters(0)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters, torch.cuda.max_memory_allocated() / 2**20


def step_profile(model, steps: int = 2) -> None:
    """Device time per DCPT step by kernel (its device functions by exact name,
    ``DEVICE_FUNCTIONS``) and for the rest, from torch.profiler over ``steps``
    steps, beside the host clock's step time: the device's busy share.  Raises if
    a device function of a kernel did not show."""
    times, wall_ms = device_ms_by_function(lambda: model.optimize_parameters(0), steps)
    device = {name: 0.0 for name in [*DEVICE_FUNCTIONS, "PyTorch (convs, classifier, optimizers)"]}
    for func, ms in times.items():
        owner = next((k for k, funcs in DEVICE_FUNCTIONS.items() if func in funcs),
                     "PyTorch (convs, classifier, optimizers)")
        device[owner] += ms
    missing = sorted(f for funcs in DEVICE_FUNCTIONS.values() for f in funcs if f not in times)
    if missing:
        raise RuntimeError(f"the step's profile shows no {missing}")
    busy = sum(device.values())
    parts = ", ".join(f"{g} {ms:.2f} ms" for g, ms in device.items())
    print(f"[7] profile per step (torch.profiler, {steps} steps): device {busy:.2f} ms of {wall_ms:.2f} ms wall "
          f"(busy {100 * busy / wall_ms:.1f} %): {parts}", flush=True)


def run_training() -> dict:
    """The shipped DCPT yml through train_pipeline at full width; launch counts per
    step; resume; one step's gradients through the kernels against the plain
    path's; ms per step and peak memory of both paths."""
    import shutil

    import numpy as np
    import torch

    from dcpt_tpu_torch.ops.layernorm2d import layer_norm_2d
    from dcpt_tpu_torch.ops.naf_block import naf_block_fused
    from dcpt_tpu_torch.ops.naf_block_bwd import naf_block_bwd
    from dcpt_tpu_torch.train import train_pipeline

    work = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    force = write_train_sets(work / "data")
    args = ["-opt", str(TRAIN_YML), "--force_yml", *force, "datasets:train:datasets:d3_dehaze:suffix=.png",
            "logger:use_tb_logger=false", "logger:print_freq=1", f"logger:save_checkpoint_freq={TRAIN_ITERS}",
            f"train:scheduler:periods=[{TRAIN_ITERS + RESUME_ITERS}]"]
    print(f"[7] wrote 5 x 8 synthetic 160x160 PNG sets in {time.perf_counter() - t0:.1f} s", flush=True)

    naf_block_fused.launches = naf_block_bwd.launches = layer_norm_2d.launches = layer_norm_2d.bwd_launches = 0
    t0 = time.perf_counter()
    model = train_pipeline(str(work), args=args + [f"train:total_iter={TRAIN_ITERS}"])
    torch.cuda.synchronize()
    launches = {"naf_block_fused": naf_block_fused.launches, "naf_block_bwd": naf_block_bwd.launches,
                "layer_norm_2d": layer_norm_2d.launches + layer_norm_2d.bwd_launches}
    print(f"[7] train_pipeline on {TRAIN_YML.name}, {TRAIN_ITERS} iterations at batch 8, gt_size 128: "
          f"{time.perf_counter() - t0:.1f} s; launches K1 {launches['naf_block_fused']}, K2 "
          f"{launches['naf_block_bwd']}, K3 {layer_norm_2d.launches} forward + {layer_norm_2d.bwd_launches} backward; "
          f"losses {dict(model.log_dict)}", flush=True)
    want = {"naf_block_fused": K1_PER_STEP * TRAIN_ITERS, "naf_block_bwd": K2_PER_STEP * TRAIN_ITERS,
            "layer_norm_2d": 2 * K3_PER_STEP * TRAIN_ITERS}
    if launches != want:
        raise RuntimeError(f"launches {launches}, expected {want} for {TRAIN_ITERS} steps")
    if not all(np.isfinite(v) for v in model.log_dict.values()) or set(model.log_dict) != {"l_pix", "l_classify"}:
        raise RuntimeError(f"bad losses {model.log_dict}")
    models_dir = work / "experiments" / "NAFNet_dcpt_5d_pretrain" / "models"
    if not (models_dir / f"net_g_{TRAIN_ITERS}.pth").exists():
        raise RuntimeError(f"no checkpoint at iteration {TRAIN_ITERS} in {models_dir}")

    resumed = train_pipeline(str(work), args=["--auto_resume", *args,
                                              f"train:total_iter={TRAIN_ITERS + RESUME_ITERS}"])
    steps = resumed.optimizer_g.state_dict()["state"][0]["step"].item()
    print(f"[7] resumed from iteration {TRAIN_ITERS} for {RESUME_ITERS} more: optimizer at step {steps:.0f}, losses "
          f"{dict(resumed.log_dict)}", flush=True)
    if steps != TRAIN_ITERS + RESUME_ITERS or not all(np.isfinite(v) for v in resumed.log_dict.values()):
        raise RuntimeError(f"resume: optimizer step {steps}, losses {resumed.log_dict}")

    check_step_gradients(resumed)
    step_profile(resumed)
    step_ms, peak = ms_per_step(resumed, 5)
    with plain_path():
        plain_step_ms, plain_peak = ms_per_step(resumed, 3)
    print(f"[7] DCPT step at batch 8, 128 x 128, fp32: kernel path {step_ms:.2f} ms/step (peak {peak:.0f} MiB), "
          f"plain path {plain_step_ms:.2f} ms/step (peak {plain_peak:.0f} MiB)", flush=True)
    return {"launches": launches, "step_ms": step_ms, "plain_step_ms": plain_step_ms}


def main() -> int:
    if not (ROOT / "dcpt_tpu_torch" / "__init__.py").exists():
        print("chip_smoke.py: the dcpt_tpu_torch package is not beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"[1] card: {card}", flush=True)
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    build_s = build_kernels()
    print(f"[2] built K1, K2, K3 in {', '.join(f'{b:.1f}' for b in build_s)} s (nvcc, in parallel), "
          f"phase {time.perf_counter() - t0:.1f} s", flush=True)

    print("[3] K1 naf_block_fused vs naf_block_ref, B=2, TF32 off", flush=True)
    k1 = check_k1()
    print(f"[3] K1 per NAFNet-w64 forward (B=2, 128x128, 36 blocks): kernel {k1['ms']:.3f} ms, "
          f"plain {k1['plain_ms']:.3f} ms, bound {k1['bound_ms']:.3f} ms ({k1['bound_by']})", flush=True)

    run_slice()

    print(f"[5] K2 naf_block_bwd vs naf_block_bwd_ref, B=2, fp32, limit {K2_TOL:.0e} relative", flush=True)
    k2 = check_k2()
    print(f"[5] K2 per NAFNet-w64 backward (B=2, 128x128, 36 blocks): kernel {k2['ms']:.3f} ms, "
          f"plain {k2['plain_ms']:.3f} ms, bound {k2['bound_ms']:.3f} ms ({k2['bound_by']})", flush=True)

    print("[6] K3 layer_norm_2d forward + backward vs plain and F.layer_norm, fp32, limit 1e-4", flush=True)
    k3 = check_k3()
    print(f"[6] K3 per DCPT step ({K3_PER_STEP} calls each way at batch 8): kernel {k3['ms']:.3f} ms, plain "
          f"{k3['plain_ms']:.3f} ms, F.layer_norm {k3['library_ms']:.3f} ms, bound {k3['bound_ms']:.3f} ms "
          f"({k3['bound_by']})", flush=True)

    train = run_training()

    kernels = []
    for name, measured in (("naf_block_fused", k1), ("naf_block_bwd", k2), ("layer_norm_2d", k3)):
        source, replaces = KERNELS[name]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": train["launches"][name], "max_abs_err": measured["max_abs_err"],
                        "ms": measured["ms"], "plain_ms": measured["plain_ms"], "bound_ms": measured["bound_ms"],
                        "bound_by": measured["bound_by"], "library_ms": measured["library_ms"]})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
