"""Drive the PyTorch/CUDA port (``dcpt_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1):

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel of the main path from ``dcpt_tpu_torch/csrc`` (nvcc);
3. kernel K1 (``naf_block_fused``) against its plain twin at the five
   NAFNet-w64 stage shapes of a 128 x 128 input at B = 2, plus two ragged
   shapes, in fp32 (and bf16 at C = 64 and 512), TF32 off for both;
4. the main path: the shipped ``options/all_in_one/test/test_NAFNet_5d.yml``
   through the port's ``test_pipeline`` at full NAFNet-w64 width, on
   synthetic PNGs and seeded random weights, with the kernel's launch count
   checked and one image's output held against the plain path on the card.

The line before the last is a JSON object with each kernel's launches, error
and times; the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or without the repository beside it, the script exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
YML = ROOT / "options" / "all_in_one" / "test" / "test_NAFNet_5d.yml"
K1_SOURCE = "dcpt_tpu_torch/csrc/naf_block.cu"
K1_REPLACES = "dcpt_tpu/ops/naf_block.py:353"
# NAFNet-w64 (enc [1,1,1,28], middle 1, dec [1,1,1,1]) on a 128 x 128 input:
# (C, H = W, NAFBlocks at that stage)
STAGES = [(64, 128, 2), (128, 64, 2), (256, 32, 2), (512, 16, 29), (1024, 8, 1)]
RAGGED = [(64, 24, 40), (1024, 1, 1)]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def build_kernels() -> float:
    from dcpt_tpu_torch.ops import cuda_build

    lib_path, seconds = cuda_build.build_library("naf_block", ["naf_block.cu"])
    report = [ln.strip() for ln in (lib_path.parent / "build.log").read_text().splitlines()
              if "registers" in ln or "spill" in ln]
    for ln in report:
        print("  ptxas:", ln)
    return seconds


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


def cuda_ms(fn, iters: int = 20) -> float:
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


def check_k1() -> dict:
    """K1 against its plain twin on the card; returns per-forward totals."""
    import torch

    from dcpt_tpu_torch.ops.naf_block import naf_block_fused, naf_block_ref

    gen = torch.Generator().manual_seed(1)
    cases = [(c, s, s, "float32") for c, s, _ in STAGES] + [(c, h, w, "float32") for c, h, w in RAGGED]
    cases += [(64, 128, 128, "bfloat16"), (512, 16, 16, "bfloat16")]
    per_block = {}
    worst = {"float32": 0.0, "bfloat16": 0.0}
    print(f"  {'C':>5} {'H':>4} {'W':>4} {'dtype':>9} {'max_abs':>10} {'rel':>10} {'kernel_ms':>10} {'plain_ms':>10}")
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
        print(f"  {c:>5} {h:>4} {w:>4} {dname:>9} {err:>10.3e} {rel:>10.3e} {k_ms:>10.4f} {p_ms:>10.4f}")
        if rel > TOL[dname]:
            raise RuntimeError(f"K1 C={c} {h}x{w} {dname}: error {rel:.3e} above {TOL[dname]:.0e}")
        worst[dname] = max(worst[dname], err)
        if dname == "float32":
            per_block[(c, h, w)] = (k_ms, p_ms)
    # one NAFNet-w64 forward at B = 2, 128 x 128: every stage's blocks
    ms = sum(n * per_block[(c, s, s)][0] for c, s, n in STAGES)
    plain_ms = sum(n * per_block[(c, s, s)][1] for c, s, n in STAGES)
    return {"max_abs_err": worst["float32"], "bf16_max_abs_err": worst["bfloat16"], "ms": ms, "plain_ms": plain_ms}


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


def run_slice() -> dict:
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
    return {"launches": launches, "images_per_s": rate, "plain_images_per_s": plain_rate}


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
    print(f"[2] built K1 in {build_s:.1f} s (nvcc), phase {time.perf_counter() - t0:.1f} s", flush=True)

    print("[3] K1 naf_block_fused vs naf_block_ref, B=2, TF32 off", flush=True)
    k1 = check_k1()
    print(f"[3] K1 per NAFNet-w64 forward (B=2, 128x128, 36 blocks): kernel {k1['ms']:.3f} ms, "
          f"plain {k1['plain_ms']:.3f} ms", flush=True)

    slice_out = run_slice()

    kernels = [{"name": "naf_block_fused", "route": "cuda", "source": K1_SOURCE, "replaces": K1_REPLACES,
                "launches": slice_out["launches"], "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
                "plain_ms": k1["plain_ms"]}]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
