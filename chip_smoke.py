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
   and the ms per step and peak memory of both paths;
8. kernel K6 (``mdta_block_fused``, the whole Restormer / PromptIR
   TransformerBlock) against its plain version at the Restormer stage shapes
   of a 128 x 128 input and PromptIR's three noise-level shapes (B = 1) in
   both flavours (ReLU / BiasFree / 1e-6 and softmax / WithBias / 1e-5), two
   ragged shapes, bf16 at C = 48 and 384, each run twice for equal bits; its
   ms per Restormer and per PromptIR forward beside the plain version's and the bound;
9. the eval paths of the shipped ``test_Restormer_5d.yml`` and
   ``test_PromptIR_5d.yml`` through ``test_pipeline`` at full width on the
   PNGs of [4] and seeded weights, with exactly 44 and 47 K6 launches per
   image, a ragged image's output held against the plain path on the card,
   each net's device time per forward by kernel, and the eval rates of both paths;
10. kernel K7 (``mdta_block_bwd``, the TransformerBlock backward) against its
   plain version from K6's residuals at the Restormer and PromptIR stage
   shapes of a 128 x 128 input (B = 2) in both flavours, PromptIR's three
   noise-level shapes, two ragged shapes and the two 128 x 128 stages at the
   train ymls' B = 8, fp32, TF32 off, each run twice for equal bits; its ms
   per Restormer and per PromptIR backward beside the plain version's and the bound;
11. the training paths of the shipped ``train_Restormer_dcpt_5d.yml`` and
   ``train_PromptIR_dcpt_5d.yml`` through ``train_pipeline`` at full width,
   batch 8, gt_size 128, on the PNGs of [7]: 4 iterations with a checkpoint,
   the launch counts of K6, K7 and K3 per step checked, a resume for 2 more;
   the step's device time by kernel, the ms per step and peak memory of both
   paths; every K7 call of a batch-8 step against its plain version on that
   call's inputs, and one step's gradients through the kernels against the
   plain path's;
12. kernels K8 (``fused_swin_block``, the whole SwinIR SwinTransformerBlock)
   and K10 (``fused_window_attention_ln``, its attention branch; and
   ``fused_window_attention`` without the LayerNorm) against their map-level
   plain versions at the shipped width (C 180, 6 heads, 8 x 8 windows): B = 1
   at 128 x 128 with shift 0 and 4, B = 2 at 120 x 72 with shift 4, fp32 (TF32
   off) and bf16, each run twice for equal bits; their ms per SwinIR forward
   (36 calls at 128 x 128) beside the plain versions' and the bound;
13. the eval path of the shipped ``test_SwinIR_5d.yml`` through
   ``test_pipeline`` at full width on the PNGs of [4] and seeded weights, with
   exactly 36 K8 launches per image, then again on the route that
   ``DCPT_TPU_SWIN_BLOCK=0`` selects (36 K10 launches per image, metrics as on
   the K8 route); a ragged image (118 x 70, padded to 120 x 72) through the K8
   path against the plain path and against the K10 route; the device time of
   a forward by kernel; and the eval rates of the K8, K10 and plain paths;
14. kernel K9 (``swin_block_bwd``, the Swin block backward, which recomputes
   the forward from x) against its plain version at the shipped width: B = 2
   at 128 x 128 with shift 0 and 4, B = 2 at 120 x 72 with shift 4 and B = 8
   at 128 x 128 with shift 4, fp32, TF32 off, each run twice for equal bits;
   its ms per SwinIR backward (36 calls at B = 2) beside the plain version's
   and the bound;
15. the training path of the shipped ``train_SwinIR_dcpt_5d.yml`` through
   ``train_pipeline`` at full width, batch 8, gt_size 128, on the PNGs of [7]:
   4 iterations saving every 2 with one training state kept, the launch
   counts of K8, K9 and K3 per step checked, a resume for 2 more; the step's
   device time by kernel; the ms per step and peak memory of the kernel path
   and the plain path (at the largest batch the plain path fits, with its
   OOM at batch 8 printed); every K9 call of a batch-8 step against its plain
   version on that call's inputs; one step's gradients through the kernels
   against the plain path's; one step on the ``DCPT_TPU_SWIN_BLOCK=0`` route
   (K10 launches counted, gradients against the K8 route's); then the ms per
   step of both paths again with cuDNN's algorithm timing on
   (``torch.backends.cudnn.benchmark``, which the port's ``train_pipeline``
   leaves off), printed as such: not the entry point's numbers.

On the H100 machines torch.profiler at times stops recording device time for
the rest of a process.  A phase whose profile records none then runs once more
in a fresh process on the same card, as do the phases after it
(``run_phase``); a profile there that records none fails the script.

The line before the last is a JSON object with each kernel's launches, error,
times and bound; the last line is ``{"ok": true, "device": {...}}``.  Without a
CUDA device, or without the repository beside it, the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import multiprocessing
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
    "mdta_block_fused": ("dcpt_tpu_torch/csrc/mdta_block.cu", "dcpt_tpu/ops/mdta_block.py:369"),
    "mdta_block_bwd": ("dcpt_tpu_torch/csrc/mdta_block_bwd.cu", "dcpt_tpu/ops/mdta_block_bwd.py:338"),
    "fused_swin_block": ("dcpt_tpu_torch/csrc/swin_block.cu", "dcpt_tpu/ops/window_attention.py:302"),
    "fused_window_attention": ("dcpt_tpu_torch/csrc/window_attention.cu", "dcpt_tpu/ops/window_attention.py:138"),
    "swin_block_bwd": ("dcpt_tpu_torch/csrc/swin_block_bwd.cu", "dcpt_tpu/ops/swin_block_bwd.py:159"),
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
K6_FUNCTIONS = {"mdta_qkv_kernel", "mdta_dw_kernel", "mdta_gram_kernel", "colsum_kernel<6>", "mdta_attn_kernel",
                "mdta_av_kernel", "mdta_proj_kernel", "mdta_ffn_in_kernel", "mdta_gate_kernel", "mdta_ffn_out_kernel"}
K7_FUNCTIONS = {"k7_gate_kernel", "k7_prod_kernel", "k7_dw_bwd_kernel", "ln_bwd_kernel<7>", "k7_dattn_kernel",
                "k7_cspace_kernel", "k7_dqkv_kernel", "wgrad_kernel<7>", "colsum_kernel<7>"}
# each kernel's device functions by name (``colsum_kernel<N>``, ``ln_bwd_kernel<N>`` and
# ``wgrad_kernel<N>`` are the shared passes as kernel N launches them)
DEVICE_FUNCTIONS = {
    "naf_block_fused": {"naf_p1_kernel", "naf_sca_kernel", "naf_p2a_kernel", "naf_p2b_kernel", "naf_p2c_kernel"},
    "naf_block_bwd": {"bwd_f1_kernel", "bwd_prod_kernel", "bwd_a_kernel", "bwd_ln_kernel", "bwd_sca_kernel",
                      "bwd_sca_w_kernel", "bwd_d_kernel", "bwd_w_kernel", "colsum_kernel<2>"},
    "layer_norm_2d": {"ln_fwd_kernel", "ln_bwd_rows_kernel", "ln_bwd_cols_kernel", "colsum_kernel<3>"},
    "mdta_block_fused": K6_FUNCTIONS,
    "mdta_block_bwd": K7_FUNCTIONS,
    "fused_swin_block": {"swin_block_kernel"},
    "fused_window_attention": {"window_attention_kernel"},
    "swin_block_bwd": {"k9_ln_kernel", "k9_prod_kernel", "k9_attn_fwd_kernel", "k9_attn_bwd_kernel",
                       "ln_bwd_kernel<9>", "wgrad_kernel<9>", "colsum_kernel<9>"},
}
# the DCPT step on the network as it is: each fp32 path's gradients against the
# plain path in float64, relative to each tensor's max|ref|.  fp32 rounding flips
# the probe's switches and Restormer's ReLU attention (tools/step_grad_noise.py),
# so neither fp32 path meets 1e-3 on every tensor.  The kernel path's worst and
# median error must stay within these limits or within three times the plain fp32
# path's own, whichever is larger (readings in PERF.md, section 6).
REAL_GRAD_WORST, REAL_GRAD_MEDIAN = 1e-1, 2e-2
TRANSFORMER_YMLS = {"Restormer": ROOT / "options" / "all_in_one" / "test" / "test_Restormer_5d.yml",
                    "PromptIR": ROOT / "options" / "all_in_one" / "test" / "test_PromptIR_5d.yml"}
# K6's flavours: (use_softmax, ln_bias, eps)
RESTORMER_FLAVOUR, PROMPTIR_FLAVOUR = (False, False, 1e-6), (True, True, 1e-5)
# the shipped Restormer / PromptIR body (dim 48, blocks [4, 6, 6, 8], 4 refinement,
# heads [1, 2, 4, 8]) on a 128 x 128 input: (C, H = W, heads) -> TransformerBlocks
# per forward (enc1; enc2 + dec2; enc3 + dec3; latent; dec1 + refinement)
K6_BODY = {(48, 128, 1): 4, (96, 64, 2): 12, (192, 32, 4): 12, (384, 16, 8): 8, (96, 128, 1): 8}
# PromptIR's noise_level3, 2, 1: 384 + 320, 192 + 128 and 96 + 64 channels at heads[2] = 4
K6_NOISE = {(704, 16, 4): 1, (320, 32, 4): 1, (160, 64, 4): 1}
K6_RAGGED = [(61, 41, 48, 1), (1, 1, 384, 8)]  # (H, W, C, heads)
K6_PER_FORWARD = {"Restormer": 44, "PromptIR": 47}
K7_TOL = 1e-3  # relative to max(1, max|ref|): weight gradients sum up to 32 k pixels in another order
# K6's ragged shapes, with a 3 x 2 map for its 1 x 1: on one pixel q / |q| is sign(q), so
# dq and dk are an exact cancellation of terms of size 1 / |q|, float noise in both versions
K7_RAGGED = [(61, 41, 48, 1), (3, 2, 384, 8)]  # (H, W, C, heads)
# the train ymls' batch (8 at 128 x 128) at the two 128 x 128 stages: four times the
# pixels of B = 2 in every partial sum (weight-gradient chunks, dattn chunks, taps)
K7_BATCH8 = [(48, 128, 1), (96, 128, 1)]
TRANSFORMER_TRAIN_YMLS = {"Restormer": ROOT / "options" / "all_in_one" / "train" / "train_Restormer_dcpt_5d.yml",
                          "PromptIR": ROOT / "options" / "all_in_one" / "train" / "train_PromptIR_dcpt_5d.yml"}
# launches per DCPT step at batch 8 (K3: forward + backward).  Restormer: 44 blocks in
# the full forward, 40 in the skip-tail pass (through decoder_level1), all
# differentiated; its probe's last stage has 4 LayerNorms at 768 channels.
# PromptIR: 47 + 39 forward (the skip-tail pass stops after noise_level1, whose
# output reaches no loss, so 85 backward); its probe's norms are 192 wide.
TRANSFORMER_PER_STEP = {"Restormer": {"mdta_block_fused": 84, "mdta_block_bwd": 84, "layer_norm_2d": 8},
                        "PromptIR": {"mdta_block_fused": 86, "mdta_block_bwd": 85, "layer_norm_2d": 0}}
# the transformer nets' plain step at batch 8 peaks at about 61 GB in fp32 (PERF.md), so
# the comparison with float64 runs at this batch (the fp32 comparisons at batch 8)
FLOAT64_GRAD_BATCH = 2
SWINIR_YML = ROOT / "options" / "all_in_one" / "test" / "test_SwinIR_5d.yml"
# the shipped SwinIR: embed 180, 6 heads of 30, 8 x 8 windows (64 tokens), mlp 2.0; six RSTBs
# of six blocks, every second block shifted by 4, so a 128 x 128 forward makes 18 calls at each shift
SWIN_C, SWIN_HEADS, SWIN_WS, SWIN_HIDDEN = 180, 6, 8, 360
SWIN_PER_FORWARD = 36
SWIN_CASES = [(1, 128, 128, 0), (1, 128, 128, 4), (2, 120, 72, 4)]  # (B, H, W, shift)
# a library call timed beside K8 / K10 is held to the plain version only to show that it
# computes the same function (a wrong weight layout is off by O(1)): nn.TransformerEncoderLayer's
# fused eval path reads 1.05e-4 in fp32 on the H100, against K8's 5e-7
LIBRARY_TOL = 1e-3
SWIN_TRAIN_YML = ROOT / "options" / "all_in_one" / "train" / "train_SwinIR_dcpt_5d.yml"
# (B, H, W, shift): a SwinIR backward's two shifts at B = 2, the ragged grid, the train yml's batch
K9_CASES = [(2, 128, 128, 0), (2, 128, 128, 4), (2, 120, 72, 4), (8, 128, 128, 4)]
K9_TOL = 1e-3  # relative to max(1, max|ref|), as K7: weight gradients sum over up to 131 k tokens in another order
# per DCPT step at batch 8: both passes run all 36 blocks forward (K8); the backward
# (K9) runs through the 36 of the gt pass and the 18 under the lq pass's encode_layers
# taps; the probe's norms are 180 wide, below K3's gate
SWIN_PER_STEP = {"fused_swin_block": 72, "swin_block_bwd": 54, "layer_norm_2d": 0}
# the float64 plain path of the SwinIR step keeps about 0.35 GB a block per image; this batch fits
SWIN_FLOAT64_BATCH = 1


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


def k6_work(c: int, f: int, ch: int, pixels: int) -> tuple[float, float]:
    """(flops, bytes) of one K6 call: per pixel the 1x1 products (3C^2 + C^2 +
    3FC multiply-adds), the head blocks of the Gram and v . attn^T (C ch each)
    and the depthwise 3x3 on 3C + 2F channels; x read, z written and the
    weights read once."""
    weights = 4 * c * c + 3 * f * c + 9 * (3 * c + 2 * f) + 4 * c + c // ch
    return pixels * (2 * (4 * c * c + 3 * f * c + 2 * c * ch) + 18 * (3 * c + 2 * f)), 4 * (2 * pixels * c + weights)


def k7_work(c: int, f: int, ch: int, pixels: int, batch: int) -> tuple[float, float]:
    """(flops, bytes) of one K7 call: per pixel the products into pixel space and
    the weight gradients (6FC + 8C^2 multiply-adds), dattn's head blocks and the
    products with dgram and attn (4 C ch), and the depthwise backward's stencil
    and tap sums on 3C + 2F channels; x, dz and the forward's maps (t, qkv, o, y,
    u, g: 8C + 3F) read and dx written once a pixel; per image the Gram's head
    blocks, attn and the norms read; the weights read and their gradients written once."""
    weights = 4 * c * c + 3 * f * c + 9 * (3 * c + 2 * f) + 4 * c + c // ch
    per_image = c * ch + c * c + 2 * c
    return (pixels * (2 * (6 * f * c + 8 * c * c + 4 * c * ch) + 36 * (3 * c + 2 * f)),
            4 * (pixels * (11 * c + 3 * f) + batch * per_image + 2 * weights))


def k8_work(c: int, hidden: int, tokens: int, pixels: int) -> tuple[float, float]:
    """(flops, bytes) of one K8 call: per pixel the products qkv, proj, fc1 and fc2
    (3C^2 + C^2 + 2 C hidden multiply-adds) and the window attention's q k^T and
    attn . v (2 N C, N tokens a window); x read, z written and the weights read once."""
    weights = 4 * c * c + 2 * c * hidden + 9 * c + hidden
    return pixels * 2 * (4 * c * c + 2 * c * hidden + 2 * tokens * c), 4 * (2 * pixels * c + weights)


def k10_work(c: int, tokens: int, pixels: int) -> tuple[float, float]:
    """(flops, bytes) of one K10 call with its LayerNorm: per pixel qkv and proj
    (4 C^2 multiply-adds) and the attention (2 N C); x read, the branch written
    and the weights read once."""
    return pixels * 2 * (4 * c * c + 2 * tokens * c), 4 * (2 * pixels * c + 4 * c * c + 6 * c)


def k9_work(c: int, hidden: int, tokens: int, pixels: int) -> tuple[float, float]:
    """(flops, bytes) of one K9 call: per pixel the recomputed forward up to fc1
    (4C^2 + C hidden + 2 N C multiply-adds: qkv, proj, fc1 and the attention; no
    fc2, whose output the backward does not read) and the backward: the products
    into token space (4C^2 + 2 C hidden), the weight gradients (the same) and
    the attention's dattn, dv, dq and dk (4 N C); x and dz read, dx written, the
    weights read and their gradients written once."""
    weights = 4 * c * c + 2 * c * hidden + 9 * c + hidden
    return pixels * 2 * (12 * c * c + 5 * c * hidden + 6 * tokens * c), 4 * (3 * pixels * c + 2 * weights)


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


# device functions shared by several kernels, their first template argument the owner's number
OWNED = ("colsum_kernel", "ln_bwd_kernel", "wgrad_kernel")


def kernel_id(key: str) -> str:
    """A device function's name from a profiler key: ``void (anonymous
    namespace)::wgrad_kernel<7, true>(float const*, ...)`` -> ``wgrad_kernel<7>``;
    template arguments are dropped but for the owner of a shared function (``OWNED``)."""
    m = re.search(r"(\w+)(<[^()]*>)?\(", key)
    if m is None:
        return key
    if m.group(1) in OWNED and m.group(2):
        return f"{m.group(1)}<{m.group(2)[1:-1].split(',')[0].strip()}>"
    return m.group(1)


class NoDeviceTime(RuntimeError):
    """torch.profiler recorded the host's calls but no device time."""


def device_ms_by_function(fn, iters: int) -> tuple[dict[str, float], float]:
    """Device ms per call of ``fn`` by device function (``kernel_id``), from
    torch.profiler over ``iters`` calls after one warm-up call, and the host
    clock's ms per call under the profiler; raises NoDeviceTime if the profiler
    records no device time."""
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
        seen = sorted({evt.key[:40] for evt in prof.key_averages()})[:8]
        raise NoDeviceTime(f"torch.profiler recorded no device time (its events: {seen})")
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


def run_slice() -> list[str]:
    """The shipped yml through the port's test_pipeline, then the kernel path
    against the plain path on one image, and the eval rate at 128 x 128;
    returns the --force_yml dataroot overrides of the synthetic PNGs."""
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
    return force


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
    """Every NAFBlock, TransformerBlock, SwinTransformerBlock and LayerNorm2d on plain
    PyTorch (autograd of the plain versions)."""
    from contextlib import ExitStack

    from dcpt_tpu_torch.archs.arch_util import LayerNorm2d
    from dcpt_tpu_torch.archs.nafnet_arch import NAFBlock
    from dcpt_tpu_torch.archs.restormer_arch import TransformerBlock
    from dcpt_tpu_torch.archs.swinir_arch import SwinTransformerBlock

    stack = ExitStack()
    stack.enter_context(mock.patch.object(NAFBlock, "forward", _plain_block_forward))
    stack.enter_context(mock.patch.object(TransformerBlock, "forward", _plain_transformer_forward))
    stack.enter_context(mock.patch.object(SwinTransformerBlock, "forward", _plain_swin_forward))
    stack.enter_context(mock.patch.object(LayerNorm2d, "forward", _plain_ln_forward))
    return stack


def smooth_switches(model):
    """The classifier's ReLUs as GELUs, its max-pools as average pools, and
    Restormer's ReLU attention as the softmax attention (both flavours run
    through K6 and K7): the same network without the switches that fp32
    rounding flips."""
    from contextlib import ExitStack

    import torch.nn.functional as F
    from torch import nn

    from dcpt_tpu_torch.archs.restormer_arch import MDTA

    stack = ExitStack()
    stack.enter_context(mock.patch.object(F, "relu", lambda x, inplace=False: F.gelu(x)))
    stack.enter_context(mock.patch.object(nn.MaxPool2d, "forward", lambda self, x: F.avg_pool2d(x, 2)))
    for attn in (m for m in model.net_g.modules() if isinstance(m, MDTA) and not m.use_softmax):
        attn.use_softmax = True
        stack.callback(setattr, attn, "use_softmax", False)
    return stack


def grad_batch(batch_size: int) -> dict:
    """A seeded DCPT batch of batch_size 128 x 128 images on the host."""
    import torch

    gen = torch.Generator().manual_seed(8)
    gt = torch.rand(batch_size, 3, 128, 128, generator=gen)
    return {"gt": gt, "lq": (0.7 * gt + 0.15 + 0.05 * torch.randn(gt.shape, generator=gen)).clamp(0, 1),
            "dataset_idx": torch.arange(batch_size) % 5}


def step_grads(model, batch, dtype=None):
    """One DCPT step's gradients of net_g and net_dc (float64, by name) and its
    losses, both nets and the batch in ``dtype`` (float32 when None)."""
    import torch

    dtype = dtype or torch.float32
    nets = {"net_g": model.net_g, "net_dc": model.net_dc}
    for net in nets.values():
        net.to(dtype)
    model.feed_data({k: v.to(dtype) if v.is_floating_point() else v for k, v in batch.items()})
    losses = {k: v.item() for k, v in model.compute_gradients().items()}
    # the parameters that no loss reaches (a probe level without a tap) keep no gradient
    grads = {f"{k}.{n}": p.grad.double() for k, net in nets.items() for n, p in net.named_parameters()
             if p.grad is not None}
    for net in nets.values():
        net.float()
    return grads, losses


def grad_errs(a, b) -> dict:
    """Each gradient's max-abs error relative to the tensor's max|ref|."""
    return {n: ((a[n] - b[n]).abs().max() / b[n].abs().max().clamp_min(1e-30)).item() for n in b}


def over_limit(got: dict, ref: dict, again: dict) -> tuple[dict, float]:
    """Each gradient's error against ``ref`` over its limit: 1e-3 of the tensor's
    max|ref|, plus 1e-6 of the step's largest gradient, plus three times the
    spread of ``again`` (``ref``'s path run once more) from ``ref``; and that
    largest gradient."""
    scale = max(g.abs().max().item() for g in ref.values())
    return {n: (got[n] - g).abs().max().item() / (1e-3 * g.abs().max().item() + 1e-6 * scale
                                                  + 3 * (again[n] - g).abs().max().item())
            for n, g in ref.items()}, scale


def check_step_gradients(model, label: str = "[7]", batch_size: int = 8, float64_batch: int = 8) -> None:
    """One DCPT step's gradients of net_g and net_dc on the same weights:

    * with the switches smoothed (``smooth_switches``), at ``batch_size``: the
      kernel path against the plain path in fp32, every gradient within 1e-3
      of the tensor's max|ref|, plus 1e-6 of the step's largest gradient (a
      sum's rounding scales with its terms, not with the sum, and a
      temperature's gradient cancels to a thousandth of them), plus three
      times the plain path's own spread from run to run (some of the step's
      PyTorch ops are not deterministic on the card);
    * the network as it is, at ``float64_batch``: its ReLUs (the probe's, and
      Restormer's attention) and max-pools flip on fp32 rounding, so neither
      fp32 path meets 1e-3 of the float64 plain path on every tensor, and which
      of the two is nearer changes from run to run.  Both paths' errors against
      float64 are reported; the kernel path's losses must be within 1e-5 of
      the float64 ones, and its gradients' worst and median error within
      ``REAL_GRAD_WORST`` and ``REAL_GRAD_MEDIAN`` or three times the plain
      fp32 path's own, whichever is larger."""
    import statistics

    import torch

    def over(e):
        return sum(v > 1e-3 for v in e.values())

    batch = grad_batch(batch_size)
    with smooth_switches(model):
        kernel, _ = step_grads(model, batch)
        with plain_path():
            plain, _ = step_grads(model, batch)
            again, _ = step_grads(model, batch)
    ks, scale = over_limit(kernel, plain, again)
    ks_name = max(ks, key=ks.get)
    rel = grad_errs(kernel, plain)
    print(f"{label} switches smoothed, batch {batch_size}, {len(ks)} gradients of net_g and net_dc, kernel path "
          f"against the plain path in fp32: worst {rel[ks_name]:.3e} of the tensor's max|ref| ({ks_name}), "
          f"{ks[ks_name]:.3f} of its limit; {over(rel)} above 1e-3 of max|ref|; plain path's own spread from run to "
          f"run worst {max(grad_errs(again, plain).values()):.3e}; largest gradient {scale:.3e}", flush=True)
    del kernel, plain, again
    torch.cuda.empty_cache()

    batch = grad_batch(float64_batch)
    kernel, kernel_losses = step_grads(model, batch)
    with plain_path():
        plain, _ = step_grads(model, batch)
        ref, ref_losses = step_grads(model, batch, torch.float64)
    model.feed_data(batch)
    k64, p64 = grad_errs(kernel, ref), grad_errs(plain, ref)
    k_med, p_med = statistics.median(k64.values()), statistics.median(p64.values())
    k_name, p_name = max(k64, key=k64.get), max(p64, key=p64.get)
    k_max, p_max = k64[k_name], p64[p_name]
    worst_limit, median_limit = max(REAL_GRAD_WORST, 3 * p_max), max(REAL_GRAD_MEDIAN, 3 * p_med)
    print(f"{label} the network as it is, batch {float64_batch}, {len(k64)} gradients against the plain path in "
          f"float64: kernel path worst {k_max:.3e} ({k_name}; limit {worst_limit:.3e}), median {k_med:.3e} (limit "
          f"{median_limit:.3e}), {over(k64)} above 1e-3; plain path in fp32 worst {p_max:.3e} ({p_name}), median "
          f"{p_med:.3e}, {over(p64)} above 1e-3; losses kernel {kernel_losses}, float64 {ref_losses}", flush=True)
    if not ks[ks_name] <= 1:
        raise RuntimeError(f"gradient {ks_name} through the kernels differs from the plain path by {rel[ks_name]:.3e} "
                           f"of its max|ref|, {ks[ks_name]:.3f} of its limit")
    loss_err = max(abs(kernel_losses[k] - v) / max(1.0, abs(v)) for k, v in ref_losses.items())
    if not loss_err <= 1e-5:
        raise RuntimeError(f"kernel path losses {kernel_losses} against float64 {ref_losses}")
    if not (k_max <= worst_limit and k_med <= median_limit):
        raise RuntimeError(f"kernel path gradients against float64: worst {k_max:.3e} ({k_name}), median "
                           f"{k_med:.3e}, limits {worst_limit:.3e} and {median_limit:.3e}")


def check_bwd_in_step(model, label: str, function, ref, tol: float, calls: int | None = None,
                      batch_size: int = 8) -> float:
    """One DCPT step at ``batch_size`` with every backward of the autograd
    ``function`` (K7's ``MDTABlockFunction``, K9's ``SwinBlockFunction``) held
    against its plain version ``ref(x, saved, dz, config)`` on that call's own
    inputs: the block's input and saved tensors, its configuration and the
    upstream dz of the real step, at the shapes and in the flavour the train yml
    gives them.  Limit ``tol`` relative to max(1, max|ref|) on each cotangent,
    and ``calls`` calls when given; returns the worst error."""
    import torch

    real_backward = function.backward
    errs = []

    def backward(ctx, dz):
        grads = real_backward(ctx, dz)
        x, *saved = ctx.saved_tensors
        want = ref(x, saved, dz.contiguous(), ctx.config)
        got = (grads[0], *grads[5:])
        errs.append((max((a - r).abs().max().item() / max(1.0, r.abs().max().item()) for a, r in zip(got, want)),
                     tuple(x.shape), tuple(ctx.config)))
        return grads

    with mock.patch.object(function, "backward", staticmethod(backward)):
        model.feed_data(grad_batch(batch_size))
        model.compute_gradients()
    torch.cuda.synchronize()
    worst, shape, config = max(errs)
    print(f"{label} {function.__name__} backward inside a DCPT step at batch {batch_size}: {len(errs)} calls, each "
          f"against its plain version on its own inputs: worst {worst:.3e} (at {shape}, config {config}; limit "
          f"{tol:.0e} relative to max(1, max|ref|))", flush=True)
    if (calls is not None and len(errs) != calls) or not worst <= tol:
        raise RuntimeError(f"{function.__name__} inside the step: {len(errs)} calls (expected {calls}), worst error "
                           f"{worst:.3e} at {shape} (limit {tol:.0e})")
    return worst


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


def step_profile(model, kernels: list[str], label: str = "[7]", steps: int = 2) -> dict:
    """Device time per DCPT step by kernel (its device functions by exact name,
    ``DEVICE_FUNCTIONS``) and for the rest, from torch.profiler over ``steps``
    steps, beside the host clock's step time: the device's busy share.  Raises if
    a device function of one of ``kernels`` did not show; returns ms by group."""
    times, wall_ms = device_ms_by_function(lambda: model.optimize_parameters(0), steps)
    device = {name: 0.0 for name in [*kernels, "PyTorch (convs, classifier, optimizers)"]}
    for func, ms in times.items():
        owner = next((k for k in kernels if func in DEVICE_FUNCTIONS[k]), "PyTorch (convs, classifier, optimizers)")
        device[owner] += ms
    missing = sorted(f for k in kernels for f in DEVICE_FUNCTIONS[k] if f not in times)
    if missing:
        raise RuntimeError(f"the step's profile shows no {missing}")
    busy = sum(device.values())
    parts = ", ".join(f"{g} {ms:.2f} ms" for g, ms in device.items())
    print(f"{label} profile per step (torch.profiler, {steps} steps): device {busy:.2f} ms of {wall_ms:.2f} ms wall "
          f"(busy {100 * busy / wall_ms:.1f} %): {parts}", flush=True)
    return device


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
    step_profile(resumed, ["naf_block_fused", "naf_block_bwd", "layer_norm_2d"])
    step_ms, peak = ms_per_step(resumed, 5)
    with plain_path():
        plain_step_ms, plain_peak = ms_per_step(resumed, 3)
    print(f"[7] DCPT step at batch 8, 128 x 128, fp32: kernel path {step_ms:.2f} ms/step (peak {peak:.0f} MiB), "
          f"plain path {plain_step_ms:.2f} ms/step (peak {plain_peak:.0f} MiB)", flush=True)
    return {"launches": launches, "step_ms": step_ms, "plain_step_ms": plain_step_ms, "force": force}

def mdta_params(c: int, heads: int, gen, dtype, device):
    """K6's parameters in the op's layout, F = int(2.66 C): weights of unit gain,
    random LayerNorm affines and temperatures.  Each weight is drawn in
    PyTorch's layout and passed as the op-layout view a module passes, so the
    wrapper copies nothing, as on the nets' path."""
    import torch

    def r(*shape, scale=0.3, shift=0.0):
        return (torch.randn(*shape, generator=gen) * scale + shift).to(device=device, dtype=dtype)

    f = int(c * 2.66)
    return [r(c, shift=1.0), r(c), r(3 * c, c, scale=c ** -0.5).t(), r(3 * c, 3, 3, scale=1 / 3).permute(1, 2, 0),
            r(heads, 1, 1, shift=1.0), r(c, c, scale=c ** -0.5).t(), r(c, shift=1.0), r(c),
            r(2 * f, c, scale=c ** -0.5).t(), r(2 * f, 3, 3, scale=1 / 3).permute(1, 2, 0), r(c, f, scale=f ** -0.5).t()]


def check_k6() -> dict:
    """K6 against its plain version on the card at the stage, noise-level and
    ragged shapes in both flavours (B = 1), each call twice for equal bits;
    totals per Restormer and per PromptIR forward at 128 x 128: device time
    (``ms``, ``plain_ms``) and CUDA events around back-to-back calls (``call_ms``)."""
    import torch

    from dcpt_tpu_torch.ops.mdta_block import mdta_block_fused, mdta_block_ref

    gen = torch.Generator().manual_seed(9)
    names = {RESTORMER_FLAVOUR: "relu", PROMPTIR_FLAVOUR: "softmax"}
    cases = [(s, s, c, heads, RESTORMER_FLAVOUR, "float32") for c, s, heads in K6_BODY]
    cases += [(s, s, c, heads, PROMPTIR_FLAVOUR, "float32") for c, s, heads in [*K6_BODY, *K6_NOISE]]
    cases += [(h, w, c, heads, fl, "float32") for h, w, c, heads in K6_RAGGED for fl in names]
    cases += [(s, s, c, heads, fl, "bfloat16") for c, s, heads in [(48, 128, 1), (384, 16, 8)] for fl in names]
    times, worst = {}, {"float32": 0.0, "bfloat16": 0.0}
    print(f"  {'C':>4} {'H':>4} {'W':>4} {'heads':>5} {'act':>7} {'dtype':>9} {'max_abs':>10} {'rel':>10} "
          f"{'kernel_ms':>10} {'plain_ms':>10} {'call_ms':>10} {'plain_call':>10} {'bound_ms':>10}  (kernel_ms, "
          f"plain_ms: device time per call, torch.profiler; call_ms: CUDA events around back-to-back calls)")
    with torch.no_grad():
        for h, w, c, heads, flavour, dname in cases:
            dtype = getattr(torch, dname)
            x = torch.randn(1, h, w, c, generator=gen).to(device="cuda", dtype=dtype)
            params = mdta_params(c, heads, gen, dtype, "cuda")
            z = mdta_block_fused(x, *params, heads, *flavour)
            again = mdta_block_fused(x, *params, heads, *flavour)
            # the plain version computes in fp32 on the same (rounded) inputs; the kernel's math is fp32 too
            ref = mdta_block_ref(x.float(), *[p.float() for p in params], heads, *flavour)
            torch.cuda.synchronize()
            if z.shape != x.shape or z.dtype != dtype or not torch.isfinite(z).all():
                raise RuntimeError(f"K6 C={c} {h}x{w} {dname}: bad output {tuple(z.shape)} {z.dtype}")
            if not torch.equal(z, again):
                raise RuntimeError(f"K6 C={c} {h}x{w} {dname}: two runs on the same inputs differ")
            err = (z.float() - ref).abs().max().item()
            rel = err / max(1.0, ref.abs().max().item())
            kernel = lambda: mdta_block_fused(x, *params, heads, *flavour)  # noqa: E731
            plain = lambda: mdta_block_ref(x, *params, heads, *flavour)  # noqa: E731
            # each call is a few hundred microseconds of host work (allocations, a dozen launches),
            # so CUDA events around back-to-back calls can measure the host: time the device too
            k_funcs = device_ms_by_function(kernel, 10)[0]
            if set(k_funcs) != K6_FUNCTIONS:
                raise RuntimeError(f"K6's profile shows {sorted(k_funcs)}, expected {sorted(K6_FUNCTIONS)}")
            k_ms, p_ms = sum(k_funcs.values()), sum(device_ms_by_function(plain, 10)[0].values())
            k_call, p_call = cuda_ms(kernel), cuda_ms(plain)
            b_ms = bound([(1, *k6_work(c, int(2.66 * c), c // heads, h * w))])[0]
            print(f"  {c:>4} {h:>4} {w:>4} {heads:>5} {names[flavour]:>7} {dname:>9} {err:>10.3e} {rel:>10.3e} "
                  f"{k_ms:>10.4f} {p_ms:>10.4f} {k_call:>10.4f} {p_call:>10.4f} {b_ms:>10.4f}", flush=True)
            if rel > TOL[dname]:
                raise RuntimeError(f"K6 C={c} {h}x{w} {names[flavour]} {dname}: error {rel:.3e} above {TOL[dname]:.0e}")
            worst[dname] = max(worst[dname], rel)
            if dname == "float32" and h == w:
                times[(c, h, heads, flavour)] = (k_ms, p_ms, k_call, p_call)
    print("  K6 twice on the same inputs: equal bit for bit at every shape", flush=True)
    per_net = {"Restormer": [(n, key, RESTORMER_FLAVOUR) for key, n in K6_BODY.items()],
               "PromptIR": [(n, key, PROMPTIR_FLAVOUR) for key, n in [*K6_BODY.items(), *K6_NOISE.items()]]}
    out = {"max_abs_err": worst["float32"], "bf16_rel_err": worst["bfloat16"], "library_ms": None}
    for net, blocks in per_net.items():
        bound_ms, bound_by = bound([(n, *k6_work(c, int(2.66 * c), c // heads, s * s)) for n, (c, s, heads), _ in blocks])
        ms, plain_ms, call_ms, plain_call_ms = (sum(n * times[(*key, fl)][i] for n, key, fl in blocks)
                                                for i in range(4))
        prefix = "" if net == "Restormer" else "promptir_"
        out.update({f"{prefix}ms": ms, f"{prefix}plain_ms": plain_ms, f"{prefix}call_ms": call_ms,
                    f"{prefix}plain_call_ms": plain_call_ms, f"{prefix}bound_ms": bound_ms,
                    f"{prefix}bound_by": bound_by})
    return out


def write_transformer_checkpoint(yml: Path, path: Path, seed: int) -> None:
    """Seeded full-width weights of the yml's network_g (Restormer, PromptIR,
    SwinIR), with random LayerNorm affines (all but SwinIR's final ``norm``) and
    temperatures, saved under params_ema with the reference's keys."""
    import torch

    from dcpt_tpu_torch.archs import build_network
    from dcpt_tpu_torch.utils.options import yaml_load

    torch.manual_seed(seed)
    net = build_network(yaml_load(str(yml))["network_g"])
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if ".norm" in name or name.endswith("temperature"):
                p.copy_(torch.rand(p.shape, generator=gen) + 0.5 if name.endswith(("weight", "temperature"))
                        else torch.randn(p.shape, generator=gen) * 0.3)
    torch.save({"params_ema": net.state_dict()}, path)


def _plain_transformer_forward(self, inp):
    """TransformerBlock.forward (PromptTransformerBlock's too) with K6's plain version."""
    import torch

    from dcpt_tpu_torch.ops.mdta_block import mdta_block_ref

    x = inp.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
    return mdta_block_ref(x, *self.op_args(), self.attn.num_heads, self.attn.use_softmax, self.norm1.with_bias,
                          self.norm1.eps).permute(0, 3, 1, 2)


def run_transformer_slices(force: list[str]) -> dict:
    """Both shipped transformer eval ymls through test_pipeline at full width on
    the PNGs of [4]; per net: K6 launches per image, a ragged image against the
    plain path, device time per forward by kernel, eval rates of both paths."""
    import numpy as np
    import torch

    from dcpt_tpu_torch.archs.restormer_arch import TransformerBlock
    from dcpt_tpu_torch.models import build_model
    from dcpt_tpu_torch.ops.mdta_block import mdta_block_fused
    from dcpt_tpu_torch.test import test_pipeline
    from dcpt_tpu_torch.utils.options import parse_options

    n_images, launches = 10, {}
    for seed, (arch, yml) in enumerate(TRANSFORMER_YMLS.items()):
        ckpt = WORK / f"{arch}.pth"
        write_transformer_checkpoint(yml, ckpt, seed=10 + seed)
        args = ["-opt", str(yml), "--force_yml", *force, f"path:pretrain_network_g={ckpt}"]
        mdta_block_fused.launches = 0
        t0 = time.perf_counter()
        results = test_pipeline(str(WORK / arch), args=args)
        torch.cuda.synchronize()
        launches[arch] = mdta_block_fused.launches
        print(f"[9] test_pipeline on {yml.name}: {time.perf_counter() - t0:.1f} s, K6 launches {launches[arch]} for "
              f"{n_images} forwards ({K6_PER_FORWARD[arch]} TransformerBlocks each)", flush=True)
        for name, metrics in results.items():
            print(f"    {name}: " + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items()), flush=True)
        if set(results) != {"Rain100L", "CBSD68", "SOTS", "deblur", "LowLight"}:
            raise RuntimeError(f"{arch}: datasets evaluated: {sorted(results)}")
        if not all(np.isfinite(v) for m in results.values() for v in m.values()):
            raise RuntimeError(f"{arch}: non-finite metrics: {results}")
        if launches[arch] != K6_PER_FORWARD[arch] * n_images:
            raise RuntimeError(f"{arch}: K6 ran {launches[arch]} times for {n_images} forwards, expected "
                               f"{K6_PER_FORWARD[arch]} per forward")

        opt, _ = parse_options(str(WORK / arch), is_train=False, args=args)
        model = build_model(opt)
        gen = torch.Generator().manual_seed(11)
        model.feed_data({"lq": torch.rand(1, 3, 118, 70, generator=gen)})
        model.pre_test()
        model.test()
        kernel_out = model.output.clone()
        with mock.patch.object(TransformerBlock, "forward", _plain_transformer_forward):
            model.test()
        plain_out = model.output
        if kernel_out.shape != (1, 3, 120, 72) or not torch.isfinite(kernel_out).all():
            raise RuntimeError(f"{arch}: bad network output {tuple(kernel_out.shape)}")
        rel = (kernel_out - plain_out).abs().max().item() / max(1.0, plain_out.abs().max().item())
        print(f"[9] {arch}, one image (118x70, padded to 120x72, latent 15x9): kernel path vs plain path "
              f"{rel:.3e} relative to max(1, max|plain|) (limit 1e-4, fp32, TF32 off)", flush=True)
        if rel > 1e-4:
            raise RuntimeError(f"{arch}: kernel path and plain path differ by {rel:.3e}")

        lq = torch.rand(1, 3, 128, 128, generator=gen).cuda()
        model.lq = lq
        funcs, wall_ms = device_ms_by_function(model.test, 5)
        missing = sorted(K6_FUNCTIONS - set(funcs))
        if missing:
            raise RuntimeError(f"{arch}: the forward's profile shows no {missing}")
        k6_ms = sum(ms for f, ms in funcs.items() if f in K6_FUNCTIONS)
        other_ms = sum(ms for f, ms in funcs.items() if f not in K6_FUNCTIONS)
        top = sorted(((ms, f) for f, ms in funcs.items() if f in K6_FUNCTIONS), reverse=True)[:4]
        print(f"[9] {arch} forward at 128x128 (torch.profiler, 5 forwards): device {k6_ms + other_ms:.2f} ms of "
              f"{wall_ms:.2f} ms wall (busy {100 * (k6_ms + other_ms) / wall_ms:.1f} %): K6 {k6_ms:.2f} ms ("
              + ", ".join(f"{f} {ms:.2f}" for ms, f in top) + f"), PyTorch (convs, shuffles, prompts) {other_ms:.2f} ms",
              flush=True)
        torch.cuda.reset_peak_memory_stats()
        rate = images_per_s(model, lq)
        peak = torch.cuda.max_memory_allocated() / 2**20
        with mock.patch.object(TransformerBlock, "forward", _plain_transformer_forward):
            plain_rate = images_per_s(model, lq)
        print(f"[9] {arch} eval forward at 128x128, batch 1, fp32: kernel path {rate:.2f} images/s (peak {peak:.0f} "
              f"MiB), plain path {plain_rate:.2f} images/s", flush=True)
    return {arch: n // n_images for arch, n in launches.items()}


def check_k7() -> dict:
    """K7 against its plain version on the card from K6's residuals (B = 2, fp32)
    at the Restormer and PromptIR stage shapes in both flavours, the noise-level
    and ragged shapes, and at B = 8 at the 128 x 128 stages, each call twice for
    equal bits; totals (from the B = 2 calls) per Restormer and
    per PromptIR backward at 128 x 128: device time (``ms``, ``plain_ms``) and
    CUDA events around back-to-back calls (``call_ms``)."""
    import torch

    from dcpt_tpu_torch.ops.mdta_block import _kernel_forward
    from dcpt_tpu_torch.ops.mdta_block_bwd import mdta_block_bwd, mdta_block_bwd_ref

    gen = torch.Generator().manual_seed(12)
    names = {RESTORMER_FLAVOUR: "relu", PROMPTIR_FLAVOUR: "softmax"}
    cases = [(s, s, c, heads, fl) for fl in names for c, s, heads in K6_BODY]
    cases += [(s, s, c, heads, PROMPTIR_FLAVOUR) for c, s, heads in K6_NOISE]
    cases += [(h, w, c, heads, fl) for h, w, c, heads in K7_RAGGED for fl in names]
    cases = [(2, *case) for case in cases] + [(8, s, s, c, heads, fl) for c, s, heads in K7_BATCH8 for fl in names]
    times, worst = {}, 0.0
    print(f"  {'B':>2} {'C':>4} {'H':>4} {'W':>4} {'heads':>5} {'act':>7} {'max_abs':>10} {'rel':>10} {'kernel_ms':>10} "
          f"{'plain_ms':>10} {'call_ms':>10} {'plain_call':>10} {'bound_ms':>10}  (kernel_ms, plain_ms: device time "
          f"per call, torch.profiler; call_ms: CUDA events around back-to-back calls)")
    for batch, h, w, c, heads, flavour in cases:
        x = torch.randn(batch, h, w, c, generator=gen).cuda()
        params = mdta_params(c, heads, gen, torch.float32, "cuda")
        dz = torch.randn(x.shape, generator=gen).cuda()
        _, res = _kernel_forward(x, params, heads, *flavour, residuals=True)
        got = mdta_block_bwd(x, *params, dz, res, heads, *flavour)
        again = mdta_block_bwd(x, *params, dz, res, heads, *flavour)
        ref = mdta_block_bwd_ref(x, *params, *res[:4], dz, heads, *flavour)
        torch.cuda.synchronize()
        if not all(a.shape == r.shape and torch.isfinite(a).all() for a, r in zip(got, ref)):
            raise RuntimeError(f"K7 B={batch} C={c} {h}x{w}: bad cotangents {[tuple(a.shape) for a in got]}")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise RuntimeError(f"K7 B={batch} C={c} {h}x{w} {names[flavour]}: two runs on the same inputs differ")
        errs = [(a - r).abs().max().item() for a, r in zip(got, ref)]
        rels = [e / max(1.0, r.abs().max().item()) for e, r in zip(errs, ref)]
        kernel = lambda: mdta_block_bwd(x, *params, dz, res, heads, *flavour)  # noqa: E731
        plain = lambda: mdta_block_bwd_ref(x, *params, *res[:4], dz, heads, *flavour)  # noqa: E731
        k_funcs = device_ms_by_function(kernel, 10)[0]
        if set(k_funcs) != K7_FUNCTIONS:
            raise RuntimeError(f"K7's profile shows {sorted(k_funcs)}, expected {sorted(K7_FUNCTIONS)}")
        k_ms, p_ms = sum(k_funcs.values()), sum(device_ms_by_function(plain, 10)[0].values())
        k_call, p_call = cuda_ms(kernel), cuda_ms(plain)
        b_ms = bound([(1, *k7_work(c, int(2.66 * c), c // heads, batch * h * w, batch))])[0]
        print(f"  {batch:>2} {c:>4} {h:>4} {w:>4} {heads:>5} {names[flavour]:>7} {max(errs):>10.3e} {max(rels):>10.3e} "
              f"{k_ms:>10.4f} {p_ms:>10.4f} {k_call:>10.4f} {p_call:>10.4f} {b_ms:>10.4f}", flush=True)
        if max(rels) > K7_TOL:
            raise RuntimeError(f"K7 B={batch} C={c} {h}x{w} {names[flavour]}: cotangent {rels.index(max(rels))} "
                               f"error {max(rels):.3e} above {K7_TOL:.0e}")
        worst = max(worst, max(errs))
        if h == w and batch == 2:
            times[(c, h, heads, flavour)] = (k_ms, p_ms, k_call, p_call)
    print("  K7 twice on the same inputs: equal bit for bit at every shape", flush=True)
    per_net = {"Restormer": [(n, key, RESTORMER_FLAVOUR) for key, n in K6_BODY.items()],
               "PromptIR": [(n, key, PROMPTIR_FLAVOUR) for key, n in [*K6_BODY.items(), *K6_NOISE.items()]]}
    out = {"max_abs_err": worst, "library_ms": None}
    for net, blocks in per_net.items():
        bound_ms, bound_by = bound([(n, *k7_work(c, int(2.66 * c), c // heads, 2 * s * s, 2))
                                    for n, (c, s, heads), _ in blocks])
        ms, plain_ms, call_ms, plain_call_ms = (sum(n * times[(*key, fl)][i] for n, key, fl in blocks)
                                                for i in range(4))
        prefix = "" if net == "Restormer" else "promptir_"
        out.update({f"{prefix}ms": ms, f"{prefix}plain_ms": plain_ms, f"{prefix}call_ms": call_ms,
                    f"{prefix}plain_call_ms": plain_call_ms, f"{prefix}bound_ms": bound_ms,
                    f"{prefix}bound_by": bound_by})
    return out


def run_transformer_training(force: list[str]) -> dict:
    """Both transformer DCPT ymls through train_pipeline at full width on the PNGs
    of [7]; per net: launches per step, resume, one step's gradients through the
    kernels against the plain path's, the step's profile, and the ms per step and
    peak memory of both paths."""
    import shutil

    import numpy as np
    import torch

    from dcpt_tpu_torch.ops.layernorm2d import layer_norm_2d
    from dcpt_tpu_torch.ops.mdta_block import MDTABlockFunction, mdta_block_fused
    from dcpt_tpu_torch.ops.mdta_block_bwd import mdta_block_bwd, mdta_block_bwd_ref
    from dcpt_tpu_torch.train import train_pipeline
    from dcpt_tpu_torch.utils.options import yaml_load

    out = {}
    for arch, yml in TRANSFORMER_TRAIN_YMLS.items():
        work = ROOT / "build" / f"chip_smoke_train_{arch}"
        shutil.rmtree(work, ignore_errors=True)
        args = ["-opt", str(yml), "--force_yml", *force, "datasets:train:datasets:d3_dehaze:suffix=.png",
                "logger:use_tb_logger=false", "logger:print_freq=1", f"logger:save_checkpoint_freq={TRAIN_ITERS}",
                f"train:scheduler:periods=[{TRAIN_ITERS + RESUME_ITERS}]"]
        mdta_block_fused.launches = mdta_block_bwd.launches = layer_norm_2d.launches = layer_norm_2d.bwd_launches = 0
        t0 = time.perf_counter()
        model = train_pipeline(str(work), args=args + [f"train:total_iter={TRAIN_ITERS}"])
        torch.cuda.synchronize()
        launches = {"mdta_block_fused": mdta_block_fused.launches, "mdta_block_bwd": mdta_block_bwd.launches,
                    "layer_norm_2d": layer_norm_2d.launches + layer_norm_2d.bwd_launches}
        print(f"[11] train_pipeline on {yml.name}, {TRAIN_ITERS} iterations at batch 8, gt_size 128: "
              f"{time.perf_counter() - t0:.1f} s; launches K6 {launches['mdta_block_fused']}, K7 "
              f"{launches['mdta_block_bwd']}, K3 {layer_norm_2d.launches} forward + {layer_norm_2d.bwd_launches} "
              f"backward; losses {dict(model.log_dict)}", flush=True)
        want = {k: n * TRAIN_ITERS for k, n in TRANSFORMER_PER_STEP[arch].items()}
        if launches != want:
            raise RuntimeError(f"{arch}: launches {launches}, expected {want} for {TRAIN_ITERS} steps")
        if not all(np.isfinite(v) for v in model.log_dict.values()) or set(model.log_dict) != {"l_pix", "l_classify"}:
            raise RuntimeError(f"{arch}: bad losses {model.log_dict}")
        models_dir = work / "experiments" / yaml_load(str(yml))["name"] / "models"
        if not (models_dir / f"net_g_{TRAIN_ITERS}.pth").exists():
            raise RuntimeError(f"{arch}: no checkpoint at iteration {TRAIN_ITERS} in {models_dir}")

        resumed = train_pipeline(str(work), args=["--auto_resume", *args,
                                                  f"train:total_iter={TRAIN_ITERS + RESUME_ITERS}"])
        steps = resumed.optimizer_g.state_dict()["state"][0]["step"].item()
        print(f"[11] {arch} resumed from iteration {TRAIN_ITERS} for {RESUME_ITERS} more: optimizer at step "
              f"{steps:.0f}, losses {dict(resumed.log_dict)}", flush=True)
        if steps != TRAIN_ITERS + RESUME_ITERS or not all(np.isfinite(v) for v in resumed.log_dict.values()):
            raise RuntimeError(f"{arch} resume: optimizer step {steps}, losses {resumed.log_dict}")
        del model

        kernels = [k for k in ("mdta_block_fused", "mdta_block_bwd", "layer_norm_2d") if TRANSFORMER_PER_STEP[arch][k]]
        profile = step_profile(resumed, kernels, f"[11] {arch}")
        step_ms, peak = ms_per_step(resumed, 5)
        with plain_path():
            plain_step_ms, plain_peak = ms_per_step(resumed, 3)
        print(f"[11] {arch} DCPT step at batch 8, 128 x 128, fp32: kernel path {step_ms:.2f} ms/step (peak "
              f"{peak:.0f} MiB), plain path {plain_step_ms:.2f} ms/step (peak {plain_peak:.0f} MiB)", flush=True)
        torch.cuda.empty_cache()
        check_bwd_in_step(resumed, f"[11] {arch}", MDTABlockFunction,
                          lambda x, s, dz, config: mdta_block_bwd_ref(x, *s[:11], *s[11:15], dz, *config), K7_TOL)
        torch.cuda.empty_cache()
        check_step_gradients(resumed, f"[11] {arch}", 8, FLOAT64_GRAD_BATCH)
        out[arch] = {"launches": launches, "step_ms": step_ms, "plain_step_ms": plain_step_ms, "profile": profile}
        del resumed
        torch.cuda.empty_cache()
    return out


def swin_params(gen, dtype, device):
    """The 12 Swin block parameters at the shipped width in the op's (in, out)
    layout: each weight drawn in PyTorch's (out, in) layout and passed as the
    ``.t()`` view a module passes, random LayerNorm affines."""
    import torch

    c, hid = SWIN_C, SWIN_HIDDEN

    def r(*shape, scale=0.3, shift=0.0):
        return (torch.randn(*shape, generator=gen) * scale + shift).to(device=device, dtype=dtype)

    return [r(c, shift=1.0), r(c), r(3 * c, c, scale=c ** -0.5).t(), r(3 * c), r(c, c, scale=c ** -0.5).t(), r(c),
            r(c, shift=1.0), r(c), r(hid, c, scale=c ** -0.5).t(), r(hid), r(c, hid, scale=hid ** -0.5).t(), r(c)]


def swin_library_layer(p, dtype):
    """``nn.TransformerEncoderLayer`` (pre-norm, exact GELU, no dropout) holding
    the Swin block parameters ``p``: one PyTorch call that computes K8's
    function on (NW, N, C) windows."""
    import torch

    layer = torch.nn.TransformerEncoderLayer(SWIN_C, SWIN_HEADS, SWIN_HIDDEN, dropout=0.0, activation="gelu",
                                             layer_norm_eps=1e-5, batch_first=True, norm_first=True)
    layer = layer.to(device="cuda", dtype=dtype).eval()
    params = [layer.norm1.weight, layer.norm1.bias, layer.self_attn.in_proj_weight, layer.self_attn.in_proj_bias,
              layer.self_attn.out_proj.weight, layer.self_attn.out_proj.bias, layer.norm2.weight, layer.norm2.bias,
              layer.linear1.weight, layer.linear1.bias, layer.linear2.weight, layer.linear2.bias]
    with torch.no_grad():
        for dst, src in zip(params, p):
            dst.copy_(src.t() if src.dim() == 2 else src)  # the op's (in, out) weights -> (out, in)
    return layer


def check_k8_k10() -> dict:
    """K8 and K10 (with and without its LayerNorm) against their map-level plain
    versions at the SWIN_CASES shapes, fp32 and (B = 1) bf16, each call twice
    for equal bits; per SwinIR forward at 128 x 128 (18 calls at each shift):
    device time (``ms``, ``plain_ms``), CUDA events around back-to-back calls
    (``call_ms``, ``plain_call_ms``) and the bound.  K8 is also held against,
    and timed beside, ``nn.TransformerEncoderLayer`` on the partitioned windows,
    and K10 without its LayerNorm beside ``F.multi_head_attention_forward``
    (``library_ms``; for K10 beside ``no_ln_ms``)."""
    import torch
    import torch.nn.functional as F

    from dcpt_tpu_torch.ops import window_attention as wa

    gen = torch.Generator().manual_seed(13)
    cases = [(*case, "float32") for case in SWIN_CASES] + [(*case, "bfloat16") for case in SWIN_CASES[:2]]
    heads, ws = SWIN_HEADS, SWIN_WS
    names = ("fused_swin_block", "fused_window_attention", "fused_window_attention (no LN)")
    worst = {(n, d): 0.0 for n in names for d in TOL}
    times = {}
    print(f"  {'kernel':>30} {'B':>2} {'H':>4} {'W':>4} {'shift':>5} {'dtype':>9} {'max_abs':>10} {'rel':>10} "
          f"{'kernel_ms':>10} {'plain_ms':>10} {'call_ms':>10} {'plain_call':>10} {'bound_ms':>10} {'lib_err':>10} "
          f"{'library_ms':>10}  (kernel_ms, plain_ms, library_ms: device time per call, torch.profiler; call_ms: "
          f"CUDA events around back-to-back calls)")
    with torch.no_grad():
        for b, h, w, shift, dname in cases:
            dtype = getattr(torch, dname)
            x = torch.randn(b, h, w, SWIN_C, generator=gen).to(device="cuda", dtype=dtype)
            p = swin_params(gen, dtype, "cuda")
            pf = [t.float() for t in p]
            # the libraries' input: the rolled map's (NW, N, C) windows, made outside their timing
            win = wa.window_partition(torch.roll(x, (-shift, -shift), dims=(1, 2)), ws)
            layer = swin_library_layer(p, dtype)
            win_t = win.transpose(0, 1)

            def attention():
                """K10 without LN in one call: the biased in-projection, softmax(q k^T hd^-0.5) v
                per head and the out-projection, on the (N, NW, C) windows."""
                return F.multi_head_attention_forward(win_t, win_t, win_t, SWIN_C, heads, p[2].t(), p[3], None, None,
                                                      False, 0.0, p[4].t(), p[5], training=False,
                                                      need_weights=False)[0].transpose(0, 1)
            # name: kernel, plain version, fp32 reference, (flops, bytes), one library call on the windows or None
            runs = {
                "fused_swin_block": (lambda: wa.fused_swin_block(x, *p, heads, ws, shift),
                                     lambda: wa.swin_block_map_ref(x, *p, heads, ws, shift),
                                     lambda: wa.swin_block_map_ref(x.float(), *pf, heads, ws, shift),
                                     k8_work(SWIN_C, SWIN_HIDDEN, ws * ws, b * h * w), lambda: layer(win)),
                "fused_window_attention": (lambda: wa.fused_window_attention_ln(x, *p[:6], heads, ws, shift),
                                           lambda: wa.window_attention_map_ref(x, *p[2:6], heads, ws, shift,
                                                                               (p[0], p[1], 1e-5)),
                                           lambda: wa.window_attention_map_ref(x.float(), *pf[2:6], heads, ws, shift,
                                                                               (pf[0], pf[1], 1e-5)),
                                           k10_work(SWIN_C, ws * ws, b * h * w), None),
                "fused_window_attention (no LN)": (
                    lambda: wa.fused_window_attention(x, *p[2:6], heads, ws, shift),
                    lambda: wa.window_attention_map_ref(x, *p[2:6], heads, ws, shift),
                    lambda: wa.window_attention_map_ref(x.float(), *pf[2:6], heads, ws, shift),
                    k10_work(SWIN_C, ws * ws, b * h * w), attention),
            }
            for name, (kernel, plain, reference, work, library) in runs.items():
                z, again, ref = kernel(), kernel(), reference()
                torch.cuda.synchronize()
                if z.shape != x.shape or z.dtype != dtype or not torch.isfinite(z).all():
                    raise RuntimeError(f"{name} {b}x{h}x{w} shift {shift} {dname}: bad output {tuple(z.shape)}")
                if not torch.equal(z, again):
                    raise RuntimeError(f"{name} {b}x{h}x{w} shift {shift} {dname}: two runs on the same inputs differ")
                err = (z.float() - ref).abs().max().item()
                rel = err / max(1.0, ref.abs().max().item())
                if rel > TOL[dname]:
                    raise RuntimeError(f"{name} {b}x{h}x{w} shift {shift} {dname}: error {rel:.3e} above "
                                       f"{TOL[dname]:.0e}")
                funcs = device_ms_by_function(kernel, 10)[0]
                owner = name.split(" ")[0]
                if set(funcs) != DEVICE_FUNCTIONS[owner]:
                    raise RuntimeError(f"{name}'s profile shows {sorted(funcs)}, expected {DEVICE_FUNCTIONS[owner]}")
                k_ms, p_ms = sum(funcs.values()), sum(device_ms_by_function(plain, 10)[0].values())
                k_call, p_call = cuda_ms(kernel), cuda_ms(plain)
                b_ms = bound([(1, *work)])[0]
                lib_rel = lib_ms = float("nan")
                if library is not None and dname == "float32":  # in bf16 a library rounds every intermediate
                    lib_map = torch.roll(wa.window_reverse(library(), ws, h, w), (shift, shift), dims=(1, 2))
                    lib_rel = (lib_map.float() - ref).abs().max().item() / max(1.0, ref.abs().max().item())
                    if lib_rel > LIBRARY_TOL:
                        raise RuntimeError(f"{name}'s library call {b}x{h}x{w} shift {shift} {dname}: error "
                                           f"{lib_rel:.3e} against the plain version")
                    lib_ms = sum(device_ms_by_function(library, 10)[0].values())
                print(f"  {name:>30} {b:>2} {h:>4} {w:>4} {shift:>5} {dname:>9} {err:>10.3e} {rel:>10.3e} "
                      f"{k_ms:>10.4f} {p_ms:>10.4f} {k_call:>10.4f} {p_call:>10.4f} {b_ms:>10.4f} {lib_rel:>10.3e} "
                      f"{lib_ms:>10.4f}", flush=True)
                worst[(name, dname)] = max(worst[(name, dname)], err)
                if dname == "float32" and (b, h, w) == (1, 128, 128):
                    times[(name, shift)] = (k_ms, p_ms, k_call, p_call, lib_ms)
    print("  K8 and K10 twice on the same inputs: equal bit for bit at every shape", flush=True)

    def per_forward(name, i):
        return SWIN_PER_FORWARD // 2 * (times[(name, 0)][i] + times[(name, 4)][i])

    out = {}
    for name, work in (("fused_swin_block", k8_work(SWIN_C, SWIN_HIDDEN, SWIN_WS ** 2, 128 * 128)),
                       ("fused_window_attention", k10_work(SWIN_C, SWIN_WS ** 2, 128 * 128))):
        bound_ms, bound_by = bound([(SWIN_PER_FORWARD, *work)])
        out[name] = {"max_abs_err": worst[(name, "float32")], "bf16_max_abs_err": worst[(name, "bfloat16")],
                     "ms": per_forward(name, 0), "plain_ms": per_forward(name, 1), "call_ms": per_forward(name, 2),
                     "plain_call_ms": per_forward(name, 3), "bound_ms": bound_ms, "bound_by": bound_by}
    no_ln = "fused_window_attention (no LN)"
    out["fused_swin_block"]["library_ms"] = per_forward("fused_swin_block", 4)
    out["fused_window_attention"].update(library_ms=per_forward(no_ln, 4), no_ln_ms=per_forward(no_ln, 0),
                                         no_ln_plain_ms=per_forward(no_ln, 1))
    return out


def _plain_swin_forward(self, x):
    """SwinTransformerBlock.forward with K8's plain version."""
    from dcpt_tpu_torch.ops.window_attention import swin_block_map_ref

    return swin_block_map_ref(x, *self.op_args(), self.num_heads, self.window_size, self.shift_size, self.norm1.eps)


def run_swinir_slice(force: list[str]) -> dict:
    """The shipped SwinIR eval yml through test_pipeline at full width on the PNGs
    of [4], on the K8 route and on the K10 route; a ragged image through the K8,
    K10 and plain paths; the device time of a forward by kernel; the eval rates."""
    import numpy as np
    import torch

    from dcpt_tpu_torch.archs import swinir_arch
    from dcpt_tpu_torch.models import build_model
    from dcpt_tpu_torch.ops.window_attention import fused_swin_block, fused_window_attention
    from dcpt_tpu_torch.test import test_pipeline
    from dcpt_tpu_torch.utils.options import parse_options

    n_images = 10
    ckpt = WORK / "SwinIR.pth"
    write_transformer_checkpoint(SWINIR_YML, ckpt, seed=20)
    args = ["-opt", str(SWINIR_YML), "--force_yml", *force, f"path:pretrain_network_g={ckpt}"]
    launches, metrics = {}, {}
    # the route DCPT_TPU_SWIN_BLOCK=0 selects: the module constant it sets at import
    for route, block_kernel in (("K8", True), ("K10", False)):
        swinir_arch.SWIN_BLOCK_KERNEL = block_kernel
        fused_swin_block.launches = fused_window_attention.launches = 0
        t0 = time.perf_counter()
        results = test_pipeline(str(WORK / f"SwinIR_{route}"), args=args)
        torch.cuda.synchronize()
        launches[route] = {"fused_swin_block": fused_swin_block.launches,
                           "fused_window_attention": fused_window_attention.launches}
        print(f"[13] test_pipeline on {SWINIR_YML.name}, {route} route: {time.perf_counter() - t0:.1f} s, launches "
              f"K8 {fused_swin_block.launches}, K10 {fused_window_attention.launches} for {n_images} forwards "
              f"({SWIN_PER_FORWARD} SwinTransformerBlocks each)", flush=True)
        for name, m in results.items():
            print(f"    {name}: " + ", ".join(f"{k} {v:.4f}" for k, v in m.items()), flush=True)
        if set(results) != {"Rain100L", "CBSD68", "SOTS", "deblur", "LowLight"}:
            raise RuntimeError(f"SwinIR {route}: datasets evaluated: {sorted(results)}")
        if not all(np.isfinite(v) for m in results.values() for v in m.values()):
            raise RuntimeError(f"SwinIR {route}: non-finite metrics: {results}")
        want = SWIN_PER_FORWARD * n_images
        expect = {"fused_swin_block": want if block_kernel else 0, "fused_window_attention": 0 if block_kernel else want}
        if launches[route] != expect:
            raise RuntimeError(f"SwinIR {route}: launches {launches[route]}, expected {expect}")
        metrics[route] = results
    swinir_arch.SWIN_BLOCK_KERNEL = True
    gap = max(abs(metrics["K8"][d][k] - metrics["K10"][d][k]) for d in metrics["K8"] for k in metrics["K8"][d])
    print(f"[13] metrics of the K10 route against the K8 route: largest difference {gap:.3e}", flush=True)
    if gap > 1e-2:
        raise RuntimeError(f"SwinIR: the K10 route's metrics differ from the K8 route's by {gap:.3e}")

    opt, _ = parse_options(str(WORK / "SwinIR_K8"), is_train=False, args=args)
    model = build_model(opt)
    gen = torch.Generator().manual_seed(21)
    model.feed_data({"lq": torch.rand(1, 3, 118, 70, generator=gen)})
    model.pre_test()
    model.test()
    outs = {"K8": model.output.clone()}
    swinir_arch.SWIN_BLOCK_KERNEL = False
    model.test()
    outs["K10"] = model.output.clone()
    swinir_arch.SWIN_BLOCK_KERNEL = True
    with mock.patch.object(swinir_arch.SwinTransformerBlock, "forward", _plain_swin_forward):
        model.test()
    plain_out = model.output
    if outs["K8"].shape != (1, 3, 120, 72) or not torch.isfinite(outs["K8"]).all():
        raise RuntimeError(f"SwinIR: bad network output {tuple(outs['K8'].shape)}")
    scale = max(1.0, plain_out.abs().max().item())
    rel = (outs["K8"] - plain_out).abs().max().item() / scale
    rel_k10 = (outs["K10"] - outs["K8"]).abs().max().item() / scale
    print(f"[13] one image (118x70, padded to 120x72, 15 x 9 windows): K8 path vs plain path {rel:.3e}, K10 route vs "
          f"K8 path {rel_k10:.3e}, relative to max(1, max|plain|) (limit 1e-4, fp32, TF32 off)", flush=True)
    if rel > 1e-4 or rel_k10 > 1e-4:
        raise RuntimeError(f"SwinIR: K8 path vs plain {rel:.3e}, K10 route vs K8 {rel_k10:.3e}")

    lq = torch.rand(1, 3, 128, 128, generator=gen).cuda()
    model.lq = lq
    profile = {}
    for route, block_kernel in (("K8", True), ("K10", False)):
        swinir_arch.SWIN_BLOCK_KERNEL = block_kernel
        kernel = "fused_swin_block" if block_kernel else "fused_window_attention"
        funcs, wall_ms = device_ms_by_function(model.test, 5)
        mine = sum(ms for f, ms in funcs.items() if f in DEVICE_FUNCTIONS[kernel])
        if not mine:
            raise RuntimeError(f"SwinIR {route}: the forward's profile shows no {DEVICE_FUNCTIONS[kernel]}")
        other = sum(funcs.values()) - mine
        top = sorted(((ms, f) for f, ms in funcs.items() if f not in DEVICE_FUNCTIONS[kernel]), reverse=True)[:4]
        print(f"[13] SwinIR forward at 128x128, {route} route (torch.profiler, 5 forwards): device {mine + other:.2f} ms "
              f"of {wall_ms:.2f} ms wall (busy {100 * (mine + other) / wall_ms:.1f} %): {route} {mine:.2f} ms, "
              f"PyTorch {other:.2f} ms (" + ", ".join(f"{f} {ms:.2f}" for ms, f in top) + ")", flush=True)
        profile[route] = {"device_ms": mine + other, "kernel_ms": mine, "wall_ms": wall_ms}
    rates = {}
    for route, block_kernel in (("K8", True), ("K10", False)):
        swinir_arch.SWIN_BLOCK_KERNEL = block_kernel
        torch.cuda.reset_peak_memory_stats()
        rates[route] = (images_per_s(model, lq), torch.cuda.max_memory_allocated() / 2**20)
    swinir_arch.SWIN_BLOCK_KERNEL = True
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(swinir_arch.SwinTransformerBlock, "forward", _plain_swin_forward):
        rates["plain"] = (images_per_s(model, lq), torch.cuda.max_memory_allocated() / 2**20)
    print("[13] SwinIR eval forward at 128x128, batch 1, fp32: " + ", ".join(
        f"{route} path {r:.2f} images/s (peak {peak:.0f} MiB)" for route, (r, peak) in rates.items()), flush=True)
    return {"launches": launches, "profile": profile, "rates": rates}


def check_k9() -> dict:
    """K9 against its plain version at the K9_CASES shapes (C 180, 6 heads, 8 x 8
    windows, hidden 360), fp32, each call twice for equal bits; per SwinIR
    backward at 128 x 128, B = 2 (18 calls at each shift): device time (``ms``,
    ``plain_ms``), CUDA events around back-to-back calls (``call_ms``,
    ``plain_call_ms``) and the bound; one call at B = 8 (``b8_*``)."""
    import torch

    from dcpt_tpu_torch.ops.swin_block_bwd import swin_block_bwd, swin_block_bwd_ref

    gen = torch.Generator().manual_seed(14)
    heads, ws, worst, times = SWIN_HEADS, SWIN_WS, 0.0, {}
    print(f"  {'B':>2} {'H':>4} {'W':>4} {'shift':>5} {'max_abs':>10} {'rel':>10} {'worst of':>8} {'kernel_ms':>10} "
          f"{'plain_ms':>10} {'call_ms':>10} {'plain_call':>10} {'bound_ms':>10}  (kernel_ms, plain_ms: device time per "
          f"call, torch.profiler; call_ms: CUDA events around back-to-back calls)")
    for b, h, w, shift in K9_CASES:
        x = torch.randn(b, h, w, SWIN_C, generator=gen).cuda()
        dz = torch.randn(b, h, w, SWIN_C, generator=gen).cuda()
        p = swin_params(gen, torch.float32, "cuda")

        def kernel():
            return swin_block_bwd(x, *p, dz, heads, ws, shift)

        def plain():
            return swin_block_bwd_ref(x, *p, dz, heads, ws, shift)

        got, again, ref = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        errs = [(g - r).abs().max().item() / max(1.0, r.abs().max().item()) for g, r in zip(got, ref)]
        i = max(range(len(errs)), key=errs.__getitem__)
        if any(g.shape != r.shape or not torch.isfinite(g).all() for g, r in zip(got, ref)):
            raise RuntimeError(f"K9 {b}x{h}x{w} shift {shift}: bad cotangents")
        if not all(torch.equal(g, a) for g, a in zip(got, again)):
            raise RuntimeError(f"K9 {b}x{h}x{w} shift {shift}: two runs on the same inputs differ")
        if errs[i] > K9_TOL:
            raise RuntimeError(f"K9 {b}x{h}x{w} shift {shift}: cotangent {i} error {errs[i]:.3e} above {K9_TOL:.0e}")
        funcs = device_ms_by_function(kernel, 5)[0]
        if set(funcs) != DEVICE_FUNCTIONS["swin_block_bwd"]:
            raise RuntimeError(f"K9's profile shows {sorted(funcs)}, expected {DEVICE_FUNCTIONS['swin_block_bwd']}")
        k_ms, p_ms = sum(funcs.values()), sum(device_ms_by_function(plain, 5)[0].values())
        k_call, p_call = cuda_ms(kernel, 5), cuda_ms(plain, 5)
        b_ms = bound([(1, *k9_work(SWIN_C, SWIN_HIDDEN, ws * ws, b * h * w))])[0]
        err = (got[i] - ref[i]).abs().max().item()
        print(f"  {b:>2} {h:>4} {w:>4} {shift:>5} {err:>10.3e} {errs[i]:>10.3e} {i:>8} {k_ms:>10.4f} {p_ms:>10.4f} "
              f"{k_call:>10.4f} {p_call:>10.4f} {b_ms:>10.4f}", flush=True)
        worst = max(worst, err)
        times[(b, h, w, shift)] = (k_ms, p_ms, k_call, p_call, b_ms)
    print("  K9 twice on the same inputs: equal bit for bit at every shape", flush=True)

    def per_backward(i):
        return SWIN_PER_FORWARD // 2 * (times[(2, 128, 128, 0)][i] + times[(2, 128, 128, 4)][i])

    bound_ms, bound_by = bound([(SWIN_PER_FORWARD, *k9_work(SWIN_C, SWIN_HIDDEN, ws * ws, 2 * 128 * 128))])
    b8 = times[(8, 128, 128, 4)]
    return {"max_abs_err": worst, "ms": per_backward(0), "plain_ms": per_backward(1), "call_ms": per_backward(2),
            "plain_call_ms": per_backward(3), "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "b8_ms": b8[0], "b8_plain_ms": b8[1], "b8_bound_ms": b8[4]}


def run_swinir_training(force: list[str]) -> dict:
    """The shipped SwinIR DCPT yml through train_pipeline at full width on the PNGs
    of [7]: launches per step, checkpoint retention, resume, the step's profile,
    the ms per step and peak memory of both paths, every K9 call of a step
    against its plain version, one step's gradients against the plain path's,
    and one step on the K10 route against the K8 route."""
    import gc
    import shutil

    import numpy as np
    import torch

    from dcpt_tpu_torch.archs import swinir_arch
    from dcpt_tpu_torch.ops.layernorm2d import layer_norm_2d
    from dcpt_tpu_torch.ops.swin_block_bwd import swin_block_bwd, swin_block_bwd_ref
    from dcpt_tpu_torch.ops.window_attention import SwinBlockFunction, fused_swin_block, fused_window_attention
    from dcpt_tpu_torch.train import train_pipeline

    work = ROOT / "build" / "chip_smoke_train_SwinIR"
    shutil.rmtree(work, ignore_errors=True)
    args = ["-opt", str(SWIN_TRAIN_YML), "--force_yml", *force, "datasets:train:datasets:d3_dehaze:suffix=.png",
            "logger:use_tb_logger=false", "logger:print_freq=1", "logger:save_checkpoint_freq=2",
            "logger:keep_checkpoints=1", f"train:scheduler:periods=[{TRAIN_ITERS + RESUME_ITERS}]"]
    fused_swin_block.launches = swin_block_bwd.launches = layer_norm_2d.launches = layer_norm_2d.bwd_launches = 0
    t0 = time.perf_counter()
    model = train_pipeline(str(work), args=args + [f"train:total_iter={TRAIN_ITERS}"])
    torch.cuda.synchronize()
    launches = {"fused_swin_block": fused_swin_block.launches, "swin_block_bwd": swin_block_bwd.launches,
                "layer_norm_2d": layer_norm_2d.launches + layer_norm_2d.bwd_launches}
    print(f"[15] train_pipeline on {SWIN_TRAIN_YML.name}, {TRAIN_ITERS} iterations at batch 8, gt_size 128: "
          f"{time.perf_counter() - t0:.1f} s; launches K8 {launches['fused_swin_block']}, K9 "
          f"{launches['swin_block_bwd']}, K3 {launches['layer_norm_2d']}; losses {dict(model.log_dict)}", flush=True)
    want = {k: n * TRAIN_ITERS for k, n in SWIN_PER_STEP.items()}
    if launches != want:
        raise RuntimeError(f"SwinIR: launches {launches}, expected {want} for {TRAIN_ITERS} steps")
    if not all(np.isfinite(v) for v in model.log_dict.values()) or set(model.log_dict) != {"l_pix", "l_classify"}:
        raise RuntimeError(f"SwinIR: bad losses {model.log_dict}")
    exp = work / "experiments" / "SwinIR_dcpt_5d_pretrain"
    states = sorted(f.name for f in (exp / "training_states").iterdir())
    if not (exp / "models" / f"net_g_{TRAIN_ITERS}.pth").exists() or states != [f"{TRAIN_ITERS}.state"]:
        raise RuntimeError(f"SwinIR: checkpoint at iteration {TRAIN_ITERS} missing, or training states {states}")
    del model

    resumed = train_pipeline(str(work), args=["--auto_resume", *args, f"train:total_iter={TRAIN_ITERS + RESUME_ITERS}"])
    steps = resumed.optimizer_g.state_dict()["state"][0]["step"].item()
    states = sorted(f.name for f in (exp / "training_states").iterdir())
    print(f"[15] SwinIR resumed from iteration {TRAIN_ITERS} for {RESUME_ITERS} more: optimizer at step {steps:.0f}, "
          f"training states kept {states} (logger.keep_checkpoints 1), losses {dict(resumed.log_dict)}", flush=True)
    if (steps != TRAIN_ITERS + RESUME_ITERS or states != [f"{TRAIN_ITERS + RESUME_ITERS}.state"]
            or not all(np.isfinite(v) for v in resumed.log_dict.values())):
        raise RuntimeError(f"SwinIR resume: optimizer step {steps}, states {states}, losses {resumed.log_dict}")

    profile = step_profile(resumed, ["fused_swin_block", "swin_block_bwd"], "[15] SwinIR")
    step_ms, peak = ms_per_step(resumed, 5)
    print(f"[15] SwinIR DCPT step at batch 8, 128 x 128, fp32: kernel path {step_ms:.2f} ms/step (peak {peak:.0f} "
          f"MiB)", flush=True)
    rates = {"8": {"kernel": [step_ms, peak]}}
    for plain_batch in (8, 4, 2, 1):
        if plain_batch < 8:
            resumed.feed_data(grad_batch(plain_batch))
            rates[str(plain_batch)] = {"kernel": list(ms_per_step(resumed, 5))}
        try:
            with plain_path():
                rates[str(plain_batch)]["plain"] = list(ms_per_step(resumed, 3))
            break
        except torch.cuda.OutOfMemoryError as e:
            print(f"[15] SwinIR plain path at batch {plain_batch}: {str(e).splitlines()[0]}", flush=True)
        # the failed step's graph stays referenced from the exception's frames until a collection
        gc.collect()
        resumed.optimizer_g.zero_grad(set_to_none=True)
        resumed.optimizer_dc.zero_grad(set_to_none=True)
        torch.cuda.empty_cache()
    (k_ms, k_peak), (p_ms, p_peak) = rates[str(plain_batch)]["kernel"], rates[str(plain_batch)]["plain"]
    print(f"[15] SwinIR DCPT step at batch {plain_batch} (the largest the plain path fits), 128 x 128, fp32: kernel "
          f"path {k_ms:.2f} ms/step (peak {k_peak:.0f} MiB), plain path {p_ms:.2f} ms/step (peak {p_peak:.0f} MiB)",
          flush=True)
    torch.cuda.empty_cache()
    check_bwd_in_step(resumed, "[15] SwinIR", SwinBlockFunction,
                      lambda x, s, dz, config: swin_block_bwd_ref(x, *s, dz, *config), K9_TOL,
                      SWIN_PER_STEP["swin_block_bwd"])
    torch.cuda.empty_cache()
    check_step_gradients(resumed, "[15] SwinIR", plain_batch, SWIN_FLOAT64_BATCH)
    torch.cuda.empty_cache()

    # the DCPT_TPU_SWIN_BLOCK=0 route: the module constant it sets at import
    batch = grad_batch(plain_batch)
    with smooth_switches(resumed):
        k8, _ = step_grads(resumed, batch)
        again, _ = step_grads(resumed, batch)
        swinir_arch.SWIN_BLOCK_KERNEL = False
        try:
            fused_window_attention.launches = 0
            k10, _ = step_grads(resumed, batch)
        finally:
            swinir_arch.SWIN_BLOCK_KERNEL = True
    ks, _ = over_limit(k10, k8, again)
    worst = max(ks, key=ks.get)
    print(f"[15] SwinIR K10 route, one step at batch {plain_batch}: {fused_window_attention.launches} K10 launches; "
          f"gradients against the K8 route's: worst {grad_errs(k10, k8)[worst]:.3e} of the tensor's max|ref| "
          f"({worst}), {ks[worst]:.3f} of its limit", flush=True)
    if fused_window_attention.launches != SWIN_PER_STEP["fused_swin_block"] or not ks[worst] <= 1:
        raise RuntimeError(f"SwinIR K10 route: {fused_window_attention.launches} launches, gradient {worst} "
                           f"{ks[worst]:.3f} of its limit")

    # The same steps with cuDNN's algorithm timing, which the reference's train_pipeline turns on and the
    # port's leaves off (ROADMAP Q3 #5): without it cuDNN's heuristic picks convolution algorithms
    # (an FFT path at batch 4) that take far longer.  Not the entry point's numbers, and labelled so.
    timed = {}
    torch.backends.cudnn.benchmark = True
    try:
        for b in dict.fromkeys((8, plain_batch)):
            resumed.feed_data(grad_batch(b))
            timed[str(b)] = {"kernel": list(ms_per_step(resumed, 5))}
        with plain_path():
            timed[str(plain_batch)]["plain"] = list(ms_per_step(resumed, 3))
    finally:
        torch.backends.cudnn.benchmark = False
    (k8_ms, k8_peak), (k_ms, k_peak) = timed["8"]["kernel"], timed[str(plain_batch)]["kernel"]
    p_ms, p_peak = timed[str(plain_batch)]["plain"]
    print(f"[15] SwinIR DCPT step with torch.backends.cudnn.benchmark on (not the entry point's default), 128 x 128, "
          f"fp32: kernel path {k8_ms:.2f} ms/step at batch 8 (peak {k8_peak:.0f} MiB); at batch {plain_batch} kernel "
          f"path {k_ms:.2f} ms/step (peak {k_peak:.0f} MiB), plain path {p_ms:.2f} ms/step (peak {p_peak:.0f} MiB)",
          flush=True)
    return {"launches": launches, "step_ms": step_ms, "peak_mib": peak, "plain_batch": plain_batch, "rates": rates,
            "cudnn_benchmark_rates": timed, "profile": profile}


PHASE_RESULT = "CHIP_SMOKE_PHASE_RESULT "
# set once torch.profiler has recorded no device time in this process
_profiler_lost = False


def run_phase(fn, *args):
    """``fn(*args)``, a phase whose arguments and result are JSON.  If a profile
    of the phase records no device time, the phase runs once more in a fresh
    process on the same card, its output passed on, and so does every phase
    after it; a profile there that records none fails the script."""
    global _profiler_lost
    import gc

    import torch

    if not _profiler_lost:
        try:
            return fn(*args)
        except NoDeviceTime as e:
            print(f"  {e}: {fn.__name__} again in a fresh process", flush=True)
            _profiler_lost = True
        gc.collect()  # the failed attempt's tensors, before the child takes its memory from the same card
    torch.cuda.empty_cache()
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--phase", fn.__name__, json.dumps(args)],
                            stdout=subprocess.PIPE, text=True)
    result = None
    for line in proc.stdout:
        if line.startswith(PHASE_RESULT):
            result = json.loads(line[len(PHASE_RESULT):])
        else:
            print(line, end="", flush=True)
    if proc.wait() != 0 or result is None:
        raise RuntimeError(f"{fn.__name__} failed in a fresh process (exit code {proc.returncode})")
    return result


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
    # the training loaders' workers start as fresh interpreters: after a few
    # loaders of forked workers (fork or forkserver) torch.profiler records no
    # device time in this process, which the later phases' profiles need
    multiprocessing.set_start_method("spawn")
    if sys.argv[1:2] == ["--phase"]:  # run_phase's fresh process
        print(PHASE_RESULT + json.dumps(globals()[sys.argv[2]](*json.loads(sys.argv[3]))), flush=True)
        return 0

    card = card_line()
    print(f"[1] card: {card}", flush=True)
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    build_s = build_kernels()
    print(f"[2] built K1, K2, K3, K6, K7, K8, K10, K9 in {', '.join(f'{b:.1f}' for b in build_s)} s (nvcc, in parallel), "
          f"phase {time.perf_counter() - t0:.1f} s", flush=True)

    print("[3] K1 naf_block_fused vs naf_block_ref, B=2, TF32 off", flush=True)
    k1 = run_phase(check_k1)
    print(f"[3] K1 per NAFNet-w64 forward (B=2, 128x128, 36 blocks): kernel {k1['ms']:.3f} ms, "
          f"plain {k1['plain_ms']:.3f} ms, bound {k1['bound_ms']:.3f} ms ({k1['bound_by']})", flush=True)

    force = run_phase(run_slice)

    print(f"[5] K2 naf_block_bwd vs naf_block_bwd_ref, B=2, fp32, limit {K2_TOL:.0e} relative", flush=True)
    k2 = run_phase(check_k2)
    print(f"[5] K2 per NAFNet-w64 backward (B=2, 128x128, 36 blocks): kernel {k2['ms']:.3f} ms, "
          f"plain {k2['plain_ms']:.3f} ms, bound {k2['bound_ms']:.3f} ms ({k2['bound_by']})", flush=True)

    print("[6] K3 layer_norm_2d forward + backward vs plain and F.layer_norm, fp32, limit 1e-4", flush=True)
    k3 = run_phase(check_k3)
    print(f"[6] K3 per DCPT step ({K3_PER_STEP} calls each way at batch 8): kernel {k3['ms']:.3f} ms, plain "
          f"{k3['plain_ms']:.3f} ms, F.layer_norm {k3['library_ms']:.3f} ms, bound {k3['bound_ms']:.3f} ms "
          f"({k3['bound_by']})", flush=True)

    train = run_phase(run_training)

    print("[8] K6 mdta_block_fused vs mdta_block_ref, B=1, TF32 off; limits 1e-4 (fp32), 2e-2 (bf16) relative to "
          "max(1, max|ref|)", flush=True)
    k6 = run_phase(check_k6)
    for net, pre, blocks in (("Restormer", "", 44), ("PromptIR", "promptir_", 47)):
        print(f"[8] K6 per {net} forward (128x128, {blocks} blocks): device {k6[pre + 'ms']:.3f} ms (plain "
              f"{k6[pre + 'plain_ms']:.3f} ms), back-to-back calls {k6[pre + 'call_ms']:.3f} ms (plain "
              f"{k6[pre + 'plain_call_ms']:.3f} ms), bound {k6[pre + 'bound_ms']:.3f} ms ({k6[pre + 'bound_by']})",
              flush=True)

    k6_launches = run_phase(run_transformer_slices, force)

    print(f"[10] K7 mdta_block_bwd vs mdta_block_bwd_ref, B=2 (and 8 at 128x128), fp32, TF32 off, limit "
          f"{K7_TOL:.0e} relative",
          flush=True)
    k7 = run_phase(check_k7)
    for net, pre, blocks in (("Restormer", "", 44), ("PromptIR", "promptir_", 47)):
        print(f"[10] K7 per {net} backward (B=2, 128x128, {blocks} blocks): device {k7[pre + 'ms']:.3f} ms (plain "
              f"{k7[pre + 'plain_ms']:.3f} ms), back-to-back calls {k7[pre + 'call_ms']:.3f} ms (plain "
              f"{k7[pre + 'plain_call_ms']:.3f} ms), bound {k7[pre + 'bound_ms']:.3f} ms ({k7[pre + 'bound_by']})",
              flush=True)

    transformer_train = run_phase(run_transformer_training, train["force"])

    print(f"[12] K8 fused_swin_block vs swin_block_map_ref, K10 fused_window_attention(_ln) vs "
          f"window_attention_map_ref, C {SWIN_C}, {SWIN_HEADS} heads, ws {SWIN_WS}, TF32 off; limits 1e-4 (fp32), 2e-2 "
          f"(bf16) relative to max(1, max|ref|)", flush=True)
    swin = run_phase(check_k8_k10)
    for name, k in swin.items():
        print(f"[12] {name} per SwinIR forward (128x128, {SWIN_PER_FORWARD} blocks): device {k['ms']:.3f} ms (plain "
              f"{k['plain_ms']:.3f} ms), back-to-back calls {k['call_ms']:.3f} ms (plain {k['plain_call_ms']:.3f} ms), "
              f"bound {k['bound_ms']:.3f} ms ({k['bound_by']})", flush=True)
    k10 = swin["fused_window_attention"]
    print(f"[12] one library call per block on the partitioned windows, per SwinIR forward: nn.TransformerEncoderLayer "
          f"{swin['fused_swin_block']['library_ms']:.3f} ms (K8 {swin['fused_swin_block']['ms']:.3f} ms); "
          f"F.multi_head_attention_forward {k10['library_ms']:.3f} ms (K10 without LN {k10['no_ln_ms']:.3f} ms, its "
          f"plain version {k10['no_ln_plain_ms']:.3f} ms)", flush=True)

    swin_slice = run_phase(run_swinir_slice, force)

    print(f"[14] K9 swin_block_bwd vs swin_block_bwd_ref, C {SWIN_C}, {SWIN_HEADS} heads, ws {SWIN_WS}, fp32, TF32 off, "
          f"limit {K9_TOL:.0e} relative to max(1, max|ref|) on each of the 13 cotangents", flush=True)
    k9 = run_phase(check_k9)
    print(f"[14] K9 per SwinIR backward (B=2, 128x128, {SWIN_PER_FORWARD} blocks): device {k9['ms']:.3f} ms (plain "
          f"{k9['plain_ms']:.3f} ms), back-to-back calls {k9['call_ms']:.3f} ms (plain {k9['plain_call_ms']:.3f} ms), "
          f"bound {k9['bound_ms']:.3f} ms ({k9['bound_by']}); one call at B=8: {k9['b8_ms']:.3f} ms (plain "
          f"{k9['b8_plain_ms']:.3f} ms, bound {k9['b8_bound_ms']:.3f} ms); library: none (no PyTorch call computes "
          f"the block's backward)", flush=True)

    swin_train = run_phase(run_swinir_training, train["force"])

    launches = dict(train["launches"], mdta_block_fused=k6_launches["Restormer"],
                    mdta_block_bwd=transformer_train["Restormer"]["launches"]["mdta_block_bwd"],
                    fused_swin_block=swin_slice["launches"]["K8"]["fused_swin_block"],
                    fused_window_attention=swin_slice["launches"]["K10"]["fused_window_attention"],
                    swin_block_bwd=swin_train["launches"]["swin_block_bwd"])
    kernels = []
    for name, measured in (("naf_block_fused", k1), ("naf_block_bwd", k2), ("layer_norm_2d", k3),
                           ("mdta_block_fused", k6), ("mdta_block_bwd", k7),
                           ("fused_swin_block", swin["fused_swin_block"]),
                           ("fused_window_attention", swin["fused_window_attention"]), ("swin_block_bwd", k9)):
        source, replaces = KERNELS[name]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": measured["max_abs_err"],
                        "ms": measured["ms"], "plain_ms": measured["plain_ms"], "bound_ms": measured["bound_ms"],
                        "bound_by": measured["bound_by"], "library_ms": measured["library_ms"]})
    kernels[3].update(launches_promptir=k6_launches["PromptIR"], call_ms=k6["call_ms"],
                      **{k: v for k, v in k6.items() if k.startswith("promptir_") and k != "promptir_bound_by"})
    for entry in kernels[5:7]:
        entry.update(launches_per_image=SWIN_PER_FORWARD, call_ms=swin[entry["name"]]["call_ms"],
                     plain_call_ms=swin[entry["name"]]["plain_call_ms"])
    # library_ms is K10 without its LayerNorm: beside it, the kernel's and the plain version's ms without it
    kernels[6].update(no_ln_ms=k10["no_ln_ms"], no_ln_plain_ms=k10["no_ln_plain_ms"])
    kernels[4].update(launches_per_step=TRANSFORMER_PER_STEP["Restormer"]["mdta_block_bwd"],
                      launches_promptir=transformer_train["PromptIR"]["launches"]["mdta_block_bwd"],
                      call_ms=k7["call_ms"],
                      **{k: v for k, v in k7.items() if k.startswith("promptir_") and k != "promptir_bound_by"})
    kernels[7].update(launches_per_step=SWIN_PER_STEP["swin_block_bwd"], call_ms=k9["call_ms"],
                      plain_call_ms=k9["plain_call_ms"], b8_ms=k9["b8_ms"], b8_plain_ms=k9["b8_plain_ms"],
                      b8_bound_ms=k9["b8_bound_ms"])
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
