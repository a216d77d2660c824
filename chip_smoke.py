"""Drive the PyTorch/CUDA port (``dcpt_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1):

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel of the main paths from ``dcpt_tpu_torch/csrc`` (one
   nvcc per source, all started together);
3. kernel K1 (``naf_block_fused``, its 1x1 products on the tensor cores)
   against its plain twin at the five NAFNet-w64 stage shapes of a 128 x 128
   input at B = 2, plus two ragged shapes, in fp32 (and bf16 at C = 64 and
   512), and at the train yml's B = 8 at C = 64 (fp32 and bf16) and c = 512,
   TF32 off for both, each run twice for equal bits; its ms per forward
   beside the plain twin's and the bound (3xTF32 on the tensor cores, and the
   SIMT fp32 bound); the device time of each of its passes at B = 8
   (``tools/swin_ab.py::pass_split``);
4. the eval path: the shipped ``options/all_in_one/test/test_NAFNet_5d.yml``
   through the port's ``test_pipeline`` at full NAFNet-w64 width, on
   synthetic PNGs and seeded random weights, with the kernel's launch count
   checked and one image's output held against the plain path on the card;
5. kernel K2 (``naf_block_bwd``, the NAFBlock backward, its products and
   weight gradients on the tensor cores) against its plain version at the
   same stage and ragged shapes and at the train yml's B = 8 at C = 64, 128 x
   128, fp32, each run twice to show it is deterministic; its ms per
   backward beside the plain version's and the bound (3xTF32 on the tensor
   cores, and the SIMT fp32 bound); the device time of each of its passes at
   B = 8 (``tools/swin_ab.py::pass_split``);
6. kernel K3 (``layer_norm_2d``, forward and backward) against its plain
   version and against ``F.layer_norm`` at the classifier's five row shapes
   of a batch-8 step and at one of rows wider than K3 holds in registers,
   twice for equal bits, each shape's device time and CUDA-event time beside
   ``F.layer_norm`` + its backward's;
7. the training path: the shipped
   ``options/all_in_one/train/train_NAFNet_dcpt_5d.yml`` through the port's
   ``train_pipeline`` at full width, batch 8, gt_size 128, on synthetic
   160 x 160 PNGs: 4 iterations with a checkpoint, the launch counts of K1,
   K2 and K3 per step checked, a resume for 2 more; then one step's gradients
   through the kernels against the plain path's and against the plain path in
   float64, each tensor held to its rounding sensitivity
   (``check_step_gradients``, ``dcpt_tpu_torch.tools.grad_check``), and the ms
   per step and peak memory of both paths;
8. kernel K6 (``mdta_block_fused``, the whole Restormer / PromptIR
   TransformerBlock, its 1x1 products on the tensor cores) against its plain
   version at the Restormer stage shapes of a 128 x 128 input and PromptIR's
   three noise-level shapes (B = 1) in both flavours (ReLU / BiasFree / 1e-6
   and softmax / WithBias / 1e-5), two ragged shapes, bf16 at C = 48 and 384,
   and the two 128 x 128 stages at the train ymls' B = 8 (fp32 in both
   flavours, bf16 in Restormer's), each run twice for equal bits; its ms per
   Restormer and per PromptIR forward beside the plain version's and the
   bound (3xTF32 on the tensor cores, and the SIMT fp32 bound); the device
   time of each of its passes at B = 8;
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
   per Restormer and per PromptIR backward beside the plain version's and the
   bound (3xTF32 on the tensor cores, where its 1x1 products and weight
   gradients run, and the SIMT fp32 bound); the device time of each of its
   passes at B = 8;
11. the training paths of the shipped ``train_Restormer_dcpt_5d.yml`` and
   ``train_PromptIR_dcpt_5d.yml`` through ``train_pipeline`` at full width,
   batch 8, gt_size 128, on the PNGs of [7]: 1 iteration with a checkpoint,
   the launch counts of K6, K7 and K3 per step checked, a resume for 1 more;
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
   (36 calls at 128 x 128) beside the plain versions', the library calls'
   and the bound (3xTF32 on the tensor cores, and the SIMT fp32 bound);
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
   and the bound (3xTF32 on the tensor cores, and the SIMT fp32 bound); the
   device time of each of its passes at B = 8 (``tools/swin_ab.py::pass_split``);
15. the training path of the shipped ``train_SwinIR_dcpt_5d.yml`` through
   ``train_pipeline`` at full width, batch 8, gt_size 128, on the PNGs of [7]:
   4 iterations saving every 2 with one training state kept, the launch
   counts of K8, K9 and K3 per step checked, a resume for 2 more; the step's
   device time by kernel; the ms per step and peak memory of the kernel path
   and the plain path (at the largest batch the plain path fits, with its
   OOM at batch 8 printed); every K9 call of a batch-8 step against its plain
   version on that call's inputs; one step's gradients through the kernels
   against the plain path's; one step on the ``DCPT_TPU_SWIN_BLOCK=0`` route
   (K10 launches counted, gradients against the K8 route's);
16. kernels K4 (``naf_prefix``) and K5 (``naf_ffn``, both on the tensor
   cores through K1's passes) against their plain versions at NAFNet-w64's
   c = 512 stage of a 128 x 128 input (B = 1, 2, 8) and a ragged 15 x 9, fp32
   and bf16, each run twice for equal bits; their ms per forward (29 calls)
   beside the plain versions', the library calls' (F.layer_norm with a 1x1
   and a depthwise F.conv2d; F.layer_norm with two F.linear) and the bound
   (3xTF32 on the tensor cores, and the SIMT fp32 bound); at B = 8 each
   call's ms and device time beside the library call's, and its device time
   by pass (``tools/swin_ab.py::pass_split``);
17. the eval path of ``test_NAFNet_5d.yml`` through ``test_pipeline`` on the
   route that ``DCPT_TPU_PALLAS=1 DCPT_TPU_NAF_BLOCK=0`` selects, in a fresh
   process with both set: 29 K4 and 29 K5 launches per image checked (and K3
   at the middle block, no K1), a ragged image against the default route
   within 1e-4, the eval rates of both routes;
18. kernels K2 and K3 in bf16 against their plain versions: K2 at the stage
   and ragged shapes of [5], K3 at the row shapes of [6] as there, twice for
   equal bits; K2's ms per backward and K3's per shape and per step beside the
   plain versions' and ``F.layer_norm``'s;
19. the mixed-precision training path: ``train_NAFNet_dcpt_5d.yml`` with
   ``train:mixed_precision=true`` through ``train_pipeline`` at full width,
   batch 8, gt_size 128 on the PNGs of [7]: 1 iteration with a checkpoint,
   the launch counts of K1, K2 and K3 per step checked and no plain version
   run, a resume for 1 more with fp32 masters and moments; every K2 call of a
   batch-8 step against its plain version on that call's inputs; the ms per
   step and peak memory beside the plain bf16 path and the fp32 step; two
   steps' losses from the same weights on one batch in bf16 and in fp32;
20. kernels K7 and K9 in bf16 against their plain versions: K7 from bf16 K6's
   fp32 residuals (held equal, bit for bit, to those of K6's fp32 entry on the
   same values) at the shapes of [10] (B = 2 in both flavours, the noise
   levels, B = 8 at the 128 x 128 stages) and a ragged map, K9 at the shapes
   of [14]; twice for equal bits; ms per backward of the bf16 kernel beside
   the fp32 kernel, the plain bf16 version and the bf16 bound, and bf16 K6 and
   K8 per forward;
21. the mixed-precision training paths of the Restormer, PromptIR and SwinIR
   DCPT ymls with ``train:mixed_precision=true`` through ``train_pipeline`` at
   full width, batch 8, gt_size 128 on the PNGs of [7]: per net 1 iteration
   with a checkpoint, the launch counts of K6 / K7 / K3 (K8 / K9 / K3) per step
   checked and no plain version run, a resume for 1 more with fp32 masters
   and moments; every K7 (K9) call of a batch-8 step against its plain
   version; the ms per step and peak memory beside the fp32 step and the
   plain bf16 path; two steps' losses from the same weights on one batch in
   bf16 and in fp32 (Restormer and PromptIR also the first step's on the
   plain bf16 path, from its timed steps);
22. dcpt_tpu's standalone ops, which no net of dcpt_tpu calls, TF32 off: K11
   (``window_partition_fused`` / ``window_reverse_fused``) on SwinIR's 128 x
   128 x 180 map at B = 1 and 8, shifts 0 and 4, exact; K12
   (``fused_bias_leaky_relu``, forward and backward) at (8, 64, 64, 512); K14
   (``fused_ln_proj``) at the Restormer and PromptIR projections of a 128 x 128
   forward in both LayerNorm flavours; K5' (``naf_expand``) at NAFNet-w64's
   stages c <= 512; K13 (``mdta_attention``) at the Restormer and PromptIR
   attentions (and enc1 at B = 8); fp32 and bf16, a ragged shape each, every
   call twice for equal bits; each kernel's ms beside its plain version's, a
   library composite's and the bound (K13, K14 and K5' at 3xTF32 on the
   tensor cores, beside the SIMT fp32 one); the device time a call at B = 8
   of K11 beside the library composite's, of K14 and K5' by pass beside the
   library calls' passes, and of K13 by pass at (8, 48, 16384) and (4, 176,
   256) beside the library's, its launches a call checked.  Then the counted path: the shipped
   ``test_Restormer_5d.yml`` and ``test_PromptIR_5d.yml`` nets at full width
   on seeded weights, one 128 x 128 forward each with every TransformerBlock
   through ``_standalone_transformer_forward`` (88 / 94 K14 and 44 / 47 K13
   launches checked, the output within 1e-4 of the K6 route's), K11's round
   trip, K12 under autograd and K5' at the NAFNet stages;
23. DCPT's stage 2 and stage 3: the shipped ``train_NAFNet_dc_probe_5d.yml``
   (DCModel) and ``train_NAFNet_dcdist_5d.yml`` (DCDistModel) through
   ``train_pipeline`` at full width, batch 8, gt_size 128, from [7]'s stage-1
   snapshots, on synthetic sets whose dehaze set is JPEG (``run_probe_finetune``):
   the probe 3 iterations with a top-1 validation every 2, a SIGTERM during
   iteration 2 (2.state saved, the run returns) and ``--auto_resume`` to the end;
   the fine-tune 3 iterations with ``accumulate_steps`` 2 (one step in two),
   PSNR / SSIM on the EMA net after the final save; K1 / K2 / K3 launches of
   every run against the reckoned counts, both validations on the plain path
   (top-1 equal, PSNR within 1e-3 dB), the fine-tune's step gradients against
   the plain path (``check_step_gradients`` at batch 8, float64 at batch 2), one
   fp32 and one mixed step of each with the launches counted on their own (no
   plain version run in the mixed one), ms a step and peak memory of both in
   fp32 and bf16.

The entry points turn cuDNN's algorithm timing on
(``torch.backends.cudnn.benchmark``), as the reference's do; every phase from
[4] on runs with it.  [7] loads its batches with the yml's four loader
workers; the training phases after it load in the process
(``num_worker_per_gpu`` 0), which spares each ``train_pipeline`` run the
workers' start.

On the H100 machines torch.profiler at times stops recording device time for
the rest of a process.  A phase whose profile records none then runs once more
in a fresh process on the same card (``--serve``), and the later phases that
take a profile run in that same process, one after another (``run_phase``);
if a profile records none there too, one more fresh process takes that phase
and the later ones, and a profile there that records none fails the script.

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
PROBE_YML = ROOT / "options" / "all_in_one" / "train" / "train_NAFNet_dc_probe_5d.yml"
DIST_YML = ROOT / "options" / "all_in_one" / "train" / "train_NAFNet_dcdist_5d.yml"
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
    "naf_prefix": ("dcpt_tpu_torch/csrc/naf_prefix.cu", "dcpt_tpu/ops/naf_prefix.py:147"),
    "naf_ffn": ("dcpt_tpu_torch/csrc/naf_ffn.cu", "dcpt_tpu/ops/naf_ffn.py:169"),
    "window_partition_fused": ("dcpt_tpu_torch/csrc/window_process.cu", "dcpt_tpu/ops/window_process.py:47"),
    "window_reverse_fused": ("dcpt_tpu_torch/csrc/window_process.cu", "dcpt_tpu/ops/window_process.py:63"),
    "fused_bias_leaky_relu": ("dcpt_tpu_torch/csrc/fused_act.cu", "dcpt_tpu/ops/fused_act.py:78"),
    "fused_ln_proj": ("dcpt_tpu_torch/csrc/ln_proj.cu", "dcpt_tpu/ops/ln_proj.py:75"),
    "naf_expand": ("dcpt_tpu_torch/csrc/ln_proj.cu", "dcpt_tpu/ops/naf_ffn.py:131"),
    "mdta_attention": ("dcpt_tpu_torch/csrc/mdta.cu", "dcpt_tpu/ops/mdta.py:158"),
}
# the card's peaks (NVIDIA's H100 SXM data sheet): fp32 outside the tensor cores, TF32 and
# bf16 on the tensor cores (dense), HBM3.  K1, K2, K6, K7, K8, K9 and K10 compute fp32 products
# as three TF32 products (3xTF32), so their fp32 bound takes PEAK_TF32_FLOPS / 3.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# NAFNet-w64 (enc [1,1,1,28], middle 1, dec [1,1,1,1]) on a 128 x 128 input:
# (C, H = W, NAFBlocks at that stage)
STAGES = [(64, 128, 2), (128, 64, 2), (256, 32, 2), (512, 16, 29), (1024, 8, 1)]
RAGGED = [(64, 24, 40), (1024, 1, 1)]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
K2_TOL = 1e-3  # relative to max(1, max|ref|): weight gradients sum up to 131 k pixels in another order
K2_BATCH8 = (8, 64, 128, 128)  # (B, C, H, W): the train yml's batch at NAFNet-w64's first stage
# the classifier's LayerNorms at K3's gate in a batch-8 step: (rows, C) -> calls per step
K3_SHAPES = {(8192, 512): 4, (2048, 1024): 4, (2048, 512): 2, (512, 1024): 4, (512, 512): 2}
# rows wider than K3 holds in registers (C > 4096; no shipped net has them): checked and timed
# beside the step's shapes, with their own device functions and no calls in the step
K3_WIDE, K3_WIDE_FUNCTIONS = (512, 8192), {"ln2d_fwd_wide_kernel", "ln2d_bwd_wide_kernel", "ln2d_sum_kernel"}
TRAIN_ITERS, RESUME_ITERS = 4, 2
# the later training phases [11], [19] and [21] run the same paths, launches and checks at
# fewer steps: 1 iteration with a checkpoint, a resume for 1
SHORT_ITERS, SHORT_RESUME_ITERS = 1, 1
# per step of the DCPT yml's net: two forwards through all 36 NAFBlocks, a
# backward through 71 (decoder3.0's output feeds no 'ups' tap in the skip-tail pass)
K1_PER_STEP, K2_PER_STEP, K3_PER_STEP = 72, 71, sum(K3_SHAPES.values())
# K6's device functions; chunk_epi_kernel<6> runs only where a product is cut along its depth
K6_FUNCTIONS = {"ln_fwd_kernel<6>", "tc_gemm_kernel<6>", "mdta_dw_kernel", "mdta_gram_kernel", "colsum_kernel<6>",
                "mdta_attn_kernel", "mdta_av_kernel", "mdta_gate_kernel", "chunk_epi_kernel<6>"}
K7_FUNCTIONS = {"k7_pad_kernel", "tc_gemm_kernel<7>", "k7_gate_bwd_kernel", "k7_dw_bwd_kernel", "ln_bwd_kernel<7>",
                "k7_dattn_kernel", "k7_cspace_kernel", "k7_dqkv_kernel", "colsum_kernel<7>"}
# each kernel's device functions by name (``colsum_kernel<N>``, ``ln_bwd_kernel<N>`` and
# ``tc_gemm_kernel<N>`` are the shared passes as kernel N launches them)
DEVICE_FUNCTIONS = {
    "naf_block_fused": {"ln_fwd_kernel<1>", "tc_gemm_kernel<1>", "naf_gate_kernel<1>", "naf_sca_kernel",
                        "naf_scale_kernel", "chunk_epi_kernel<1>"},
    "naf_block_bwd": {"bwd_scale_kernel", "tc_gemm_kernel<2>", "bwd_f1_gate_kernel", "bwd_ln_kernel",
                      "bwd_a_scale_kernel", "bwd_sca_kernel", "bwd_sca_w_kernel", "bwd_d_kernel", "colsum_kernel<2>"},
    "layer_norm_2d": {"ln2d_fwd_kernel", "ln2d_bwd_kernel", "ln2d_sum_kernel"},
    "mdta_block_fused": K6_FUNCTIONS,
    "mdta_block_bwd": K7_FUNCTIONS,
    "fused_swin_block": {"swin_block_kernel"},
    "fused_window_attention": {"window_attention_kernel"},
    "swin_block_bwd": {"k9_ln_kernel", "tc_gemm_kernel<9>", "k9_attn_fwd_kernel", "k9_attn_bwd_kernel",
                       "ln_bwd_kernel<9>", "colsum_kernel<9>"},
    "naf_prefix": {"ln_fwd_kernel<4>", "tc_gemm_kernel<4>", "naf_gate_kernel<4>", "chunk_epi_kernel<4>"},
    "naf_ffn": {"ln_fwd_kernel<5>", "tc_gemm_kernel<5>", "chunk_epi_kernel<5>"},
}
# the device functions that run only where a product is cut along its depth
CUT_ONLY = {"chunk_epi_kernel<4>", "chunk_epi_kernel<5>", "chunk_epi_kernel<6>"}
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
# K4 and K5 at NAFNet-w64's c = 512 stage of a 128 x 128 input (16 x 16) at the eval's B = 1, B = 2
# and the train yml's B = 8, and a ragged 120 x 72 image's 15 x 9; 29 blocks per forward at that stage
K45_C, K45_CASES, K45_PER_FORWARD = 512, [(1, 16, 16), (2, 16, 16), (8, 16, 16), (1, 15, 9)], 29
# the DCPT_TPU_PALLAS=1 DCPT_TPU_NAF_BLOCK=0 eval: the module path, K4 and K5 at c = 512, K3 at the middle block
PALLAS_ENV = {"DCPT_TPU_PALLAS": "1", "DCPT_TPU_NAF_BLOCK": "0"}
K3_PER_FORWARD_MODULE = 2  # the c = 1024 middle block's two LayerNorm2d
# [22], dcpt_tpu's standalone ops, which no net of dcpt_tpu calls.  Limits relative to max(1, max|ref|):
# K11 exact; K12, K14 and K5' 1e-5 (fp32); K13 1e-4 (fp32, sums over up to 16 k pixels); 2e-2 in bf16
STANDALONE_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
K13_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
K11_CASES = [(1, 0), (1, 4), (8, 0), (8, 4)]  # (B, shift) on SwinIR's 128 x 128 x 180 map, ws 8
K12_SHAPE, K12_RAGGED = (8, 64, 64, 512), (3, 5, 37)  # StyleGAN2's width: no shipped net runs the op
K14_RAGGED = (37, 704, 70)  # (rows, C, C_out)
K5P_STAGES = [(c, s, n) for c, s, n in STAGES if c <= 512]  # NAFNet-w64's LN -> 1x1 expand, C -> 2C, B = 1
K5P_RAGGED = (135, 37, 70)
K13_RAGGED = (3, 37, 1000)  # (BH, c, L)
# per 128 x 128 forward through _standalone_transformer_forward: two K14 calls and one K13 call a TransformerBlock
STANDALONE_PER_FORWARD = {"Restormer": {"fused_ln_proj": 88, "mdta_attention": 44},
                          "PromptIR": {"fused_ln_proj": 94, "mdta_attention": 47}}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def build_kernels() -> list[float]:
    """One nvcc per source, all started together; returns each build's seconds."""
    from concurrent.futures import ThreadPoolExecutor

    from dcpt_tpu_torch.ops import cuda_build

    libs = list({Path(src).stem: [Path(src).name] for src, _ in KERNELS.values()}.items())  # one build a source
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


def k7_work(c: int, f: int, ch: int, pixels: int, batch: int, io: int = 4) -> tuple[float, float]:
    """(flops, bytes) of one K7 call: per pixel the products into pixel space and
    the weight gradients (6FC + 8C^2 multiply-adds), dattn's head blocks and the
    products with dgram and attn (4 C ch), and the depthwise backward's stencil
    and tap sums on 3C + 2F channels; x and dz read and dx written once a pixel
    (``io`` bytes an element: 4 in fp32, 2 in bf16), the forward's fp32 maps (t,
    qkv, o, y, u, g: 8C + 3F) read once a pixel; per image the Gram's head
    blocks, attn and the norms read; the weights read and their gradients
    written once (``io`` bytes an element)."""
    weights = 4 * c * c + 3 * f * c + 9 * (3 * c + 2 * f) + 4 * c + c // ch
    per_image = c * ch + c * c + 2 * c
    return (pixels * (2 * (6 * f * c + 8 * c * c + 4 * c * ch) + 36 * (3 * c + 2 * f)),
            io * (3 * pixels * c + 2 * weights) + 4 * (pixels * (8 * c + 3 * f) + batch * per_image))


def k8_work(c: int, hidden: int, tokens: int, pixels: int, io: int = 4) -> tuple[float, float]:
    """(flops, bytes) of one K8 call: per pixel the products qkv, proj, fc1 and fc2
    (3C^2 + C^2 + 2 C hidden multiply-adds) and the window attention's q k^T and
    attn . v (2 N C, N tokens a window); x read, z written and the weights read
    once, ``io`` bytes an element (4 in fp32, 2 in bf16)."""
    weights = 4 * c * c + 2 * c * hidden + 9 * c + hidden
    return pixels * 2 * (4 * c * c + 2 * c * hidden + 2 * tokens * c), io * (2 * pixels * c + weights)


def k10_work(c: int, tokens: int, pixels: int, io: int = 4) -> tuple[float, float]:
    """(flops, bytes) of one K10 call with its LayerNorm: per pixel qkv and proj
    (4 C^2 multiply-adds) and the attention (2 N C); x read, the branch written
    and the weights read once, ``io`` bytes an element."""
    return pixels * 2 * (4 * c * c + 2 * tokens * c), io * (2 * pixels * c + 4 * c * c + 6 * c)


def k9_work(c: int, hidden: int, tokens: int, pixels: int, io: int = 4) -> tuple[float, float]:
    """(flops, bytes) of one K9 call: per pixel the recomputed forward up to fc1
    (4C^2 + C hidden + 2 N C multiply-adds: qkv, proj, fc1 and the attention; no
    fc2, whose output the backward does not read) and the backward: the products
    into token space (4C^2 + 2 C hidden), the weight gradients (the same) and
    the attention's dattn, dv, dq and dk (4 N C); x and dz read, dx written, the
    weights read and their gradients written once, ``io`` bytes an element (4 in
    fp32, 2 in bf16)."""
    weights = 4 * c * c + 2 * c * hidden + 9 * c + hidden
    return pixels * 2 * (12 * c * c + 5 * c * hidden + 6 * tokens * c), io * (3 * pixels * c + 2 * weights)


def k3_work(rows: int, c: int, io: int = 4) -> tuple[float, float]:
    """(flops, bytes) of one LayerNorm forward plus backward, counting the bytes the
    function needs: x read and out written, then x and g read and gx written, ``io``
    bytes an element (4 in fp32, 2 in bf16); the mean and 1/sigma of each row
    written and read (fp32); w and b read, w read again, gw and gb written.  K3
    moves these bytes and its column partials (under 1 %)."""
    return 20 * rows * c, io * (5 * rows * c + 5 * c) + 16 * rows


def k4_work(c: int, pixels: int) -> tuple[float, float]:
    """(flops, bytes) of one K4 call: per pixel the expand's 2 C^2 and the 3x3
    stencil's 18 C multiply-adds; x read, g written and the weights read once
    (the expanded map K4 writes and reads back is its own overhead, not
    counted)."""
    return pixels * (4 * c * c + 36 * c), 4 * (2 * pixels * c + 2 * c * c + 24 * c)


def k5_work(c: int, rows: int) -> tuple[float, float]:
    """(flops, bytes) of one K5 call: per row the C x 2C and C x C products' 3 C^2
    multiply-adds; y read, z written and the weights read once (the hidden map
    between the products is K5's own overhead, not counted)."""
    return rows * 6 * c * c, 4 * (2 * rows * c + 3 * c * c + 6 * c)


def bound(calls, peak_flops: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    """The least time for calls = [(count, flops, bytes)], each call bound by the
    larger of its operations over the peak of their type (fp32; ``PEAK_BF16_FLOPS``
    for a bf16 function, whose products the tensor cores could take) and its
    bytes over the memory rate; and which of the two bounds most of that time."""
    ops = [n * f / peak_flops * 1e3 for n, f, _ in calls]
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


def module_views(p: list) -> list:
    """``random_block_params``' 18 tensors with the 1x1 and depthwise weights as a
    module passes them (``NAFBlock.op_args``): views of contiguous (out, in) and
    (2C, 3, 3) tensors, which a wrapper's transposes back copy for free."""
    p = list(p)
    for i in (2, 6, 8, 13, 15):
        p[i] = p[i].t().contiguous().t()
    p[4] = p[4].permute(2, 0, 1).contiguous().permute(1, 2, 0)
    return p


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
OWNED = ("colsum_kernel", "ln_bwd_kernel", "ln_fwd_kernel", "tc_gemm_kernel", "chunk_epi_kernel", "naf_gate_kernel")


def kernel_id(key: str) -> str:
    """A device function's name from a profiler key: ``void (anonymous
    namespace)::tc::tc_gemm_kernel<7, float, true, ...>(...)`` -> ``tc_gemm_kernel<7>``;
    template arguments are dropped but for the owner of a shared function (``OWNED``)."""
    key = key.replace("(anonymous namespace)::", "").replace("tc::", "")
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
    """K1 against its plain twin on the card at the stage and ragged shapes (B =
    2), in bf16 at two of them, and at the train yml's B = 8 at C = 64, 128 x 128
    and at the c = 512 stage, each call twice for equal bits; per-forward totals
    at B = 2 (CUDA events, and the device time as ``device_ms``) beside the
    bound on the tensor cores (3xTF32 at a third of the TF32 peak) and the SIMT
    fp32 bound (``simt_bound_ms``); the call at B = 8, C = 64 (``b8_*``, bf16
    beside it) and each B = 8 call's device time by pass (``swin_ab.pass_split``)."""
    import torch

    from dcpt_tpu_torch.ops.naf_block import _kernel_forward, naf_block_fused, naf_block_ref
    from dcpt_tpu_torch.tools.swin_ab import pass_split, print_split

    gen = torch.Generator().manual_seed(1)
    cases = [(2, c, s, s, "float32") for c, s, _ in STAGES] + [(2, c, h, w, "float32") for c, h, w in RAGGED]
    cases += [(2, 64, 128, 128, "bfloat16"), (2, 512, 16, 16, "bfloat16")]
    cases += [(8, 64, 128, 128, "float32"), (8, 512, 16, 16, "float32"), (8, 64, 128, 128, "bfloat16")]
    per_block, splits = {}, {}
    worst = {"float32": 0.0, "bfloat16": 0.0}
    print(f"  {'B':>2} {'C':>5} {'H':>4} {'W':>4} {'dtype':>9} {'max_abs':>10} {'rel':>10} {'kernel_ms':>10} "
          f"{'plain_ms':>10} {'train_ms':>10} {'device_ms':>10}  (kernel_ms, plain_ms, train_ms: CUDA events around "
          f"back-to-back calls; device_ms: the kernel's device time per call, torch.profiler)")
    for batch, c, h, w, dname in cases:
        dtype = getattr(torch, dname)
        x = torch.randn(batch, h, w, c, generator=gen).to(device="cuda", dtype=dtype)
        params = random_block_params(c, gen, dtype, "cuda")
        # the twin computes in fp32 on the same (rounded) inputs; the kernel's math is fp32 too
        xf, pf = x.float(), [p.float() for p in params]
        z = naf_block_fused(x, *params)
        again = naf_block_fused(x, *params)
        ref = naf_block_ref(xf, *pf)
        torch.cuda.synchronize()
        if z.shape != x.shape or z.dtype != dtype or not torch.isfinite(z).all():
            raise RuntimeError(f"K1 B={batch} C={c} {h}x{w} {dname}: bad output {z.shape} {z.dtype}")
        if not torch.equal(z, again):
            raise RuntimeError(f"K1 B={batch} C={c} {h}x{w} {dname}: two runs on the same inputs differ")
        err = (z.float() - ref).abs().max().item()
        rel = err / max(1.0, ref.abs().max().item())
        kernel = lambda: naf_block_fused(x, *params)  # noqa: E731
        k_ms = cuda_ms(kernel)
        p_ms = cuda_ms(lambda: naf_block_ref(x, *params))
        # a call at the deep stages is a few microseconds of device work a launch: time the device too
        stage = batch == 2 and dname == "float32" and h == w and (c, h) in {(sc, ss) for sc, ss, _ in STAGES}
        d_ms = sum(device_ms_by_function(kernel, 10)[0].values()) if stage else float("nan")
        # the differentiated forward, which also writes the residuals K2 reads (fp32 only)
        t_ms = cuda_ms(lambda: _kernel_forward(x, params, 1e-6, residuals=True)) if dname == "float32" else float("nan")
        print(f"  {batch:>2} {c:>5} {h:>4} {w:>4} {dname:>9} {err:>10.3e} {rel:>10.3e} {k_ms:>10.4f} {p_ms:>10.4f} "
              f"{t_ms:>10.4f} {d_ms:>10.4f}", flush=True)
        if rel > TOL[dname]:
            raise RuntimeError(f"K1 B={batch} C={c} {h}x{w} {dname}: error {rel:.3e} above {TOL[dname]:.0e}")
        worst[dname] = max(worst[dname], err)
        per_block[(batch, c, h, w, dname)] = (k_ms, p_ms, d_ms)
        if batch == 8:
            splits[(c, dname)] = pass_split(kernel)
            print_split(f"  K1 at B={batch}, C={c}, {h}x{w}, {dname}, by pass", splits[(c, dname)])
            if not splits[(c, dname)]:
                raise NoDeviceTime("torch.profiler recorded no device time for K1's passes")
        del z, again, ref
    print("  K1 twice on the same inputs: equal bit for bit at every shape", flush=True)
    # one NAFNet-w64 forward at B = 2, 128 x 128: every stage's blocks
    ms = sum(n * per_block[(2, c, s, s, "float32")][0] for c, s, n in STAGES)
    plain_ms = sum(n * per_block[(2, c, s, s, "float32")][1] for c, s, n in STAGES)
    device_ms = sum(n * per_block[(2, c, s, s, "float32")][2] for c, s, n in STAGES)
    work = [(n, *k1_work(c, 2 * s * s)) for c, s, n in STAGES]
    bound_ms, bound_by = bound(work, PEAK_TF32_FLOPS / 3)
    b8_work = [(1, *k1_work(64, 8 * 128 * 128))]
    b8 = per_block[(8, 64, 128, 128, "float32")]
    return {"max_abs_err": worst["float32"], "bf16_max_abs_err": worst["bfloat16"], "ms": ms, "plain_ms": plain_ms,
            "device_ms": device_ms, "bound_ms": bound_ms, "bound_by": bound_by, "simt_bound_ms": bound(work)[0],
            "library_ms": None,
            "b8_ms": b8[0], "b8_plain_ms": b8[1], "b8_bf16_ms": per_block[(8, 64, 128, 128, "bfloat16")][0],
            "b8_bound_ms": bound(b8_work, PEAK_TF32_FLOPS / 3)[0], "b8_simt_bound_ms": bound(b8_work)[0],
            "b8_c512_ms": per_block[(8, 512, 16, 16, "float32")][0], "b8_split": splits[(64, "float32")]}


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
    from K1's residuals, and at the train yml's B = 8 at C = 64, 128 x 128; K2
    run twice gives the same bits; per-backward totals (CUDA events) beside the
    bound on the tensor cores (3xTF32 at a third of the TF32 peak) and the SIMT
    fp32 bound (``simt_bound_ms``); the call at B = 8 (``b8_*``) and its device
    time by pass (``swin_ab.pass_split``)."""
    import torch

    from dcpt_tpu_torch.ops.naf_block import _kernel_forward
    from dcpt_tpu_torch.ops.naf_block_bwd import naf_block_bwd, naf_block_bwd_ref
    from dcpt_tpu_torch.tools.swin_ab import pass_split, print_split

    gen = torch.Generator().manual_seed(5)
    per_block, worst = {}, 0.0
    print(f"  {'B':>2} {'C':>5} {'H':>4} {'W':>4} {'max_abs':>10} {'rel':>10} {'kernel_ms':>10} {'plain_ms':>10}")
    for batch, c, h, w in [(2, c, s, s) for c, s, _ in STAGES] + [(2, *r) for r in RAGGED] + [K2_BATCH8]:
        x = torch.randn(batch, h, w, c, generator=gen).cuda()
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
            raise RuntimeError(f"K2 B={batch} C={c} {h}x{w}: cotangent {rels.index(max(rels))} error "
                               f"{max(rels):.3e} above {K2_TOL:.0e}")
        again = naf_block_bwd(x, *params, pooled, att, dz, maps)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise RuntimeError(f"K2 B={batch} C={c} {h}x{w}: two runs on the same inputs differ")
        k_ms = cuda_ms(lambda: naf_block_bwd(x, *params, pooled, att, dz, maps))
        p_ms = cuda_ms(lambda: naf_block_bwd_ref(x, *params, pooled, att, dz))
        print(f"  {batch:>2} {c:>5} {h:>4} {w:>4} {max(errs):>10.3e} {max(rels):>10.3e} {k_ms:>10.4f} {p_ms:>10.4f}",
              flush=True)
        worst = max(worst, max(errs))
        per_block[(batch, c, h, w)] = (k_ms, p_ms)
        if (batch, c, h, w) == K2_BATCH8:
            split = pass_split(lambda: naf_block_bwd(x, *params, pooled, att, dz, maps))
            print_split(f"  K2 at B={batch}, C={c}, {h}x{w}, fp32, by pass", split)
            if not split:
                raise NoDeviceTime("torch.profiler recorded no device time for K2's passes")
        del got, again, ref
    print("  K2 twice on the same inputs: equal bit for bit at every shape", flush=True)
    # one backward through NAFNet-w64's 36 blocks at B = 2, 128 x 128
    work = [(n, *k2_work(c, 2 * s * s)) for c, s, n in STAGES]
    bound_ms, bound_by = bound(work, PEAK_TF32_FLOPS / 3)
    b8_work = [(1, *k2_work(K2_BATCH8[1], K2_BATCH8[0] * K2_BATCH8[2] * K2_BATCH8[3]))]
    return {"max_abs_err": worst, "ms": sum(n * per_block[(2, c, s, s)][0] for c, s, n in STAGES),
            "plain_ms": sum(n * per_block[(2, c, s, s)][1] for c, s, n in STAGES), "bound_ms": bound_ms,
            "bound_by": bound_by, "simt_bound_ms": bound(work)[0], "library_ms": None,
            "b8_ms": per_block[K2_BATCH8][0], "b8_plain_ms": per_block[K2_BATCH8][1],
            "b8_bound_ms": bound(b8_work, PEAK_TF32_FLOPS / 3)[0], "b8_simt_bound_ms": bound(b8_work)[0],
            "b8_split": split}


def k3_shapes(dtype_name: str, gen) -> dict:
    """K3 forward + backward at the classifier's row shapes (K3_SHAPES) and at
    K3_WIDE in one dtype against its plain version and F.layer_norm + its
    backward, each call twice for equal bits; per shape and summed per step (the
    shape's calls, none for K3_WIDE):
    device time (``ms``, ``plain_ms``, ``library_ms``; torch.profiler) and CUDA
    events around back-to-back calls (``call_ms``, ``library_call_ms``), and
    the bound (bf16: bytes at 2 an element, products at the bf16 peak)."""
    import torch
    import torch.nn.functional as F

    from dcpt_tpu_torch.ops import layernorm2d as ln

    dtype = getattr(torch, dtype_name)
    io, peak = (4, PEAK_FP32_FLOPS) if dtype == torch.float32 else (2, PEAK_BF16_FLOPS)
    tol = TOL[dtype_name]
    out = {k: 0.0 for k in ("ms", "plain_ms", "library_ms", "call_ms", "library_call_ms", "max_abs_err")}
    print(f"  K3 {dtype_name}: {'rows':>5} {'C':>5} {'calls':>5} {'rel_err':>10} {'lib_err':>10} {'kernel_ms':>10} "
          f"{'plain_ms':>10} {'library_ms':>10} {'call_ms':>10} {'lib_call':>10} {'bound_ms':>10}  (ms per forward + "
          f"backward: device time by torch.profiler; call, lib_call: CUDA events around back-to-back calls)")
    for (rows, c), calls in {**K3_SHAPES, K3_WIDE: 0}.items():
        x = (torch.randn(rows, c, generator=gen) * 2 + 0.5).to("cuda", dtype)
        w, b = (torch.randn(c, generator=gen).to("cuda", dtype) for _ in range(2))
        g = torch.randn(rows, c, generator=gen).to("cuda", dtype)
        lib = ln._lib()

        def kernel():
            out, mean, rsig = ln._launch_fwd(lib, x, w, b, 1e-6, ln._stream(), residuals=True)
            return (out, *ln._launch_bwd(lib, x, mean, rsig, g, w, ln._stream()))

        def plain():
            out, y, rsig = ln.layer_norm_2d_ref(x, w, b, 1e-6)
            return (out, *ln.layer_norm_2d_bwd_ref(g, y, rsig, w))

        xl, wl, bl = (t.clone().requires_grad_() for t in (x, w, b))

        def library():
            out = F.layer_norm(xl, (c,), wl, bl, 1e-6)
            return (out, *torch.autograd.grad(out, (xl, wl, bl), g))

        got, again, ref, lib_out = kernel(), kernel(), plain(), library()
        torch.cuda.synchronize()
        if not all(a.dtype == dtype and torch.isfinite(a).all() and torch.equal(a, r) for a, r in zip(got, again)):
            raise RuntimeError(f"K3 {dtype_name} ({rows}, {c}): not {dtype_name}, not finite, or two runs differ")
        rel = max(_rel_errs(got, ref))
        lib_rel = max(_rel_errs(got, lib_out))
        if rel > tol or lib_rel > tol:
            raise RuntimeError(f"K3 {dtype_name} ({rows}, {c}): error {rel:.3e} against plain, {lib_rel:.3e} against "
                               f"F.layer_norm, limit {tol:.0e}")
        funcs = device_ms_by_function(kernel, 20)[0]
        want = K3_WIDE_FUNCTIONS if (rows, c) == K3_WIDE else DEVICE_FUNCTIONS["layer_norm_2d"]
        if set(funcs) != want:
            raise RuntimeError(f"K3's profile shows {sorted(funcs)}, expected {sorted(want)}")
        times = {"ms": sum(funcs.values()), "plain_ms": sum(device_ms_by_function(plain, 20)[0].values()),
                 "library_ms": sum(device_ms_by_function(library, 20)[0].values()),
                 "call_ms": cuda_ms(kernel, 50), "library_call_ms": cuda_ms(library, 50)}
        b_ms = bound([(1, *k3_work(rows, c, io))], peak)[0]
        print(f"  {' ' * len(dtype_name)}    {rows:>5} {c:>5} {calls:>5} {rel:>10.3e} {lib_rel:>10.3e} "
              + " ".join(f"{times[k]:>10.4f}" for k in ("ms", "plain_ms", "library_ms", "call_ms", "library_call_ms"))
              + f" {b_ms:>10.4f}", flush=True)
        for k, v in times.items():
            out[k] += calls * v
        out["max_abs_err"] = max(out["max_abs_err"], max((a.float() - r.float()).abs().max().item()
                                                         for a, r in zip(got, ref)))
    out["bound_ms"], out["bound_by"] = bound([(n, *k3_work(rows, c, io)) for (rows, c), n in K3_SHAPES.items()], peak)
    return out


def check_k3() -> dict:
    """K3 forward + backward in fp32 against the plain versions and F.layer_norm at
    the classifier's row shapes; per-step totals (16 calls each way)."""
    import torch

    return k3_shapes("float32", torch.Generator().manual_seed(6))


def write_train_sets(root: Path, n: int = 8, size: int = 160, jpeg_dehaze: bool = False, phase: str = "train",
                     seed: int = 7) -> list[str]:
    """n synthetic size x size PNGs (pairs where the dataset has an lq folder) per
    dataset of the train yml; returns the --force_yml dataroot overrides of
    ``datasets:<phase>``.  With ``jpeg_dehaze`` the dehaze set is written as
    JPEGs through cv2, as the shipped ymls' ``.jpg`` suffix reads it."""
    import numpy as np

    from dcpt_tpu_torch.utils.img_util import imwrite
    from dcpt_tpu_torch.utils.options import yaml_load

    def write(img, path: Path):
        if path.suffix == ".jpg":
            import cv2

            path.parent.mkdir(parents=True, exist_ok=True)
            cv2.imwrite(str(path), img, [cv2.IMWRITE_JPEG_QUALITY, 95])
        else:
            imwrite(img, str(path))

    rng = np.random.default_rng(seed)
    force = []
    yy, xx = np.mgrid[0:size, 0:size] / size
    for key, ds in yaml_load(str(TRAIN_YML))["datasets"]["train"]["datasets"].items():
        gt_dir, lq_dir = root / key / "gt", root / key / "lq"
        ext = ".jpg" if jpeg_dehaze and ds["type"] == "PairedImageDehazeDataset" else ".png"
        for i in range(n):
            base = 0.5 + 0.4 * np.sin(2 * np.pi * (rng.random(3) * 3 * yy[..., None] + rng.random(3) * 3 * xx[..., None]))
            gt = np.clip(base + rng.normal(0, 0.02, (size, size, 3)), 0, 1)
            write((gt * 255).round().astype(np.uint8), gt_dir / f"img{i}{ext}")
            if "dataroot_lq" in ds:
                lq = np.clip(0.7 * gt + 0.15 + rng.normal(0, 0.05, gt.shape), 0, 1)
                name = f"img{i}_hazy{ext}" if ds["type"] == "PairedImageDehazeDataset" else f"img{i}.png"
                write((lq * 255).round().astype(np.uint8), lq_dir / name)
        force.append(f"datasets:{phase}:datasets:{key}:dataroot_gt={gt_dir}")
        if "dataroot_lq" in ds:
            force.append(f"datasets:{phase}:datasets:{key}:dataroot_lq={lq_dir}")
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


def grad_batch(batch_size: int, seed: int = 8) -> dict:
    """A seeded DCPT batch of batch_size 128 x 128 images on the host."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    gt = torch.rand(batch_size, 3, 128, 128, generator=gen)
    return {"gt": gt, "lq": (0.7 * gt + 0.15 + 0.05 * torch.randn(gt.shape, generator=gen)).clamp(0, 1),
            "dataset_idx": torch.arange(batch_size) % 5}


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


def check_step_gradients(model, label: str = "[7]", batch_size: int = 8, float64_batch: int = 8) -> dict:
    """One DCPT step's gradients of net_g and net_dc on the same weights:

    * with the switches smoothed (``smooth_switches``), at ``batch_size``: the
      kernel path against the plain path in fp32, every gradient within 1e-3
      of the tensor's max|ref|, plus 1e-6 of the step's largest gradient (a
      sum's rounding scales with its terms, not with the sum, and a
      temperature's gradient cancels to a thousandth of them), plus three
      times the plain path's own spread from run to run (some of the step's
      PyTorch ops are not deterministic on the card);
    * the network as it is, at ``float64_batch``: the kernel path's fp32
      gradients against the plain path in float64, each tensor within
      ``max(1e-3 of its max|ref|, K x its rounding sensitivity)``, the median
      within max(2e-2, 2 x the plain fp32 runs' own median) and each loss within
      ``max(1e-5, K x the plain fp32 runs' own departure from float64)``
      (``dcpt_tpu_torch.tools.grad_check``: the sensitivity is the largest
      departure from float64 of the plain fp32 step run as it is and on
      parameters and inputs moved by one ulp, large where sums cancel or ReLU
      and max-pool switches sit near their edge; the kernel path's error is
      the median of its runs the same five ways).

    Returns the kernel path's float64 report."""
    import torch

    from dcpt_tpu_torch.tools import grad_check

    def over(e):
        return sum(v > 1e-3 for v in e.values())

    batch = grad_batch(batch_size)
    with smooth_switches(model):
        kernel, _ = grad_check.step_grads(model, batch)
        with plain_path():
            plain, _ = grad_check.step_grads(model, batch)
            again, _ = grad_check.step_grads(model, batch)
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
    ref, ref_losses, sens, plain_loss, plain_median = float64_reference(model, batch)
    kernel_errs, kernel_losses = grad_check.run_errors(model, batch, ref)
    model.feed_data(batch)
    report = grad_check.compare(grad_check.path_error(kernel_errs), kernel_losses, ref, ref_losses, sens,
                                plain_loss=plain_loss, plain_median=plain_median)
    as_is = grad_check.compare(kernel_errs[0], kernel_losses, ref, ref_losses, sens, plain_loss=plain_loss,
                               plain_median=plain_median)
    srel = sorted(sens[n] / max(g.abs().max().item(), 1e-30) for n, g in ref.items())
    runs = len(kernel_errs)
    print(f"{label} the network as it is, batch {float64_batch}, {len(ref)} gradients against the plain path in "
          f"float64 (K {grad_check.K}; each tensor's rounding sensitivity the largest error of {runs} plain fp32 runs, "
          f"as it is and on one-ulp perturbations, median {srel[len(srel) // 2]:.3e} and largest {srel[-1]:.3e} of "
          f"max|ref|): kernel path, the median of its {runs} runs: {grad_check.describe(report)}; its run as it is "
          f"alone: worst {as_is['worst_rel']:.3e} ({as_is['worst']}), {as_is['worst_ratio']:.3f} of its limit; losses "
          f"kernel {kernel_losses}, float64 {ref_losses}; the plain fp32 runs' own loss departures from float64 "
          f"{_fmt(plain_loss)} (each loss's limit max({grad_check.LOSS_TOL:.0e}, K x its departure)); their own "
          f"median error {plain_median:.3e} (the median's limit max({grad_check.MEDIAN:.0e}, "
          f"{grad_check.MEDIAN_K} x it))", flush=True)
    if not ks[ks_name] <= 1:
        raise RuntimeError(f"gradient {ks_name} through the kernels differs from the plain path by {rel[ks_name]:.3e} "
                           f"of its max|ref|, {ks[ks_name]:.3f} of its limit")
    if not report["ok"]:
        raise RuntimeError(f"{label} kernel path against float64: {grad_check.describe(report)}")
    return dict(report, sens_median=srel[len(srel) // 2], sens_max=srel[-1], as_is_ratio=as_is["worst_ratio"],
                plain_loss=plain_loss)


def _fmt(values: dict) -> str:
    return ", ".join(f"{k} {v:.3e}" for k, v in values.items())


def float64_reference(model, batch: dict) -> tuple[dict, dict, dict, dict, float]:
    """The plain path's step on ``batch`` in float64: its gradients and losses,
    each tensor's rounding sensitivity from five plain fp32 runs
    (``dcpt_tpu_torch.tools.grad_check``), each loss's largest departure
    in those runs from float64, which sets that loss's limit
    (``grad_check.compare``), and the plain runs' own median error over
    tensors, which sets the limit of a kernel path's median:
    max(``MEDIAN``, ``MEDIAN_K`` x it)."""
    import torch

    from dcpt_tpu_torch.tools import grad_check

    runs_losses = []
    with plain_path():
        ref, ref_losses = grad_check.step_grads(model, batch, torch.float64)
        plain_errs = grad_check.run_errors(model, batch, ref, runs_losses=runs_losses)[0]
    return (ref, ref_losses, grad_check.rounding_sensitivity(plain_errs), grad_check.loss_departure(runs_losses, ref_losses),
            grad_check.median_rel(grad_check.path_error(plain_errs), ref))


def check_bwd_in_step(model, label: str, function, ref, tol: float, calls: int | None = None,
                      batch_size: int = 8, tensors=lambda grads: (grads[0], *grads[5:]),
                      config=lambda ctx: tuple(ctx.config)) -> float:
    """One DCPT step at ``batch_size`` with every backward of the autograd
    ``function`` (K7's ``MDTABlockFunction``, K9's ``SwinBlockFunction``, K2's
    ``NAFBlockFunction``) held against its plain version ``ref(x, saved, dz,
    config)`` on that call's own inputs: the block's input and saved tensors,
    its configuration and the upstream dz of the real step, at the shapes, in
    the flavour and in the dtype the train yml gives them (``tensors`` picks the
    cotangents from the backward's outputs).  Limit ``tol`` relative to max(1,
    max|ref|) on each cotangent, and ``calls`` calls when given; returns the
    worst error."""
    import torch

    real_backward = function.backward
    errs = []

    def backward(ctx, dz):
        grads = real_backward(ctx, dz)
        x, *saved = ctx.saved_tensors
        want = ref(x, saved, dz.contiguous(), config(ctx))
        errs.append((max((a.float() - r.float()).abs().max().item() / max(1.0, r.float().abs().max().item())
                         for a, r in zip(tensors(grads), want)), tuple(x.shape), config(ctx)))
        return grads

    with mock.patch.object(function, "backward", staticmethod(backward)):
        model.feed_data(grad_batch(batch_size))
        model.compute_gradients()
    torch.cuda.synchronize()
    worst, shape, cfg = max(errs)
    print(f"{label} {function.__name__} backward inside a DCPT step at batch {batch_size}: {len(errs)} calls, each "
          f"against its plain version on its own inputs: worst {worst:.3e} (at {shape}, config {cfg}; limit "
          f"{tol:.0e} relative to max(1, max|ref|))", flush=True)
    if (calls is not None and len(errs) != calls) or not worst <= tol:
        raise RuntimeError(f"{function.__name__} inside the step: {len(errs)} calls (expected {calls}), worst error "
                           f"{worst:.3e} at {shape} (limit {tol:.0e})")
    return worst


def ms_per_step(model, iters: int, first: list | None = None) -> tuple[float, float]:
    """Host clock around ``iters`` optimizer steps ended by a synchronize, after one
    warm-up step (its losses appended to ``first`` when given); and the peak
    device memory of those steps in MiB."""
    import torch

    model.optimize_parameters(0)
    if first is not None:
        first.append(dict(model.log_dict))
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

    grad64 = check_step_gradients(resumed)
    step_profile(resumed, ["naf_block_fused", "naf_block_bwd", "layer_norm_2d"])
    step_ms, peak = ms_per_step(resumed, 5)
    with plain_path():
        plain_step_ms, plain_peak = ms_per_step(resumed, 3)
    print(f"[7] DCPT step at batch 8, 128 x 128, fp32: kernel path {step_ms:.2f} ms/step (peak {peak:.0f} MiB), "
          f"plain path {plain_step_ms:.2f} ms/step (peak {plain_peak:.0f} MiB)", flush=True)
    return {"launches": launches, "step_ms": step_ms, "plain_step_ms": plain_step_ms, "peak_mib": peak,
            "force": force, "grad64": grad64}

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
    ragged shapes in both flavours (B = 1), in bf16 at two stages, and at the
    train ymls' B = 8 at the 128 x 128 stages (fp32 in both flavours, bf16 in
    Restormer's), each call twice for equal bits; totals per Restormer and per
    PromptIR forward at 128 x 128: device time (``ms``, ``plain_ms``) and CUDA
    events around back-to-back calls (``call_ms``) beside the bound on the
    tensor cores (3xTF32 at a third of the TF32 peak) and the SIMT fp32 bound
    (``simt_bound_ms``); the call at B = 8, C = 48, ReLU (``b8_*``) and each
    B = 8 call's device time by pass (``swin_ab.pass_split``)."""
    import torch

    from dcpt_tpu_torch.ops.mdta_block import mdta_block_fused, mdta_block_ref
    from dcpt_tpu_torch.tools.swin_ab import pass_split, print_split

    gen = torch.Generator().manual_seed(9)
    names = {RESTORMER_FLAVOUR: "relu", PROMPTIR_FLAVOUR: "softmax"}
    cases = [(1, s, s, c, heads, RESTORMER_FLAVOUR, "float32") for c, s, heads in K6_BODY]
    cases += [(1, s, s, c, heads, PROMPTIR_FLAVOUR, "float32") for c, s, heads in [*K6_BODY, *K6_NOISE]]
    cases += [(1, h, w, c, heads, fl, "float32") for h, w, c, heads in K6_RAGGED for fl in names]
    cases += [(1, s, s, c, heads, fl, "bfloat16") for c, s, heads in [(48, 128, 1), (384, 16, 8)] for fl in names]
    cases += [(8, s, s, c, heads, fl, "float32") for c, s, heads in K7_BATCH8 for fl in names]
    cases += [(8, s, s, c, heads, RESTORMER_FLAVOUR, "bfloat16") for c, s, heads in K7_BATCH8[:1]]
    times, worst, splits = {}, {"float32": 0.0, "bfloat16": 0.0}, {}
    print(f"  {'B':>2} {'C':>4} {'H':>4} {'W':>4} {'heads':>5} {'act':>7} {'dtype':>9} {'max_abs':>10} {'rel':>10} "
          f"{'kernel_ms':>10} {'plain_ms':>10} {'call_ms':>10} {'plain_call':>10} {'bound_ms':>10} {'simt_bound':>10}  "
          f"(kernel_ms, plain_ms: device time per call, torch.profiler; call_ms: CUDA events around back-to-back "
          f"calls; bound_ms: 3xTF32 on the tensor cores; simt_bound: fp32 outside them)")
    with torch.no_grad():
        for batch, h, w, c, heads, flavour, dname in cases:
            dtype = getattr(torch, dname)
            x = torch.randn(batch, h, w, c, generator=gen).to(device="cuda", dtype=dtype)
            params = mdta_params(c, heads, gen, dtype, "cuda")
            z = mdta_block_fused(x, *params, heads, *flavour)
            again = mdta_block_fused(x, *params, heads, *flavour)
            # the plain version computes in fp32 on the same (rounded) inputs; the kernel's math is fp32 too
            ref = mdta_block_ref(x.float(), *[p.float() for p in params], heads, *flavour)
            torch.cuda.synchronize()
            label = f"K6 B={batch} C={c} {h}x{w} {names[flavour]} {dname}"
            if z.shape != x.shape or z.dtype != dtype or not torch.isfinite(z).all():
                raise RuntimeError(f"{label}: bad output {tuple(z.shape)} {z.dtype}")
            if not torch.equal(z, again):
                raise RuntimeError(f"{label}: two runs on the same inputs differ")
            err = (z.float() - ref).abs().max().item()
            rel = err / max(1.0, ref.abs().max().item())
            kernel = lambda: mdta_block_fused(x, *params, heads, *flavour)  # noqa: E731
            plain = lambda: mdta_block_ref(x, *params, heads, *flavour)  # noqa: E731
            # each call is a few hundred microseconds of host work (allocations, a dozen launches),
            # so CUDA events around back-to-back calls can measure the host: time the device too
            k_funcs = device_ms_by_function(kernel, 10)[0]
            if not K6_FUNCTIONS - CUT_ONLY <= set(k_funcs) <= K6_FUNCTIONS:
                raise RuntimeError(f"{label}: the profile shows {sorted(k_funcs)}, expected "
                                   f"{sorted(K6_FUNCTIONS - CUT_ONLY)} and at most {sorted(K6_FUNCTIONS & CUT_ONLY)} "
                                   f"besides")
            k_ms, p_ms = sum(k_funcs.values()), sum(device_ms_by_function(plain, 10)[0].values())
            k_call, p_call = cuda_ms(kernel), cuda_ms(plain)
            work = [(1, *k6_work(c, int(2.66 * c), c // heads, batch * h * w))]
            b_ms, simt_ms = bound(work, PEAK_TF32_FLOPS / 3)[0], bound(work)[0]
            print(f"  {batch:>2} {c:>4} {h:>4} {w:>4} {heads:>5} {names[flavour]:>7} {dname:>9} {err:>10.3e} "
                  f"{rel:>10.3e} {k_ms:>10.4f} {p_ms:>10.4f} {k_call:>10.4f} {p_call:>10.4f} {b_ms:>10.4f} "
                  f"{simt_ms:>10.4f}", flush=True)
            if rel > TOL[dname]:
                raise RuntimeError(f"{label}: error {rel:.3e} above {TOL[dname]:.0e}")
            worst[dname] = max(worst[dname], rel)
            if dname == "float32" and h == w and batch == 1:
                times[(c, h, heads, flavour)] = (k_ms, p_ms, k_call, p_call)
            if batch == 8:
                times[(8, c, flavour, dname)] = (k_ms, p_ms, k_call, p_call, b_ms, simt_ms)
                splits[(c, flavour, dname)] = pass_split(kernel)
                print_split(f"  K6 at B=8, C={c}, {h}x{w}, {names[flavour]}, {dname}, by pass",
                            splits[(c, flavour, dname)])
                if not splits[(c, flavour, dname)]:
                    raise NoDeviceTime("torch.profiler recorded no device time for K6's passes")
            del z, again, ref
    print("  K6 twice on the same inputs: equal bit for bit at every shape", flush=True)
    per_net = {"Restormer": [(n, key, RESTORMER_FLAVOUR) for key, n in K6_BODY.items()],
               "PromptIR": [(n, key, PROMPTIR_FLAVOUR) for key, n in [*K6_BODY.items(), *K6_NOISE.items()]]}
    c8 = K7_BATCH8[0][0]
    b8 = times[(8, c8, RESTORMER_FLAVOUR, "float32")]
    out = {"max_abs_err": worst["float32"], "bf16_rel_err": worst["bfloat16"], "library_ms": None, "b8_ms": b8[0],
           "b8_plain_ms": b8[1], "b8_call_ms": b8[2], "b8_bound_ms": b8[4], "b8_simt_bound_ms": b8[5],
           "b8_bf16_ms": times[(8, c8, RESTORMER_FLAVOUR, "bfloat16")][0],
           "b8_split": splits[(c8, RESTORMER_FLAVOUR, "float32")]}
    for net, blocks in per_net.items():
        work = [(n, *k6_work(c, int(2.66 * c), c // heads, s * s)) for n, (c, s, heads), _ in blocks]
        bound_ms, bound_by = bound(work, PEAK_TF32_FLOPS / 3)
        ms, plain_ms, call_ms, plain_call_ms = (sum(n * times[(*key, fl)][i] for n, key, fl in blocks)
                                                for i in range(4))
        prefix = "" if net == "Restormer" else "promptir_"
        out.update({f"{prefix}ms": ms, f"{prefix}plain_ms": plain_ms, f"{prefix}call_ms": call_ms,
                    f"{prefix}plain_call_ms": plain_call_ms, f"{prefix}bound_ms": bound_ms,
                    f"{prefix}bound_by": bound_by, f"{prefix}simt_bound_ms": bound(work)[0]})
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


def _standalone_transformer_forward(self, inp):
    """TransformerBlock.forward (PromptTransformerBlock's too) through dcpt_tpu's
    standalone ops, the composition its ``test_mdta_pre_norm_path_matches`` and
    ``test_restormer_with_pallas_mdta_matches`` assert: ``x + MDTA'(x,
    pre_norm=norm1)``, then ``+ GDFN(., pre_norm=norm2)``, where the qkv and
    project_in 1x1s are K14 (``fused_ln_proj``) and MDTA''s attention is K13
    (``mdta_attention``) on its q, k, v.  A harness, not a shipped route."""
    from dcpt_tpu_torch.ops.mdta import mdta_attention

    attn = self.attn
    b, c, h, w = inp.shape
    heads = attn.num_heads
    q, k, v = attn.qkv_heads(inp, (*self.norm1.affine(), self.norm1.eps, not self.norm1.with_bias))
    t = attn.temperature.reshape(1, heads).expand(b, heads).reshape(b * heads)
    o = mdta_attention(*(u.reshape(b * heads, c // heads, h * w) for u in (q, k, v)), t, attn.use_softmax)
    x = inp + attn.project_out(o.reshape(b, c, h, w))
    return x + self.ffn(x, pre_norm=(*self.norm2.affine(), self.norm2.eps, not self.norm2.with_bias))


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
    CUDA events around back-to-back calls (``call_ms``) beside the bound on the
    tensor cores (3xTF32 at a third of the TF32 peak) and the SIMT fp32 bound
    (``simt_bound_ms``); each B = 8 call's device time by pass
    (``swin_ab.pass_split``; ``b8_split`` the Restormer flavour's at C = 48)."""
    import torch

    from dcpt_tpu_torch.ops.mdta_block import _kernel_forward
    from dcpt_tpu_torch.ops.mdta_block_bwd import mdta_block_bwd, mdta_block_bwd_ref
    from dcpt_tpu_torch.tools.swin_ab import pass_split, print_split

    gen = torch.Generator().manual_seed(12)
    names = {RESTORMER_FLAVOUR: "relu", PROMPTIR_FLAVOUR: "softmax"}
    cases = [(s, s, c, heads, fl) for fl in names for c, s, heads in K6_BODY]
    cases += [(s, s, c, heads, PROMPTIR_FLAVOUR) for c, s, heads in K6_NOISE]
    cases += [(h, w, c, heads, fl) for h, w, c, heads in K7_RAGGED for fl in names]
    cases = [(2, *case) for case in cases] + [(8, s, s, c, heads, fl) for c, s, heads in K7_BATCH8 for fl in names]
    times, worst, splits = {}, 0.0, {}
    print(f"  {'B':>2} {'C':>4} {'H':>4} {'W':>4} {'heads':>5} {'act':>7} {'max_abs':>10} {'rel':>10} {'kernel_ms':>10} "
          f"{'plain_ms':>10} {'call_ms':>10} {'plain_call':>10} {'bound_ms':>10} {'simt_bound':>10}  (kernel_ms, "
          f"plain_ms: device time per call, torch.profiler; call_ms: CUDA events around back-to-back calls; bound_ms: "
          f"3xTF32 on the tensor cores; simt_bound: fp32 outside them)")
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
        work = [(1, *k7_work(c, int(2.66 * c), c // heads, batch * h * w, batch))]
        b_ms, simt_ms = bound(work, PEAK_TF32_FLOPS / 3)[0], bound(work)[0]
        print(f"  {batch:>2} {c:>4} {h:>4} {w:>4} {heads:>5} {names[flavour]:>7} {max(errs):>10.3e} {max(rels):>10.3e} "
              f"{k_ms:>10.4f} {p_ms:>10.4f} {k_call:>10.4f} {p_call:>10.4f} {b_ms:>10.4f} {simt_ms:>10.4f}", flush=True)
        if max(rels) > K7_TOL:
            raise RuntimeError(f"K7 B={batch} C={c} {h}x{w} {names[flavour]}: cotangent {rels.index(max(rels))} "
                               f"error {max(rels):.3e} above {K7_TOL:.0e}")
        worst = max(worst, max(errs))
        if h == w and batch == 2:
            times[(c, h, heads, flavour)] = (k_ms, p_ms, k_call, p_call)
        if batch == 8:
            times[(8, c, flavour)] = (k_ms, p_ms, k_call, p_call, b_ms, simt_ms)
            splits[(c, flavour)] = pass_split(kernel)
            print_split(f"  K7 at B=8, C={c}, {h}x{w}, {names[flavour]}, fp32, by pass", splits[(c, flavour)])
            if not splits[(c, flavour)]:
                raise NoDeviceTime("torch.profiler recorded no device time for K7's passes")
        del got, again, ref
    print("  K7 twice on the same inputs: equal bit for bit at every shape", flush=True)
    per_net = {"Restormer": [(n, key, RESTORMER_FLAVOUR) for key, n in K6_BODY.items()],
               "PromptIR": [(n, key, PROMPTIR_FLAVOUR) for key, n in [*K6_BODY.items(), *K6_NOISE.items()]]}
    c8 = K7_BATCH8[0][0]
    b8 = times[(8, c8, RESTORMER_FLAVOUR)]
    out = {"max_abs_err": worst, "library_ms": None, "b8_ms": b8[0], "b8_plain_ms": b8[1], "b8_call_ms": b8[2],
           "b8_bound_ms": b8[4], "b8_simt_bound_ms": b8[5], "b8_split": splits[(c8, RESTORMER_FLAVOUR)]}
    for net, blocks in per_net.items():
        work = [(n, *k7_work(c, int(2.66 * c), c // heads, 2 * s * s, 2)) for n, (c, s, heads), _ in blocks]
        bound_ms, bound_by = bound(work, PEAK_TF32_FLOPS / 3)
        ms, plain_ms, call_ms, plain_call_ms = (sum(n * times[(*key, fl)][i] for n, key, fl in blocks)
                                                for i in range(4))
        prefix = "" if net == "Restormer" else "promptir_"
        out.update({f"{prefix}ms": ms, f"{prefix}plain_ms": plain_ms, f"{prefix}call_ms": call_ms,
                    f"{prefix}plain_call_ms": plain_call_ms, f"{prefix}bound_ms": bound_ms,
                    f"{prefix}bound_by": bound_by, f"{prefix}simt_bound_ms": bound(work)[0]})
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
                "logger:use_tb_logger=false", "logger:print_freq=1", f"logger:save_checkpoint_freq={SHORT_ITERS}",
                f"train:scheduler:periods=[{SHORT_ITERS + SHORT_RESUME_ITERS}]"]
        mdta_block_fused.launches = mdta_block_bwd.launches = layer_norm_2d.launches = layer_norm_2d.bwd_launches = 0
        t0 = time.perf_counter()
        model = train_pipeline(str(work), args=args + [f"train:total_iter={SHORT_ITERS}"])
        torch.cuda.synchronize()
        launches = {"mdta_block_fused": mdta_block_fused.launches, "mdta_block_bwd": mdta_block_bwd.launches,
                    "layer_norm_2d": layer_norm_2d.launches + layer_norm_2d.bwd_launches}
        print(f"[11] train_pipeline on {yml.name}, {SHORT_ITERS} iterations at batch 8, gt_size 128: "
              f"{time.perf_counter() - t0:.1f} s; launches K6 {launches['mdta_block_fused']}, K7 "
              f"{launches['mdta_block_bwd']}, K3 {layer_norm_2d.launches} forward + {layer_norm_2d.bwd_launches} "
              f"backward; losses {dict(model.log_dict)}", flush=True)
        want = {k: n * SHORT_ITERS for k, n in TRANSFORMER_PER_STEP[arch].items()}
        if launches != want:
            raise RuntimeError(f"{arch}: launches {launches}, expected {want} for {SHORT_ITERS} steps")
        if not all(np.isfinite(v) for v in model.log_dict.values()) or set(model.log_dict) != {"l_pix", "l_classify"}:
            raise RuntimeError(f"{arch}: bad losses {model.log_dict}")
        models_dir = work / "experiments" / yaml_load(str(yml))["name"] / "models"
        if not (models_dir / f"net_g_{SHORT_ITERS}.pth").exists():
            raise RuntimeError(f"{arch}: no checkpoint at iteration {SHORT_ITERS} in {models_dir}")

        resumed = train_pipeline(str(work), args=["--auto_resume", *args,
                                                  f"train:total_iter={SHORT_ITERS + SHORT_RESUME_ITERS}"])
        steps = resumed.optimizer_g.state_dict()["state"][0]["step"].item()
        print(f"[11] {arch} resumed from iteration {SHORT_ITERS} for {SHORT_RESUME_ITERS} more: optimizer at step "
              f"{steps:.0f}, losses {dict(resumed.log_dict)}", flush=True)
        if steps != SHORT_ITERS + SHORT_RESUME_ITERS or not all(np.isfinite(v) for v in resumed.log_dict.values()):
            raise RuntimeError(f"{arch} resume: optimizer step {steps}, losses {resumed.log_dict}")
        del model

        kernels = [k for k in ("mdta_block_fused", "mdta_block_bwd", "layer_norm_2d") if TRANSFORMER_PER_STEP[arch][k]]
        profile = step_profile(resumed, kernels, f"[11] {arch}")
        step_ms, peak = ms_per_step(resumed, 2)
        with plain_path():
            plain_step_ms, plain_peak = ms_per_step(resumed, 1)
        print(f"[11] {arch} DCPT step at batch 8, 128 x 128, fp32: kernel path {step_ms:.2f} ms/step (peak "
              f"{peak:.0f} MiB), plain path {plain_step_ms:.2f} ms/step (peak {plain_peak:.0f} MiB)", flush=True)
        torch.cuda.empty_cache()
        check_bwd_in_step(resumed, f"[11] {arch}", MDTABlockFunction,
                          lambda x, s, dz, config: mdta_block_bwd_ref(x, *s[:11], *s[11:15], dz, *config), K7_TOL)
        torch.cuda.empty_cache()
        grad64 = check_step_gradients(resumed, f"[11] {arch}", 8, FLOAT64_GRAD_BATCH)
        out[arch] = {"launches": launches, "step_ms": step_ms, "plain_step_ms": plain_step_ms, "profile": profile,
                     "grad64": grad64}
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
    (``call_ms``, ``plain_call_ms``) and the bound: its products at the TF32
    tensor-core rate over three (3xTF32, ``bound_ms``; a bf16 call at the bf16
    rate), beside the SIMT fp32 bound (``simt_bound_ms``).  K8 is also held against,
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
          f"{'kernel_ms':>10} {'plain_ms':>10} {'call_ms':>10} {'plain_call':>10} {'bound_ms':>10} {'simt_bound':>10} "
          f"{'lib_err':>10} {'library_ms':>10}  (kernel_ms, plain_ms, library_ms: device time per call, "
          f"torch.profiler; call_ms: CUDA events around back-to-back calls; bound_ms: TF32 tensor cores / 3 in fp32, "
          f"bf16 tensor cores in bf16; simt_bound: fp32 outside the tensor cores)")
    with torch.no_grad():
        for b, h, w, shift, dname in cases:
            dtype = getattr(torch, dname)
            io, peak = (4, PEAK_TF32_FLOPS / 3) if dname == "float32" else (2, PEAK_BF16_FLOPS)
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
                                     k8_work(SWIN_C, SWIN_HIDDEN, ws * ws, b * h * w, io), lambda: layer(win)),
                "fused_window_attention": (lambda: wa.fused_window_attention_ln(x, *p[:6], heads, ws, shift),
                                           lambda: wa.window_attention_map_ref(x, *p[2:6], heads, ws, shift,
                                                                               (p[0], p[1], 1e-5)),
                                           lambda: wa.window_attention_map_ref(x.float(), *pf[2:6], heads, ws, shift,
                                                                               (pf[0], pf[1], 1e-5)),
                                           k10_work(SWIN_C, ws * ws, b * h * w, io), None),
                "fused_window_attention (no LN)": (
                    lambda: wa.fused_window_attention(x, *p[2:6], heads, ws, shift),
                    lambda: wa.window_attention_map_ref(x, *p[2:6], heads, ws, shift),
                    lambda: wa.window_attention_map_ref(x.float(), *pf[2:6], heads, ws, shift),
                    k10_work(SWIN_C, ws * ws, b * h * w, io), attention),
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
                b_ms, simt_ms = bound([(1, *work)], peak)[0], bound([(1, *work)])[0]
                lib_rel = lib_ms = float("nan")
                if library is not None and dname == "float32":  # in bf16 a library rounds every intermediate
                    lib_map = torch.roll(wa.window_reverse(library(), ws, h, w), (shift, shift), dims=(1, 2))
                    lib_rel = (lib_map.float() - ref).abs().max().item() / max(1.0, ref.abs().max().item())
                    if lib_rel > LIBRARY_TOL:
                        raise RuntimeError(f"{name}'s library call {b}x{h}x{w} shift {shift} {dname}: error "
                                           f"{lib_rel:.3e} against the plain version")
                    lib_ms = sum(device_ms_by_function(library, 10)[0].values())
                print(f"  {name:>30} {b:>2} {h:>4} {w:>4} {shift:>5} {dname:>9} {err:>10.3e} {rel:>10.3e} "
                      f"{k_ms:>10.4f} {p_ms:>10.4f} {k_call:>10.4f} {p_call:>10.4f} {b_ms:>10.4f} {simt_ms:>10.4f} "
                      f"{lib_rel:>10.3e} {lib_ms:>10.4f}", flush=True)
                worst[(name, dname)] = max(worst[(name, dname)], err)
                if dname == "float32" and (b, h, w) == (1, 128, 128):
                    times[(name, shift)] = (k_ms, p_ms, k_call, p_call, lib_ms)
    print("  K8 and K10 twice on the same inputs: equal bit for bit at every shape", flush=True)

    def per_forward(name, i):
        return SWIN_PER_FORWARD // 2 * (times[(name, 0)][i] + times[(name, 4)][i])

    out = {}
    for name, work in (("fused_swin_block", k8_work(SWIN_C, SWIN_HIDDEN, SWIN_WS ** 2, 128 * 128)),
                       ("fused_window_attention", k10_work(SWIN_C, SWIN_WS ** 2, 128 * 128))):
        bound_ms, bound_by = bound([(SWIN_PER_FORWARD, *work)], PEAK_TF32_FLOPS / 3)
        out[name] = {"max_abs_err": worst[(name, "float32")], "bf16_max_abs_err": worst[(name, "bfloat16")],
                     "ms": per_forward(name, 0), "plain_ms": per_forward(name, 1), "call_ms": per_forward(name, 2),
                     "plain_call_ms": per_forward(name, 3), "bound_ms": bound_ms, "bound_by": bound_by,
                     "simt_bound_ms": bound([(SWIN_PER_FORWARD, *work)])[0]}
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
    ``plain_call_ms``) and the bound on the tensor cores (3xTF32 at a third of the
    TF32 peak), beside the SIMT fp32 bound (``simt_bound_ms``); one call at B = 8
    (``b8_*``) and its device time by pass (``swin_ab.pass_split``)."""
    import torch

    from dcpt_tpu_torch.ops.swin_block_bwd import swin_block_bwd, swin_block_bwd_ref
    from dcpt_tpu_torch.tools.swin_ab import pass_split, print_split

    gen = torch.Generator().manual_seed(14)
    heads, ws, worst, times = SWIN_HEADS, SWIN_WS, 0.0, {}
    print(f"  {'B':>2} {'H':>4} {'W':>4} {'shift':>5} {'max_abs':>10} {'rel':>10} {'worst of':>8} {'kernel_ms':>10} "
          f"{'plain_ms':>10} {'call_ms':>10} {'plain_call':>10} {'bound_ms':>10} {'simt_bound':>10}  (kernel_ms, plain_ms: "
          f"device time per call, torch.profiler; call_ms: CUDA events around back-to-back calls; bound_ms: 3xTF32 on "
          f"the tensor cores; simt_bound: fp32 outside them)")
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
        work = k9_work(SWIN_C, SWIN_HIDDEN, ws * ws, b * h * w)
        b_ms, simt_ms = bound([(1, *work)], PEAK_TF32_FLOPS / 3)[0], bound([(1, *work)])[0]
        err = (got[i] - ref[i]).abs().max().item()
        print(f"  {b:>2} {h:>4} {w:>4} {shift:>5} {err:>10.3e} {errs[i]:>10.3e} {i:>8} {k_ms:>10.4f} {p_ms:>10.4f} "
              f"{k_call:>10.4f} {p_call:>10.4f} {b_ms:>10.4f} {simt_ms:>10.4f}", flush=True)
        worst = max(worst, err)
        times[(b, h, w, shift)] = (k_ms, p_ms, k_call, p_call, b_ms, simt_ms)
        if b == 8:
            split = pass_split(kernel)
            print_split(f"  K9 at B=8, {h}x{w}, shift {shift}, fp32, by pass", split)
            if not split:
                raise NoDeviceTime("torch.profiler recorded no device time for K9's passes")
        del got, again, ref
        torch.cuda.empty_cache()
    print("  K9 twice on the same inputs: equal bit for bit at every shape", flush=True)

    def per_backward(i):
        return SWIN_PER_FORWARD // 2 * (times[(2, 128, 128, 0)][i] + times[(2, 128, 128, 4)][i])

    work = k9_work(SWIN_C, SWIN_HIDDEN, ws * ws, 2 * 128 * 128)
    bound_ms, bound_by = bound([(SWIN_PER_FORWARD, *work)], PEAK_TF32_FLOPS / 3)
    b8 = times[(8, 128, 128, 4)]
    return {"max_abs_err": worst, "ms": per_backward(0), "plain_ms": per_backward(1), "call_ms": per_backward(2),
            "plain_call_ms": per_backward(3), "bound_ms": bound_ms, "bound_by": bound_by,
            "simt_bound_ms": bound([(SWIN_PER_FORWARD, *work)])[0], "library_ms": None, "b8_ms": b8[0],
            "b8_plain_ms": b8[1], "b8_call_ms": b8[2], "b8_bound_ms": b8[4], "b8_simt_bound_ms": b8[5],
            "b8_split": split}


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
    from dcpt_tpu_torch.tools import grad_check
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
    grad64 = check_step_gradients(resumed, "[15] SwinIR", plain_batch, SWIN_FLOAT64_BATCH)
    torch.cuda.empty_cache()

    # the DCPT_TPU_SWIN_BLOCK=0 route: the module constant it sets at import
    batch = grad_batch(plain_batch)
    with smooth_switches(resumed):
        k8, _ = grad_check.step_grads(resumed, batch)
        again, _ = grad_check.step_grads(resumed, batch)
        swinir_arch.SWIN_BLOCK_KERNEL = False
        try:
            fused_window_attention.launches = 0
            k10, _ = grad_check.step_grads(resumed, batch)
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

    return {"launches": launches, "step_ms": step_ms, "peak_mib": peak, "plain_batch": plain_batch, "rates": rates,
            "profile": profile, "grad64": grad64}


def float64_states(states: int, arch: str = "SwinIR") -> dict:
    """Not a phase of the run: the float64 check of [7], [11] or [15] on the
    DCPT step of ``arch`` (NAFNet, Restormer, PromptIR or SwinIR) at ``states``
    trained states, each on the routes through its blocks that tell the
    forward kernel from the backward one, to show which makes the check fail
    or come near its limit where it does.

        echo '["float64_states", [12, "SwinIR"]]' | python3 chip_smoke.py --serve

    The shipped DCPT yml trains TRAIN_ITERS steps at batch 8 on the PNGs of
    [7]; state k is that model after 2 k more steps on seeded batches.  On
    each, the check of ``check_step_gradients`` at the batch of its phase (the
    same batch, float64 reference and sensitivities for every route): the
    shipped route (forward and backward kernel), the forward kernel with the
    backward's plain version, and for SwinIR also the plain forward with K9.
    Prints each state's report with the plain fp32 runs' own loss departures
    from float64 beside ``LOSS_TOL``, and each route's pass count."""
    import shutil
    from contextlib import nullcontext

    from dcpt_tpu_torch.ops import mdta_block_bwd as mbb
    from dcpt_tpu_torch.ops import naf_block_bwd as nbb
    from dcpt_tpu_torch.ops import swin_block_bwd as sbb
    from dcpt_tpu_torch.ops import window_attention as wa
    from dcpt_tpu_torch.tools import grad_check
    from dcpt_tpu_torch.train import train_pipeline

    def plain_forward(x, params, heads, ws, shift, eps):
        return wa.swin_block_map_ref(x, *params, heads, ws, shift, eps)

    def plain_k7(x, *a):  # mdta_block_bwd's arguments: 11 parameters, dz, res, then the configuration
        return mbb.mdta_block_bwd_ref(x, *a[:11], *a[12][:4], a[11], *a[13:])

    def plain_k2(x, *a):  # naf_block_bwd's arguments: 18 parameters, pooled, att, dz, res, eps
        return nbb.naf_block_bwd_ref(x, *a[:21], a[22])

    yml, batch_size, routes = {
        "NAFNet": (TRAIN_YML, 8, {"K1 + K2": nullcontext,
                                  "K1 + plain backward": lambda: mock.patch.object(nbb, "naf_block_bwd", plain_k2)}),
        "Restormer": (TRANSFORMER_TRAIN_YMLS["Restormer"], FLOAT64_GRAD_BATCH,
                      {"K6 + K7": nullcontext,
                       "K6 + plain backward": lambda: mock.patch.object(mbb, "mdta_block_bwd", plain_k7)}),
        "PromptIR": (TRANSFORMER_TRAIN_YMLS["PromptIR"], FLOAT64_GRAD_BATCH,
                     {"K6 + K7": nullcontext,
                      "K6 + plain backward": lambda: mock.patch.object(mbb, "mdta_block_bwd", plain_k7)}),
        "SwinIR": (SWIN_TRAIN_YML, SWIN_FLOAT64_BATCH,
                   {"K8 + K9": nullcontext,
                    "plain forward + K9": lambda: mock.patch.object(wa, "_kernel_block", plain_forward),
                    "K8 + plain backward": lambda: mock.patch.object(sbb, "swin_block_bwd", sbb.swin_block_bwd_ref)}),
    }[arch]
    work = ROOT / "build" / f"chip_smoke_float64_states_{arch}"
    shutil.rmtree(work, ignore_errors=True)
    force = write_train_sets(work / "data")
    model = train_pipeline(str(work), args=["-opt", str(yml), "--force_yml", *force,
                                            "datasets:train:datasets:d3_dehaze:suffix=.png",
                                            "datasets:train:num_worker_per_gpu=0", "logger:use_tb_logger=false",
                                            f"train:total_iter={TRAIN_ITERS}"])
    batch = grad_batch(batch_size)
    passed = {route: 0 for route in routes}
    ratios = {route: [] for route in routes}
    plain_losses, plain_medians, medians = [], [], {route: [] for route in routes}
    for state in range(states):
        for k in range(2 if state else 0):
            model.feed_data(grad_batch(8, seed=100 + 2 * state + k))
            model.optimize_parameters(0)
        ref, ref_losses, sens, plain_loss, plain_median = float64_reference(model, batch)
        plain_losses.append(plain_loss)
        plain_medians.append(plain_median)
        print(f"[float64 states] {arch} state {state} ({TRAIN_ITERS + 2 * state} steps), batch {batch_size}: the "
              f"plain fp32 runs' loss departures from float64 {_fmt(plain_loss)} (each loss's limit max("
              f"{grad_check.LOSS_TOL:.0e}, K x its departure)); their own median error over tensors "
              f"{plain_median:.3e} (the routes' median limit max({grad_check.MEDIAN:.0e}, {grad_check.MEDIAN_K} x "
              f"it))", flush=True)
        for route, ctx in routes.items():
            with ctx():
                errs, losses = grad_check.run_errors(model, batch, ref)
            report = grad_check.compare(grad_check.path_error(errs), losses, ref, ref_losses, sens,
                                        plain_loss=plain_loss, plain_median=plain_median)
            passed[route] += report["ok"]
            ratios[route].append(report["worst_ratio"])
            medians[route].append(report["median"])
            print(f"[float64 states] {arch} state {state}, {route}: {'pass' if report['ok'] else 'FAIL'}; "
                  f"{grad_check.describe(report)}", flush=True)
    for route in routes:
        print(f"[float64 states] {arch}, {route}: passed {passed[route]} of {states}; worst share of a limit by "
              f"state " + ", ".join(f"{r:.3f}" for r in ratios[route]) + "; median error by state "
              + ", ".join(f"{m:.3e}" for m in medians[route]), flush=True)
    worst_plain = {k: max(p[k] for p in plain_losses) for k in plain_losses[0]}
    print(f"[float64 states] {arch}: the plain fp32 runs' worst loss departure over the states {_fmt(worst_plain)} "
          f"(LOSS_TOL {grad_check.LOSS_TOL:.0e}); their own median error by state "
          + ", ".join(f"{m:.3e}" for m in plain_medians), flush=True)
    return {"arch": arch, "states": states, "passed": passed, "ratios": ratios, "medians": medians,
            "plain_losses": plain_losses, "plain_medians": plain_medians}


def _k4_library(x, p):
    """K4's function as PyTorch calls on (B, H, W, C) x and the block parameters
    in the op's layout: F.layer_norm, a 1x1 and a depthwise F.conv2d and the
    gate.  Timed beside the kernel only; the port does not call it."""
    import torch.nn.functional as F

    c = x.shape[-1]
    n1w, n1b, w1, b1, wdw, bdw = p[:6]
    t = F.layer_norm(x, (c,), n1w, n1b, 1e-6).permute(0, 3, 1, 2)
    t = F.conv2d(t, w1.t()[:, :, None, None], b1)
    t = F.conv2d(t, wdw.permute(2, 0, 1)[:, None], bdw, padding=1, groups=2 * c)
    return (t[:, :c] * t[:, c:]).permute(0, 2, 3, 1)


def _k5_library(x, p):
    """K5's function as PyTorch calls: F.layer_norm, two F.linear, the gate and
    the residual.  Timed beside the kernel only; the port does not call it."""
    import torch.nn.functional as F

    c = x.shape[-1]
    n2w, n2b, w4, b4, w5, b5, gamma = p[11:]
    h = F.linear(F.layer_norm(x, (c,), n2w, n2b, 1e-6), w4.t(), b4)
    return x + gamma * F.linear(h[..., :c] * h[..., c:], w5.t(), b5)


def check_k4_k5() -> dict:
    """K4 and K5 against their plain versions at the c = 512 stage shapes, fp32 and
    bf16, each run twice for equal bits; per-forward totals (29 calls at B = 1,
    CUDA events) beside the plain versions', the library calls' (``_k4_library``,
    ``_k5_library``) and the bound (3xTF32 on the tensor cores, and the SIMT fp32
    bound); at the train yml's B = 8 each kernel's and library call's ms a call
    (CUDA events) and device ms a call (torch.profiler), and the kernel's device
    time by pass (``swin_ab.pass_split``)."""
    import torch

    from dcpt_tpu_torch.ops.naf_ffn import naf_ffn, naf_ffn_ref
    from dcpt_tpu_torch.ops.naf_prefix import naf_prefix, naf_prefix_ref
    from dcpt_tpu_torch.tools.swin_ab import pass_split, print_split

    gen = torch.Generator().manual_seed(16)
    c = K45_C
    out = {"naf_prefix": {"max_abs_err": 0.0, "bf16_max_abs_err": 0.0},
           "naf_ffn": {"max_abs_err": 0.0, "bf16_max_abs_err": 0.0}}
    print(f"  {'B':>3} {'H':>4} {'W':>4} {'dtype':>9} {'K4 rel':>10} {'K5 rel':>10} {'lib rel':>10} {'K4 ms':>8} "
          f"{'plain':>8} {'library':>8} {'K5 ms':>8} {'plain':>8} {'library':>8}  (CUDA events around back-to-back "
          f"calls)")
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        for b, h, w in K45_CASES:
            x = torch.randn(b, h, w, c, generator=gen).to(device="cuda", dtype=dtype)
            p = module_views(random_block_params(c, gen, dtype, "cuda"))
            xf, pf = x.float(), [t.float() for t in p]
            kernels = {"naf_prefix": (lambda: naf_prefix(x, *p[:6])), "naf_ffn": (lambda: naf_ffn(x, *p[11:]))}
            library = {"naf_prefix": (lambda: _k4_library(x, p)), "naf_ffn": (lambda: _k5_library(x, p))}
            with torch.no_grad():
                g, z = kernels["naf_prefix"](), kernels["naf_ffn"]()
                g2, z2 = kernels["naf_prefix"](), kernels["naf_ffn"]()
                ref_g, ref_z = naf_prefix_ref(xf, *pf[:6]), naf_ffn_ref(xf, *pf[11:])
                lib_g, lib_z = _k4_library(xf, pf), _k5_library(xf, pf)
            torch.cuda.synchronize()
            if not (torch.equal(g, g2) and torch.equal(z, z2)):
                raise RuntimeError(f"K4 / K5 at ({b}, {h}, {w}, {c}) {dname}: two runs on the same inputs differ")
            rels = []
            for name, got, ref in (("naf_prefix", g, ref_g), ("naf_ffn", z, ref_z)):
                if got.shape != ref.shape or got.dtype != dtype or not torch.isfinite(got).all():
                    raise RuntimeError(f"{name} ({b}, {h}, {w}, {c}) {dname}: bad output {got.shape} {got.dtype}")
                err = (got.float() - ref).abs().max().item()
                rels.append(err / max(1.0, ref.abs().max().item()))
                key = "max_abs_err" if dname == "float32" else "bf16_max_abs_err"
                out[name][key] = max(out[name][key], err)
            lib_rel = max((a - r).abs().max().item() / max(1.0, r.abs().max().item())
                          for a, r in ((lib_g, ref_g), (lib_z, ref_z)))
            if max(rels) > TOL[dname] or lib_rel > LIBRARY_TOL:
                raise RuntimeError(f"K4 / K5 at ({b}, {h}, {w}, {c}) {dname}: errors {rels} (limit {TOL[dname]:.0e}), "
                                   f"library {lib_rel:.3e}")
            with torch.no_grad():
                t = [cuda_ms(kernels["naf_prefix"]), cuda_ms(lambda: naf_prefix_ref(x, *p[:6])),
                     cuda_ms(library["naf_prefix"]), cuda_ms(kernels["naf_ffn"]),
                     cuda_ms(lambda: naf_ffn_ref(x, *p[11:])), cuda_ms(library["naf_ffn"])]
            print(f"  {b:>3} {h:>4} {w:>4} {dname:>9} {rels[0]:>10.3e} {rels[1]:>10.3e} {lib_rel:>10.3e} "
                  + " ".join(f"{v:>8.4f}" for v in t), flush=True)
            times = {"naf_prefix": t[:3], "naf_ffn": t[3:]}
            works = {"naf_prefix": k4_work(c, b * h * w), "naf_ffn": k5_work(c, b * h * w)}
            if (dname, b, h, w) == ("float32", 1, 16, 16):
                n = K45_PER_FORWARD
                for name, (k_ms, p_ms, l_ms) in times.items():
                    bound_ms, bound_by = bound([(n, *works[name])], PEAK_TF32_FLOPS / 3)
                    out[name].update(ms=n * k_ms, plain_ms=n * p_ms, library_ms=n * l_ms, bound_ms=bound_ms,
                                     bound_by=bound_by, simt_bound_ms=bound([(n, *works[name])])[0])
            if (dname, b, h, w) == ("float32", 8, 16, 16):
                for name, (k_ms, p_ms, l_ms) in times.items():
                    with torch.no_grad():
                        funcs = device_ms_by_function(kernels[name], 10)[0]
                        lib_dev = sum(device_ms_by_function(library[name], 10)[0].values())
                        split = pass_split(kernels[name])
                    label = "K4" if name == "naf_prefix" else "K5"
                    print_split(f"  {label} at B={b}, C={c}, {h}x{w}, {dname}, by pass", split)
                    if not split:
                        raise NoDeviceTime(f"torch.profiler recorded no device time for {name}'s passes")
                    required = DEVICE_FUNCTIONS[name] - CUT_ONLY
                    if not required <= set(funcs) <= DEVICE_FUNCTIONS[name]:
                        raise RuntimeError(f"{label}'s profile at B={b} shows {sorted(funcs)}, expected "
                                           f"{sorted(required)} and no other than {sorted(DEVICE_FUNCTIONS[name])}")
                    k_dev = sum(funcs.values())
                    print(f"  {label} at B={b}: {k_ms:.4f} ms a call (CUDA events), device {k_dev:.4f} ms; library "
                          f"{l_ms:.4f} ms, device {lib_dev:.4f} ms", flush=True)
                    out[name].update(b8_ms=k_ms, b8_plain_ms=p_ms, b8_library_ms=l_ms, b8_device_ms=k_dev,
                                     b8_library_device_ms=lib_dev, b8_split=split,
                                     b8_bound_ms=bound([(1, *works[name])], PEAK_TF32_FLOPS / 3)[0],
                                     b8_simt_bound_ms=bound([(1, *works[name])])[0])
            if (dname, b, h, w) == ("bfloat16", 1, 16, 16):
                for name, (k_ms, p_ms, _) in times.items():
                    out[name].update(bf16_ms=K45_PER_FORWARD * k_ms, bf16_plain_ms=K45_PER_FORWARD * p_ms)
            if (dname, b, h, w) == ("bfloat16", 8, 16, 16):
                for name, (k_ms, _, _) in times.items():
                    out[name]["b8_bf16_ms"] = k_ms
    return out


def run_pallas_eval(force: list[str]) -> dict:
    """The shipped eval yml through test_pipeline on the route that
    ``DCPT_TPU_PALLAS=1 DCPT_TPU_NAF_BLOCK=0`` selects (read at import: run in a
    fresh process with both set): every NAFBlock on dcpt_tpu's module path, K4
    and K5 at each of the 29 c = 512 blocks of a forward, K3 at the c = 1024
    middle block; then a ragged image on this route against the default (K1)
    route, and the eval rates of both routes."""
    import numpy as np
    import torch

    from dcpt_tpu_torch import ops
    from dcpt_tpu_torch.archs import nafnet_arch
    from dcpt_tpu_torch.data import build_dataloader, build_dataset
    from dcpt_tpu_torch.models import build_model
    from dcpt_tpu_torch.ops.layernorm2d import layer_norm_2d
    from dcpt_tpu_torch.ops.naf_block import naf_block_fused
    from dcpt_tpu_torch.ops.naf_ffn import naf_ffn
    from dcpt_tpu_torch.ops.naf_prefix import naf_prefix
    from dcpt_tpu_torch.test import test_pipeline
    from dcpt_tpu_torch.utils.options import parse_options

    if ops.kernel_mode() != "all" or nafnet_arch.NAF_BLOCK_KERNEL:
        raise RuntimeError(f"[17] runs with {PALLAS_ENV} in the environment; kernel mode {ops.kernel_mode()}, "
                           f"block kernel {nafnet_arch.NAF_BLOCK_KERNEL}")
    root = WORK / "pallas_route"
    root.mkdir(parents=True, exist_ok=True)
    args = ["-opt", str(YML), "--force_yml", *force, f"path:pretrain_network_g={WORK / 'net.pth'}"]
    n_images = 10
    naf_prefix.launches = naf_ffn.launches = naf_block_fused.launches = layer_norm_2d.launches = 0
    t0 = time.perf_counter()
    results = test_pipeline(str(root), args=args)
    torch.cuda.synchronize()
    launches = {"naf_prefix": naf_prefix.launches, "naf_ffn": naf_ffn.launches,
                "naf_block_fused": naf_block_fused.launches, "layer_norm_2d": layer_norm_2d.launches}
    print(f"[17] test_pipeline on {YML.name} with {PALLAS_ENV}: {time.perf_counter() - t0:.1f} s, launches "
          f"{launches} for {n_images} forwards", flush=True)
    for name, metrics in results.items():
        print(f"    {name}: " + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items()), flush=True)
    want = {"naf_prefix": K45_PER_FORWARD * n_images, "naf_ffn": K45_PER_FORWARD * n_images, "naf_block_fused": 0,
            "layer_norm_2d": K3_PER_FORWARD_MODULE * n_images}
    if launches != want:
        raise RuntimeError(f"[17] launches {launches}, expected {want}")
    if not all(np.isfinite(v) for m in results.values() for v in m.values()):
        raise RuntimeError(f"[17] non-finite metrics: {results}")

    opt, _ = parse_options(str(root), is_train=False, args=args)
    model = build_model(opt)
    rain = next(v for v in opt["datasets"].values() if v["name"] == "Rain100L")
    sample = next(s for s in build_dataloader(build_dataset(rain), rain) if s["lq"].shape[-2:] == (120, 72))
    model.feed_data(sample)
    model.pre_test()
    model.test()
    module_out = model.output.clone()
    lq = torch.rand(1, 3, 128, 128, generator=torch.Generator().manual_seed(3)).cuda()
    rate = images_per_s(model, lq)
    nafnet_arch.NAF_BLOCK_KERNEL = True
    try:
        model.feed_data(sample)
        model.pre_test()
        model.test()
        k1_out = model.output
        k1_rate = images_per_s(model, lq)
    finally:
        nafnet_arch.NAF_BLOCK_KERNEL = False
    diff = (module_out - k1_out).abs().max().item()
    print(f"[17] one image (120x72, padded to 128x80): module route (K4, K5) against the default route (K1) max-abs "
          f"{diff:.3e} (limit 1e-4, fp32, TF32 off); eval forward at 128x128, batch 1: module route {rate:.2f} "
          f"images/s, default route {k1_rate:.2f} images/s", flush=True)
    if module_out.shape != (1, 3, 128, 80) or not torch.isfinite(module_out).all() or not diff <= 1e-4:
        raise RuntimeError(f"[17] module route output {tuple(module_out.shape)} against K1's: {diff:.3e}")
    return {"launches": launches, "diff": diff, "rate": rate, "k1_rate": k1_rate}


def check_bf16_k2_k3() -> dict:
    """K2 and K3 in bf16 against their plain versions (fp32 math on the same bf16
    inputs, each cotangent cast to its primal's dtype): K2 at the five stage
    shapes (B = 2) and the ragged ones, K3 at the classifier's row shapes of a
    batch-8 step (``k3_shapes``); each run twice for equal bits.  K2 per backward
    (CUDA events) and K3 per step beside the plain versions' and F.layer_norm's."""
    import torch

    from dcpt_tpu_torch.ops.naf_block import _kernel_forward
    from dcpt_tpu_torch.ops.naf_block_bwd import naf_block_bwd, naf_block_bwd_ref

    gen = torch.Generator().manual_seed(18)
    tol = TOL["bfloat16"]
    k2 = {"max_abs_err": 0.0}
    per_block = {}
    print(f"  K2 bf16: {'C':>5} {'H':>4} {'W':>4} {'rel':>10} {'kernel_ms':>10} {'plain_ms':>10}")
    for c, h, w in [(c, s, s) for c, s, _ in STAGES] + RAGGED:
        x = torch.randn(2, h, w, c, generator=gen).to("cuda", torch.bfloat16)
        params = random_block_params(c, gen, torch.bfloat16, "cuda")
        dz = torch.randn(x.shape, generator=gen).to("cuda", torch.bfloat16)
        _, res = _kernel_forward(x, params, 1e-6, residuals=True)
        *maps, pooled, att = res
        got = naf_block_bwd(x, *params, pooled, att, dz, maps)
        again = naf_block_bwd(x, *params, pooled, att, dz, maps)
        ref = naf_block_bwd_ref(x, *params, pooled, att, dz)
        torch.cuda.synchronize()
        if not all(a.dtype == torch.bfloat16 and torch.equal(a, b) for a, b in zip(got, again)):
            raise RuntimeError(f"K2 bf16 C={c} {h}x{w}: not bf16, or two runs differ")
        rels = [(a.float() - r.float()).abs().max().item() / max(1.0, r.float().abs().max().item())
                for a, r in zip(got, ref)]
        if max(rels) > tol or not all(torch.isfinite(a).all() for a in got):
            raise RuntimeError(f"K2 bf16 C={c} {h}x{w}: cotangent {rels.index(max(rels))} error {max(rels):.3e}")
        k2["max_abs_err"] = max(k2["max_abs_err"], max((a.float() - r.float()).abs().max().item()
                                                       for a, r in zip(got, ref)))
        k_ms = cuda_ms(lambda: naf_block_bwd(x, *params, pooled, att, dz, maps))
        p_ms = cuda_ms(lambda: naf_block_bwd_ref(x, *params, pooled, att, dz))
        per_block[(c, h, w)] = (k_ms, p_ms)
        print(f"           {c:>5} {h:>4} {w:>4} {max(rels):>10.3e} {k_ms:>10.4f} {p_ms:>10.4f}", flush=True)
    k2.update(ms=sum(n * per_block[(c, s, s)][0] for c, s, n in STAGES),
              plain_ms=sum(n * per_block[(c, s, s)][1] for c, s, n in STAGES))

    k3 = k3_shapes("bfloat16", gen)
    return {"naf_block_bwd": k2, "layer_norm_2d": k3}


def _snapshot(model):
    """Both nets' weights and both optimizers' states, copied."""
    import copy

    return ([{k: v.clone() for k, v in net.state_dict().items()} for net in (model.net_g, model.net_dc)],
            [copy.deepcopy(o.state_dict()) for o in model.optimizers])


def _restore(model, snap):
    nets, optims = snap
    for net, sd in zip((model.net_g, model.net_dc), nets):
        net.load_state_dict(sd)
    for o, sd in zip(model.optimizers, optims):
        o.load_state_dict(sd)


MIXED_STEP_ITERS = 1  # timed steps of each path in the mixed-precision phases (after a warm-up step)


def _mixed_net(arch: str) -> dict:
    """What a mixed-precision phase needs of a net: its train yml, the kernels a
    step launches (fwd, bwd) and how often (the fp32 step's counts; K3 forward
    and backward together), the plain versions that must not run, and its
    blocks' autograd Function with the plain backward for ``check_bwd_in_step``."""
    from dcpt_tpu_torch.ops import mdta_block as mb
    from dcpt_tpu_torch.ops import mdta_block_bwd as mbb
    from dcpt_tpu_torch.ops import naf_block as nb
    from dcpt_tpu_torch.ops import naf_block_bwd as nbb
    from dcpt_tpu_torch.ops import swin_block_bwd as sbb
    from dcpt_tpu_torch.ops import window_attention as wa

    if arch == "NAFNet":
        return dict(yml=TRAIN_YML, kernels=(nb.naf_block_fused, nbb.naf_block_bwd),
                    per_step={"naf_block_fused": K1_PER_STEP, "naf_block_bwd": K2_PER_STEP,
                              "layer_norm_2d": 2 * K3_PER_STEP},
                    plain=((nb, "_ref_forward"), (nbb, "naf_block_bwd_ref")), function=nb.NAFBlockFunction,
                    ref=lambda x, s, dz, eps: nbb.naf_block_bwd_ref(x, *s[:18], s[18], s[19], dz, eps),
                    check=dict(tensors=lambda g: (g[0], *g[2:]), config=lambda ctx: ctx.eps))
    if arch == "SwinIR":
        return dict(yml=SWIN_TRAIN_YML, kernels=(wa.fused_swin_block, sbb.swin_block_bwd), per_step=SWIN_PER_STEP,
                    plain=((wa, "swin_block_map_ref"), (sbb, "swin_block_bwd_ref")), function=wa.SwinBlockFunction,
                    ref=lambda x, s, dz, config: sbb.swin_block_bwd_ref(x, *s, dz, *config), check={})
    return dict(yml=TRANSFORMER_TRAIN_YMLS[arch], kernels=(mb.mdta_block_fused, mbb.mdta_block_bwd),
                per_step=TRANSFORMER_PER_STEP[arch], plain=((mb, "_ref_forward"), (mbb, "mdta_block_bwd_ref")),
                function=mb.MDTABlockFunction,
                ref=lambda x, s, dz, config: mbb.mdta_block_bwd_ref(x, *s[:11], *s[11:15], dz, *config), check={})


def run_mixed_training(force: list[str], archs: list[str], label: str) -> dict:
    """Each net's DCPT yml with ``train:mixed_precision=true`` through train_pipeline
    at full width, batch 8, on the PNGs of [7]: SHORT_ITERS iterations with a
    checkpoint, the launch counts per step checked and no plain version run, a
    resume for SHORT_RESUME_ITERS more with fp32 masters and moments; every
    backward of its blocks in a batch-8 mixed step against its plain version on
    that call's inputs; the ms per step and peak memory beside the fp32 step
    and the plain bf16 path (at the largest batch that path fits); two steps'
    losses from the same weights on one batch in bf16 and in fp32."""
    import gc
    import shutil

    import numpy as np
    import torch

    from dcpt_tpu_torch.ops import layernorm2d as ln
    from dcpt_tpu_torch.train import train_pipeline
    from dcpt_tpu_torch.utils.options import yaml_load

    out = {}
    for arch in archs:
        net = _mixed_net(arch)
        yml, (fwd, bwd) = net["yml"], net["kernels"]
        work = ROOT / "build" / f"chip_smoke_train_mixed_{arch}"
        shutil.rmtree(work, ignore_errors=True)
        args = ["-opt", str(yml), "--force_yml", *force, "datasets:train:datasets:d3_dehaze:suffix=.png",
                "logger:use_tb_logger=false", "logger:print_freq=1", f"logger:save_checkpoint_freq={SHORT_ITERS}",
                f"train:scheduler:periods=[{SHORT_ITERS + SHORT_RESUME_ITERS}]", "train:mixed_precision=true"]
        plain_calls = {"block": 0, "block_bwd": 0, "layer_norm_2d": 0}

        def counted(key, fn):
            def wrapper(*a, **k):
                plain_calls[key] += 1
                return fn(*a, **k)
            return wrapper

        fwd.launches = bwd.launches = ln.layer_norm_2d.launches = ln.layer_norm_2d.bwd_launches = 0
        t0 = time.perf_counter()
        (fmod, fname), (bmod, bname) = net["plain"]
        with mock.patch.object(fmod, fname, counted("block", getattr(fmod, fname))), \
                mock.patch.object(bmod, bname, counted("block_bwd", getattr(bmod, bname))), \
                mock.patch.object(ln, "layer_norm_2d_ref", counted("layer_norm_2d", ln.layer_norm_2d_ref)):
            model = train_pipeline(str(work), args=args + [f"train:total_iter={SHORT_ITERS}"])
            torch.cuda.synchronize()
        launches = {fwd.__name__: fwd.launches, bwd.__name__: bwd.launches,
                    "layer_norm_2d": ln.layer_norm_2d.launches + ln.layer_norm_2d.bwd_launches}
        print(f"{label} train_pipeline on {yml.name} with train:mixed_precision=true, {SHORT_ITERS} iterations at batch "
              f"8, gt_size 128: {time.perf_counter() - t0:.1f} s; launches {launches}, plain versions run "
              f"{plain_calls}; losses {dict(model.log_dict)}", flush=True)
        want = {k: n * SHORT_ITERS for k, n in net["per_step"].items()}
        if launches != want or any(plain_calls.values()):
            raise RuntimeError(f"{label} {arch}: launches {launches} (expected {want}), plain versions run "
                               f"{plain_calls}")
        if not all(np.isfinite(v) for v in model.log_dict.values()) or set(model.log_dict) != {"l_pix", "l_classify"}:
            raise RuntimeError(f"{label} {arch}: bad losses {model.log_dict}")
        models_dir = work / "experiments" / yaml_load(str(yml))["name"] / "models"
        if not (models_dir / f"net_g_{SHORT_ITERS}.pth").exists():
            raise RuntimeError(f"{label} {arch}: no checkpoint at iteration {SHORT_ITERS} in {models_dir}")
        del model

        resumed = train_pipeline(str(work), args=["--auto_resume", *args,
                                                  f"train:total_iter={SHORT_ITERS + SHORT_RESUME_ITERS}"])
        steps = resumed.optimizer_g.state_dict()["state"][0]["step"].item()
        dtypes = {p.dtype for n in (resumed.net_g, resumed.net_dc) for p in n.parameters()}
        dtypes |= {v.dtype for o in resumed.optimizers for st in o.state.values() for k, v in st.items()
                   if k.startswith("exp_avg")}
        print(f"{label} {arch} resumed from iteration {SHORT_ITERS} for {SHORT_RESUME_ITERS} more: optimizer at step "
              f"{steps:.0f}, masters and AdamW moments {sorted(str(d) for d in dtypes)}, losses "
              f"{dict(resumed.log_dict)}", flush=True)
        if steps != SHORT_ITERS + SHORT_RESUME_ITERS or dtypes != {torch.float32} or not resumed.mixed_precision:
            raise RuntimeError(f"{label} {arch} resume: optimizer step {steps}, dtypes {dtypes}")

        torch.cuda.empty_cache()
        bwd_worst = check_bwd_in_step(resumed, f"{label} {arch} bf16", net["function"], net["ref"], TOL["bfloat16"],
                                      net["per_step"][bwd.__name__], **net["check"])
        torch.cuda.empty_cache()
        # the transformer nets' plain bf16 path (cuBLAS / cuDNN, no K6 / K7) times its first step
        # from the weights the loss curves start from: whether a departure of bf16 from fp32 is
        # the kernels' or the recipe's own rounding
        snap = _snapshot(resumed) if arch in TRANSFORMER_TRAIN_YMLS else None
        resumed.feed_data(grad_batch(8))
        step_ms, peak = ms_per_step(resumed, MIXED_STEP_ITERS)
        resumed.mixed_precision = False
        fp32_ms, fp32_peak = ms_per_step(resumed, MIXED_STEP_ITERS)
        resumed.mixed_precision = True
        torch.cuda.empty_cache()
        rates, plain_first = {}, []
        for plain_batch in (8, 4, 2):
            resumed.feed_data(grad_batch(plain_batch))
            try:
                if plain_batch < 8:
                    rates["kernel"] = list(ms_per_step(resumed, MIXED_STEP_ITERS))
                elif snap is not None:
                    _restore(resumed, snap)
                with plain_path():
                    rates["plain"] = list(ms_per_step(resumed, MIXED_STEP_ITERS, plain_first))
                break
            except torch.cuda.OutOfMemoryError as e:
                print(f"{label} {arch} plain bf16 path at batch {plain_batch}: {str(e).splitlines()[0]}", flush=True)
            # the failed step's graph stays referenced from the exception's frames until a collection
            gc.collect()
            resumed.optimizer_g.zero_grad(set_to_none=True)
            resumed.optimizer_dc.zero_grad(set_to_none=True)
            torch.cuda.empty_cache()
        print(f"{label} {arch} DCPT step at batch 8, 128 x 128: bf16 through the kernels {step_ms:.2f} ms/step (peak "
              f"{peak:.0f} MiB), fp32 through the kernels {fp32_ms:.2f} ms/step (peak {fp32_peak:.0f} MiB); at batch "
              f"{plain_batch}: " + (f"bf16 kernels {rates['kernel'][0]:.2f} ms/step (peak {rates['kernel'][1]:.0f} "
                                    f"MiB), " if "kernel" in rates else "")
              + f"the plain bf16 path {rates['plain'][0]:.2f} ms/step (peak {rates['plain'][1]:.0f} MiB)", flush=True)

        torch.cuda.empty_cache()
        if snap is None:
            snap = _snapshot(resumed)
        curves = {}
        for mode in ("bf16", "fp32"):
            _restore(resumed, snap)
            resumed.mixed_precision = mode == "bf16"
            resumed.feed_data(grad_batch(8))
            curve = []
            for _ in range(2):
                resumed.optimize_parameters(0)
                curve.append(dict(resumed.log_dict))
            curves[mode] = curve
        resumed.mixed_precision = True
        if arch in TRANSFORMER_TRAIN_YMLS and plain_batch == 8:
            curves["plain bf16"] = plain_first

        def spread_of(mode):
            return max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(curves[mode], curves["fp32"]) for k in b)

        spread = spread_of("bf16")
        print(f"{label} {arch} two steps on one batch of 8 from the same weights: "
              + "; ".join(f"{mode} {curve}" for mode, curve in curves.items())
              + f"; largest relative loss difference from fp32: bf16 kernels {spread:.3e}"
              + (f", plain bf16 {spread_of('plain bf16'):.3e}" if "plain bf16" in curves else ""), flush=True)
        if not all(np.isfinite(v) for c in curves.values() for d in c for v in d.values()):
            raise RuntimeError(f"{label} {arch}: non-finite losses {curves}")
        out[arch] = {"launches": launches, "step_ms": step_ms, "peak_mib": peak, "fp32_step_ms": fp32_ms,
                     "fp32_peak_mib": fp32_peak, "plain_batch": plain_batch, "rates": rates, "curves": curves,
                     "loss_spread": spread, "bwd_worst": bwd_worst}
        del resumed, snap
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _rel_errs(got, ref) -> list[float]:
    """Each tensor's max-abs error relative to max(1, max|ref|), in fp32."""
    return [(a.float() - r.float()).abs().max().item() / max(1.0, r.float().abs().max().item()) for a, r in zip(got, ref)]


def check_bf16_k7_k9() -> dict:
    """K7 and K9 in bf16 against their plain versions (fp32 math on the same bf16
    inputs, each cotangent cast to its primal's dtype), each call twice for
    equal bits: K7 from bf16 K6's fp32 residuals (checked equal, bit for bit, to
    those K6's fp32 entry writes for the same values) at the stage shapes of [10]
    (B = 2, both flavours; PromptIR's noise levels; B = 8 at the 128 x 128
    stages) and a ragged map, K9 at the shapes of [14] (its ragged 120 x 72
    grid among them).  CUDA-event ms per Restormer / PromptIR / SwinIR backward
    at B = 2 of the bf16 kernel, the fp32 kernel and the plain bf16 version;
    the bf16 bound (bytes at 2 an element, products at the bf16 tensor-core
    peak); and K6 (with its residuals) and K8 per forward at B = 2 in bf16 and
    fp32, the forwards a training step differentiates."""
    import torch

    from dcpt_tpu_torch.ops import mdta_block as mb
    from dcpt_tpu_torch.ops import swin_block_bwd as sbb
    from dcpt_tpu_torch.ops import window_attention as wa
    from dcpt_tpu_torch.ops.mdta_block_bwd import mdta_block_bwd, mdta_block_bwd_ref

    gen = torch.Generator().manual_seed(20)
    tol, bf16 = TOL["bfloat16"], torch.bfloat16
    names = {RESTORMER_FLAVOUR: "relu", PROMPTIR_FLAVOUR: "softmax"}
    cases = [(2, s, s, c, heads, fl) for fl in names for c, s, heads in K6_BODY]
    cases += [(2, s, s, c, heads, PROMPTIR_FLAVOUR) for c, s, heads in K6_NOISE]
    cases += [(8, s, s, c, heads, fl) for c, s, heads in K7_BATCH8 for fl in names]
    cases += [(2, *K7_RAGGED[0][:2], *K7_RAGGED[0][2:], RESTORMER_FLAVOUR)]
    k7 = {"max_abs_err": 0.0}
    times = {}
    print(f"  K7 bf16: {'B':>2} {'C':>4} {'H':>4} {'W':>4} {'act':>7} {'rel':>10} {'bf16_ms':>10} {'fp32_ms':>10} "
          f"{'plain_ms':>10} {'k6_bf16':>10} {'k6_fp32':>10}  (CUDA events, ms per call; k6: K6 with its residuals)")
    for batch, h, w, c, heads, flavour in cases:
        x = torch.randn(batch, h, w, c, generator=gen).to("cuda", bf16)
        params = mdta_params(c, heads, gen, bf16, "cuda")
        dz = torch.randn(x.shape, generator=gen).to("cuda", bf16)
        xf, pf = x.float(), [t.float() for t in params]
        _, res = mb._kernel_forward(x, params, heads, *flavour, residuals=True)
        _, res32 = mb._kernel_forward(xf, pf, heads, *flavour, residuals=True)
        got = mdta_block_bwd(x, *params, dz, res, heads, *flavour)
        again = mdta_block_bwd(x, *params, dz, res, heads, *flavour)
        ref = mdta_block_bwd_ref(x, *params, *res[:4], dz, heads, *flavour)
        torch.cuda.synchronize()
        key = f"K7 bf16 B={batch} C={c} {h}x{w} {names[flavour]}"
        if not all(r.dtype == torch.float32 and torch.equal(r, r32) for r, r32 in zip(res, res32)):
            raise RuntimeError(f"{key}: bf16 K6's residuals differ from its fp32 entry's on the same values")
        if not all(a.dtype == bf16 and torch.isfinite(a).all() and torch.equal(a, b) for a, b in zip(got, again)):
            raise RuntimeError(f"{key}: not bf16, not finite, or two runs differ")
        rels = _rel_errs(got, ref)
        if max(rels) > tol:
            raise RuntimeError(f"{key}: cotangent {rels.index(max(rels))} error {max(rels):.3e} above {tol:.0e}")
        k7["max_abs_err"] = max(k7["max_abs_err"], max((a.float() - r.float()).abs().max().item()
                                                       for a, r in zip(got, ref)))
        dzf = dz.float()
        ms = [cuda_ms(lambda: mdta_block_bwd(x, *params, dz, res, heads, *flavour), 5),
              cuda_ms(lambda: mdta_block_bwd(xf, *pf, dzf, res32, heads, *flavour), 5),
              cuda_ms(lambda: mdta_block_bwd_ref(x, *params, *res[:4], dz, heads, *flavour), 3),
              cuda_ms(lambda: mb._kernel_forward(x, params, heads, *flavour, residuals=True), 5),
              cuda_ms(lambda: mb._kernel_forward(xf, pf, heads, *flavour, residuals=True), 5)]
        del got, again, ref, res32
        print(f"           {batch:>2} {c:>4} {h:>4} {w:>4} {names[flavour]:>7} {max(rels):>10.3e} "
              + " ".join(f"{v:>10.4f}" for v in ms), flush=True)
        if batch == 2 and h == w:
            times[(c, h, heads, flavour)] = ms
    print("  K6 bf16 residuals equal to fp32 K6's; K7 bf16 twice on the same inputs: equal bit for bit at every "
          "shape", flush=True)
    per_net = {"Restormer": [(n, key, RESTORMER_FLAVOUR) for key, n in K6_BODY.items()],
               "PromptIR": [(n, key, PROMPTIR_FLAVOUR) for key, n in [*K6_BODY.items(), *K6_NOISE.items()]]}
    for net, blocks in per_net.items():
        prefix = "" if net == "Restormer" else "promptir_"
        for i, name in enumerate(("ms", "fp32_ms", "plain_ms", "k6_ms", "k6_fp32_ms")):
            k7[prefix + name] = sum(n * times[(*key, fl)][i] for n, key, fl in blocks)
        k7[prefix + "bound_ms"], k7[prefix + "bound_by"] = bound(
            [(n, *k7_work(c, int(2.66 * c), c // heads, 2 * s * s, 2, io=2)) for n, (c, s, heads), _ in blocks],
            PEAK_BF16_FLOPS)

    k9 = {"max_abs_err": 0.0}
    times = {}
    heads, ws = SWIN_HEADS, SWIN_WS
    print(f"  K9 bf16: {'B':>2} {'H':>4} {'W':>4} {'shift':>5} {'rel':>10} {'bf16_ms':>10} {'fp32_ms':>10} "
          f"{'plain_ms':>10} {'k8_bf16':>10} {'k8_fp32':>10}  (CUDA events, ms per call)")
    for b, h, w, shift in K9_CASES:
        x = torch.randn(b, h, w, SWIN_C, generator=gen).to("cuda", bf16)
        dz = torch.randn(b, h, w, SWIN_C, generator=gen).to("cuda", bf16)
        p = swin_params(gen, bf16, "cuda")
        xf, dzf, pf = x.float(), dz.float(), [t.float() for t in p]
        got = sbb.swin_block_bwd(x, *p, dz, heads, ws, shift)
        again = sbb.swin_block_bwd(x, *p, dz, heads, ws, shift)
        ref = sbb.swin_block_bwd_ref(x, *p, dz, heads, ws, shift)
        torch.cuda.synchronize()
        key = f"K9 bf16 {b}x{h}x{w} shift {shift}"
        if not all(a.dtype == bf16 and torch.isfinite(a).all() and torch.equal(a, g) for a, g in zip(got, again)):
            raise RuntimeError(f"{key}: not bf16, not finite, or two runs differ")
        rels = _rel_errs(got, ref)
        if max(rels) > tol:
            raise RuntimeError(f"{key}: cotangent {rels.index(max(rels))} error {max(rels):.3e} above {tol:.0e}")
        k9["max_abs_err"] = max(k9["max_abs_err"], max((a.float() - r.float()).abs().max().item()
                                                       for a, r in zip(got, ref)))
        del got, again, ref
        ms = [cuda_ms(lambda: sbb.swin_block_bwd(x, *p, dz, heads, ws, shift), 3),
              cuda_ms(lambda: sbb.swin_block_bwd(xf, *pf, dzf, heads, ws, shift), 3),
              cuda_ms(lambda: sbb.swin_block_bwd_ref(x, *p, dz, heads, ws, shift), 3),
              cuda_ms(lambda: wa._kernel_block(x, p, heads, ws, shift, 1e-5), 5),
              cuda_ms(lambda: wa._kernel_block(xf, pf, heads, ws, shift, 1e-5), 5)]
        print(f"           {b:>2} {h:>4} {w:>4} {shift:>5} {max(rels):>10.3e} " + " ".join(f"{v:>10.4f}" for v in ms),
              flush=True)
        times[(b, h, w, shift)] = ms
        torch.cuda.empty_cache()
    print("  K9 bf16 twice on the same inputs: equal bit for bit at every shape", flush=True)
    for i, name in enumerate(("ms", "fp32_ms", "plain_ms", "k8_ms", "k8_fp32_ms")):
        k9[name] = SWIN_PER_FORWARD // 2 * (times[(2, 128, 128, 0)][i] + times[(2, 128, 128, 4)][i])
    k9["bound_ms"], k9["bound_by"] = bound(
        [(SWIN_PER_FORWARD, *k9_work(SWIN_C, SWIN_HIDDEN, ws * ws, 2 * 128 * 128, io=2))], PEAK_BF16_FLOPS)
    b8 = times[(8, 128, 128, 4)]
    k9.update(b8_ms=b8[0], b8_fp32_ms=b8[1], b8_plain_ms=b8[2])
    return {"mdta_block_bwd": k7, "swin_block_bwd": k9}


def _rel_err(got, ref) -> tuple[float, float]:
    """(max |got - ref|, that over max(1, max |ref|)), in fp32."""
    err = (got.float() - ref.float()).abs().max().item()
    return err, err / max(1.0, ref.float().abs().max().item())


def k14_work(rows: int, c: int, c_out: int, io: int = 4, out_bias: bool = False) -> tuple[float, float]:
    """(flops, bytes) of one K14 (or K5') call: the product's 2 C C_out and the
    LayerNorm's ~8 C flops a row; x read, out written, w, the norm's affine (and
    the output bias) read once, ``io`` bytes an element."""
    return rows * (2 * c * c_out + 8 * c), io * (rows * (c + c_out) + c * c_out + 2 * c + out_bias * c_out)


def k13_work(bh: int, c: int, length: int, io: int = 4) -> tuple[float, float]:
    """(flops, bytes) of one K13 call: the Gram and attn . v (2 c^2 L flops each)
    and the norms (4 c L) per head; q, k, v read and out written once."""
    return bh * (4 * c * c * length + 4 * c * length), io * 4 * bh * c * length


def _k14_shapes() -> list[tuple]:
    """(C, H, blocks, flavour) of the Restormer (BiasFree, 1e-6) and PromptIR (WithBias,
    1e-5, its noise levels too) projections of a 128 x 128 forward."""
    return ([(c, s, n, RESTORMER_FLAVOUR) for (c, s, _), n in K6_BODY.items()]
            + [(c, s, n, PROMPTIR_FLAVOUR) for (c, s, _), n in [*K6_BODY.items(), *K6_NOISE.items()]])


def _k13_shapes() -> list[tuple]:
    """((BH, c, L), blocks, flavour) of the Restormer (ReLU) and PromptIR (softmax) attentions of
    a 128 x 128 forward: per head a c = C / heads x L = H W block."""
    return ([((h, c // h, s * s), n, RESTORMER_FLAVOUR) for (c, s, h), n in K6_BODY.items()]
            + [((h, c // h, s * s), n, PROMPTIR_FLAVOUR) for (c, s, h), n in [*K6_BODY.items(), *K6_NOISE.items()]])


def check_standalone() -> dict:
    """K11, K12, K14, K5' and K13 against their plain versions on the card (TF32
    off), each call twice for equal bits, at the shapes of the nets' paths
    (SwinIR's map; StyleGAN2's width; Restormer's and PromptIR's projections and
    attentions, NAFNet-w64's stages, of a 128 x 128 input) plus a ragged shape
    each; CUDA-event ms of the kernel, the plain version and one library
    composite (timed only: the port calls none) beside the bound; at B = 8 the
    device time a call (torch.profiler), K14's and K5''s by pass."""
    import torch
    import torch.nn.functional as F

    from dcpt_tpu_torch import ops
    from dcpt_tpu_torch.ops import fused_act, ln_proj, mdta, naf_ffn, window_process
    from dcpt_tpu_torch.tools.swin_ab import pass_split, print_split

    gen = torch.Generator().manual_seed(22)
    out = {name: {"max_abs_err": 0.0, "bf16_max_abs_err": 0.0} for name in
           ("window_partition_fused", "window_reverse_fused", "fused_bias_leaky_relu", "fused_ln_proj", "naf_expand",
            "mdta_attention")}

    def held(name, dname, got, again, ref, tol, what):
        if got.shape != ref.shape or not torch.isfinite(got.float()).all():
            raise RuntimeError(f"[22] {name} {what} {dname}: bad output {tuple(got.shape)} {got.dtype}")
        if not torch.equal(got, again):
            raise RuntimeError(f"[22] {name} {what} {dname}: two runs on the same inputs differ")
        err, rel = _rel_err(got, ref)
        if rel > tol:
            raise RuntimeError(f"[22] {name} {what} {dname}: error {rel:.3e} relative, limit {tol:.0e}")
        key = "max_abs_err" if dname == "float32" else "bf16_max_abs_err"
        out[name][key] = max(out[name][key], err)
        return rel

    def rand(*shape, dtype=torch.float32, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen) * scale + shift).to(device="cuda", dtype=dtype)

    # K11: SwinIR's map; exact, so the plain version runs in the kernel's dtype
    print(f"  K11 {'B':>3} {'shift':>5} {'dtype':>9} {'part ms':>8} {'plain':>8} {'library':>8} {'rev ms':>8} "
          f"{'plain':>8} {'library':>8} {'bound':>8}  (128 x 128 x {SWIN_C}, ws {SWIN_WS}; exact)")
    k11 = {}
    for dname in ("float32", "bfloat16"):
        for b, shift in K11_CASES:
            x = rand(b, 128, 128, SWIN_C, dtype=getattr(torch, dname))
            ws = SWIN_WS
            with torch.no_grad():
                win, win2 = ops.window_partition_fused(x, ws, shift), ops.window_partition_fused(x, ws, shift)
                back, back2 = ops.window_reverse_fused(win, ws, 128, 128, shift), \
                    ops.window_reverse_fused(win, ws, 128, 128, shift)
                ref = window_process.window_partition_ref(x, ws, shift)
            held("window_partition_fused", dname, win, win2, ref, 0.0, f"B={b} shift={shift}")
            held("window_reverse_fused", dname, back, back2, x, 0.0, f"B={b} shift={shift}")
            if not torch.equal(window_process.window_reverse_ref(win, ws, 128, 128, shift), x):
                raise RuntimeError(f"[22] window_reverse_ref does not undo the partition at B={b} shift={shift}")

            def library_part():
                rolled = torch.roll(x, (-shift, -shift), (1, 2)) if shift else x
                return rolled.view(b, 128 // ws, ws, 128 // ws, ws, -1).permute(0, 1, 3, 2, 4, 5).contiguous()

            def library_rev():
                y = win.view(b, 128 // ws, 128 // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5).reshape(x.shape)
                return torch.roll(y, (shift, shift), (1, 2)) if shift else y

            if not torch.equal(library_part().view(ref.shape), ref) or \
                    not torch.equal(library_rev(), x):
                raise RuntimeError(f"[22] K11's library composite differs at B={b} shift={shift}")
            with torch.no_grad():
                t = [cuda_ms(lambda: ops.window_partition_fused(x, ws, shift)),
                     cuda_ms(lambda: window_process.window_partition_ref(x, ws, shift)), cuda_ms(library_part),
                     cuda_ms(lambda: ops.window_reverse_fused(win, ws, 128, 128, shift)),
                     cuda_ms(lambda: window_process.window_reverse_ref(win, ws, 128, 128, shift)), cuda_ms(library_rev)]
            bound_ms = bound([(1, 0.0, 2 * x.numel() * x.element_size())])[0]
            k11[(dname, b, shift)] = t + [bound_ms]
            print(f"  K11 {b:>3} {shift:>5} {dname:>9} " + " ".join(f"{v:>8.4f}" for v in t) + f" {bound_ms:>8.4f}",
                  flush=True)
    # per SwinIR forward at B = 1, had it partitioned its windows so: 18 calls at each shift
    for name, cols in (("window_partition_fused", (0, 1, 2)), ("window_reverse_fused", (3, 4, 5))):
        per = [SWIN_PER_FORWARD // 2 * (k11[("float32", 1, 0)][i] + k11[("float32", 1, 4)][i]) for i in cols]
        out[name].update(ms=per[0], plain_ms=per[1], library_ms=per[2],
                         bound_ms=SWIN_PER_FORWARD * k11[("float32", 1, 0)][6], bound_by="bytes",
                         bf16_ms=SWIN_PER_FORWARD // 2 * (k11[("bfloat16", 1, 0)][cols[0]]
                                                          + k11[("bfloat16", 1, 4)][cols[0]]),
                         b8_ms=k11[("float32", 8, 4)][cols[0]], b8_plain_ms=k11[("float32", 8, 4)][cols[1]],
                         b8_library_ms=k11[("float32", 8, 4)][cols[2]], b8_bound_ms=k11[("float32", 8, 4)][6])

    # K12, forward and backward; the plain versions in fp32 on the same rounded inputs
    print(f"  K12 {'shape':>18} {'dtype':>9} {'fwd rel':>9} {'gx rel':>9} {'gb rel':>9} {'fwd ms':>8} {'plain':>8} "
          f"{'library':>8} {'bound':>8} {'bwd ms':>8} {'plain':>8} {'bound':>8}")
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        for shape in (K12_SHAPE, K12_RAGGED):
            x, g = rand(*shape, dtype=dtype), rand(*shape, dtype=dtype)
            b = rand(shape[-1], dtype=dtype, scale=0.2)
            x[0, 0] = -b  # x + b == 0: the strict mask takes the slope
            grads = []
            for _ in range(2):
                xr, br = x.clone().requires_grad_(), b.clone().requires_grad_()
                y = ops.fused_bias_leaky_relu(xr, br)
                y.backward(g)
                grads.append((y.detach(), xr.grad, br.grad))
            ref, mask = fused_act.fused_bias_leaky_relu_ref(x.float(), b.float())
            gx_ref = fused_act.fused_bias_leaky_relu_bwd_ref(g.float(), mask)
            what = "x".join(map(str, shape))
            rels = [held("fused_bias_leaky_relu", dname, a, a2, r, STANDALONE_TOL[dname], what + " " + n)
                    for (a, a2, r, n) in zip(grads[0], grads[1], (ref, gx_ref, gx_ref.reshape(-1, shape[-1]).sum(0)),
                                             ("out", "gx", "gb"))]
            if mask[0, 0].any() or (dname == "float32" and
                                    not torch.equal(grads[0][1][0, 0], g[0, 0] * 0.2 * 2 ** 0.5)):
                raise RuntimeError("[22] K12 at x + b == 0: the gradient is not slope * scale * g")
            lib_rel = _rel_err(F.leaky_relu(x.float() + b.float(), 0.2) * 2 ** 0.5, ref)[1]
            if lib_rel > LIBRARY_TOL:
                raise RuntimeError(f"[22] K12's library composite differs by {lib_rel:.3e}")
            kmask = fused_act._forward(x, b, 0.2, 2 ** 0.5)[1]
            lib = fused_act._lib()
            stream = torch.cuda.current_stream().cuda_stream
            with torch.no_grad():
                t = [cuda_ms(lambda: ops.fused_bias_leaky_relu(x, b)),
                     cuda_ms(lambda: fused_act.fused_bias_leaky_relu_ref(x, b)),
                     cuda_ms(lambda: F.leaky_relu(x + b, 0.2) * 2 ** 0.5),
                     cuda_ms(lambda: fused_act._launch_bwd(lib, g, kmask, 0.2, 2 ** 0.5, stream)),
                     cuda_ms(lambda: fused_act.fused_bias_leaky_relu_bwd_ref(g, kmask))]
            n, io = x.numel(), x.element_size()
            peak = PEAK_FP32_FLOPS if dname == "float32" else PEAK_BF16_FLOPS
            fwd_bound, fwd_by = bound([(1, 4.0 * n, 2 * n * io + n + shape[-1] * io)], peak)
            bwd_bound, _ = bound([(1, 2.0 * n, 2 * n * io + n)], peak)
            print(f"  K12 {what:>18} {dname:>9} " + " ".join(f"{r:>9.2e}" for r in rels) + " "
                  + " ".join(f"{v:>8.4f}" for v in (*t[:3], fwd_bound, *t[3:], bwd_bound)), flush=True)
            if shape == K12_SHAPE:
                pre = "" if dname == "float32" else "bf16_"
                out["fused_bias_leaky_relu"].update({
                    pre + "ms": t[0], pre + "plain_ms": t[1], pre + "library_ms": t[2], pre + "bound_ms": fwd_bound,
                    pre + "bwd_ms": t[3], pre + "bwd_plain_ms": t[4], pre + "bwd_bound_ms": bwd_bound})
                if dname == "float32":
                    out["fused_bias_leaky_relu"]["bound_by"] = fwd_by

    # K14 and K5'; the plain versions in fp32 on the same rounded inputs, the library in fp32; the fp32
    # bound at 3xTF32 on the tensor cores (PEAK_TF32_FLOPS / 3), beside it the SIMT fp32 one
    print(f"  K14 {'rows':>6} {'C':>4} {'C_out':>5} {'flavour':>9} {'dtype':>9} {'rel':>9} {'lib rel':>9} {'ms':>8} "
          f"{'plain':>8} {'library':>8} {'bound':>8} {'simt':>8}")
    k14 = {}

    def proj_case(name, rows, c, c_out, flavour, dname, timed):
        dtype = getattr(torch, dname)
        _, ln_bias, eps = flavour
        x = rand(rows, c, dtype=dtype, scale=2.0, shift=0.5)
        ln_w, ln_b = rand(c, dtype=dtype, scale=0.3, shift=1.0), rand(c, dtype=dtype, scale=0.3)
        if not ln_bias:
            ln_b = torch.zeros_like(ln_b)
        w = rand(c, c_out, dtype=dtype, scale=c ** -0.5)
        if name == "naf_expand":
            params = [ln_w, ln_b, w, rand(c_out, dtype=dtype, scale=0.3)]
            fn, ref_fn = (lambda *a: naf_ffn.naf_expand(*a, eps)), (lambda *a: naf_ffn.naf_expand_ref(*a, eps))
        else:
            params = [ln_w, ln_b, w]
            fn = lambda *a: ln_proj.fused_ln_proj(*a, eps, not ln_bias)  # noqa: E731
            ref_fn = lambda *a: ln_proj.ln_proj_ref(*a, eps, not ln_bias)  # noqa: E731
        with torch.no_grad():
            got, again = fn(x, *params), fn(x, *params)
            ref = ref_fn(x.float(), *[p.float() for p in params])
        rel = held(name, dname, got, again, ref, STANDALONE_TOL[dname], f"({rows}, {c}) -> {c_out}")
        t, lib_rel = [float("nan")] * 3, float("nan")
        if timed:

            def library():
                h = F.layer_norm(x, (c,), ln_w, ln_b, eps)
                return F.linear(h, w.t(), params[3] if name == "naf_expand" else None)

            with torch.no_grad():
                if ln_bias:  # F.layer_norm computes the WithBias flavour: hold it to the same function
                    lib_rel = _rel_err(library(), ref)[1]
                    if lib_rel > max(LIBRARY_TOL, STANDALONE_TOL[dname]):
                        raise RuntimeError(f"[22] {name}'s library composite differs by {lib_rel:.3e}")
                t = [cuda_ms(lambda: fn(x, *params)), cuda_ms(lambda: ref_fn(x, *params)), cuda_ms(library)]
        work = [(1, *k14_work(rows, c, c_out, x.element_size(), name == "naf_expand"))]
        b_ms, b_by = bound(work, PEAK_TF32_FLOPS / 3 if dname == "float32" else PEAK_BF16_FLOPS)
        simt_ms = bound(work)[0]
        print(f"  {'K14' if name == 'fused_ln_proj' else 'K5p'} {rows:>6} {c:>4} {c_out:>5} "
              f"{'WithBias' if ln_bias else 'BiasFree':>9} {dname:>9} {rel:>9.2e} {lib_rel:>9.2e} "
              + " ".join(f"{v:>8.4f}" for v in (*t, b_ms, simt_ms)), flush=True)
        return t + [b_ms, b_by]

    for c, s, _, flavour in _k14_shapes():
        for c_out in (3 * c, 2 * int(2.66 * c)):  # qkv, project_in
            k14[(c, s, c_out, flavour)] = proj_case("fused_ln_proj", s * s, c, c_out, flavour, "float32", True)
    bf16_stages = [(c, s) for c, s, _ in K6_BODY if c in (48, 384)]  # the first and the deepest level
    for c, s in bf16_stages:
        for flavour in (RESTORMER_FLAVOUR, PROMPTIR_FLAVOUR):
            for c_out in (3 * c, 2 * int(2.66 * c)):
                k14[(c, "bf16", c_out, flavour)] = proj_case("fused_ln_proj", s * s, c, c_out, flavour, "bfloat16",
                                                             True)
    for dname in ("float32", "bfloat16"):
        proj_case("fused_ln_proj", *K14_RAGGED, PROMPTIR_FLAVOUR, dname, False)
    for net, flavour, shapes in (("", RESTORMER_FLAVOUR, K6_BODY.items()),
                                 ("promptir_", PROMPTIR_FLAVOUR, [*K6_BODY.items(), *K6_NOISE.items()])):
        calls = [(n, c, s, c_out) for (c, s, _), n in shapes for c_out in (3 * c, 2 * int(2.66 * c))]
        ms, plain_ms = (sum(n * k14[(c, s, c_out, flavour)][i] for n, c, s, c_out in calls) for i in (0, 1))
        # F.layer_norm computes the WithBias flavour; its time at the same shapes stands for both
        lib_ms = sum(n * k14[(c, s, c_out, PROMPTIR_FLAVOUR)][2] for n, c, s, c_out in calls)
        work = [(n, *k14_work(s * s, c, c_out)) for n, c, s, c_out in calls]
        b_ms, b_by = bound(work, PEAK_TF32_FLOPS / 3)
        out["fused_ln_proj"].update({net + "ms": ms, net + "plain_ms": plain_ms, net + "library_ms": lib_ms,
                                     net + "bound_ms": b_ms, net + "bound_by": b_by,
                                     net + "simt_bound_ms": bound(work)[0]})
    # one qkv and one project_in call at each of those levels, bf16 beside fp32
    out["fused_ln_proj"]["bf16_ms"] = sum(k14[(c, "bf16", c_out, RESTORMER_FLAVOUR)][0] for c, _ in bf16_stages
                                          for c_out in (3 * c, 2 * int(2.66 * c)))
    out["fused_ln_proj"]["bf16_ms_fp32"] = sum(k14[(c, s, c_out, RESTORMER_FLAVOUR)][0] for c, s in bf16_stages
                                               for c_out in (3 * c, 2 * int(2.66 * c)))
    k5p = {}
    for dname in ("float32", "bfloat16"):
        for c, s, n in K5P_STAGES:
            k5p[(dname, c)] = proj_case("naf_expand", s * s, c, 2 * c, PROMPTIR_FLAVOUR[:2] + (1e-6,), dname, True)
        proj_case("naf_expand", *K5P_RAGGED, PROMPTIR_FLAVOUR[:2] + (1e-6,), dname, False)
    ms, plain_ms, lib_ms = (sum(n * k5p[("float32", c)][i] for c, _, n in K5P_STAGES) for i in range(3))
    work = [(n, *k14_work(s * s, c, 2 * c, 4, True)) for c, s, n in K5P_STAGES]
    b_ms, b_by = bound(work, PEAK_TF32_FLOPS / 3)
    out["naf_expand"].update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                             simt_bound_ms=bound(work)[0],
                             bf16_ms=sum(n * k5p[("bfloat16", c)][0] for c, _, n in K5P_STAGES),
                             bf16_plain_ms=sum(n * k5p[("bfloat16", c)][1] for c, _, n in K5P_STAGES))

    # K13; the plain version in fp32 on the same rounded inputs
    print(f"  K13 {'BH':>3} {'c':>4} {'L':>6} {'act':>7} {'dtype':>9} {'rel':>9} {'lib rel':>9} {'ms':>8} {'plain':>8} "
          f"{'library':>8} {'bound':>8} {'simt':>8}")
    k13 = {}

    def attn_case(bh, c, length, use_softmax, dname, timed):
        dtype = getattr(torch, dname)
        q, k, v = (rand(bh, c, length, dtype=dtype) for _ in range(3))
        t = (torch.rand(bh, 1, 1, generator=gen) + 0.5).to(device="cuda", dtype=dtype)
        with torch.no_grad():
            got, again = mdta.mdta_attention(q, k, v, t, use_softmax), mdta.mdta_attention(q, k, v, t, use_softmax)
            ref = mdta.mdta_ref(q.float(), k.float(), v.float(), t.float(), use_softmax)
        act = "softmax" if use_softmax else "relu"
        rel = held("mdta_attention", dname, got, again, ref, K13_TOL[dname], f"({bh}, {c}, {length}) {act}")

        def library():
            a = torch.bmm(F.normalize(q, dim=-1), F.normalize(k, dim=-1).transpose(1, 2)) * t
            return torch.bmm(a.softmax(-1) if use_softmax else F.relu(a), v)

        times, lib_rel = [float("nan")] * 3, float("nan")
        if timed:
            with torch.no_grad():
                lib_rel = _rel_err(library(), ref)[1]
                if lib_rel > max(LIBRARY_TOL, K13_TOL[dname]):
                    raise RuntimeError(f"[22] K13's library composite differs by {lib_rel:.3e}")
                times = [cuda_ms(lambda: mdta.mdta_attention(q, k, v, t, use_softmax)),
                         cuda_ms(lambda: mdta.mdta_ref(q, k, v, t, use_softmax)), cuda_ms(library)]
        # fp32 at 3xTF32 on the tensor cores (PEAK_TF32_FLOPS / 3), beside it the SIMT fp32 bound
        work = [(1, *k13_work(bh, c, length, q.element_size()))]
        b_ms, b_by = bound(work, PEAK_TF32_FLOPS / 3 if dname == "float32" else PEAK_BF16_FLOPS)
        print(f"  K13 {bh:>3} {c:>4} {length:>6} {act:>7} {dname:>9} {rel:>9.2e} {lib_rel:>9.2e} "
              + " ".join(f"{v:>8.4f}" for v in (*times, b_ms, bound(work)[0])), flush=True)
        return times + [b_ms, b_by]

    for shape, _, flavour in _k13_shapes():
        k13[(shape, flavour)] = attn_case(*shape, flavour[0], "float32", True)
    enc1, latent = _k13_shapes()[0][0], _k13_shapes()[3][0]  # (1, 48, 16384) and (8, 48, 256)
    b8 = attn_case(8, *enc1[1:], False, "float32", True)  # enc1 at the train ymls' batch
    for shape in (enc1, latent):
        for use_softmax in (False, True):
            k13[(shape, "bf16", use_softmax)] = attn_case(*shape, use_softmax, "bfloat16", True)
    for dname in ("float32", "bfloat16"):
        for use_softmax in (False, True):
            attn_case(*K13_RAGGED, use_softmax, dname, False)
    for net, flavour in (("", RESTORMER_FLAVOUR), ("promptir_", PROMPTIR_FLAVOUR)):
        calls = [(shape, n) for shape, n, fl in _k13_shapes() if fl == flavour]
        ms, plain_ms, lib_ms = (sum(n * k13[(shape, flavour)][i] for shape, n in calls) for i in range(3))
        work = [(n, *k13_work(*shape)) for shape, n in calls]
        b_ms, b_by = bound(work, PEAK_TF32_FLOPS / 3)
        out["mdta_attention"].update({net + "ms": ms, net + "plain_ms": plain_ms, net + "library_ms": lib_ms,
                                      net + "bound_ms": b_ms, net + "bound_by": b_by,
                                      net + "simt_bound_ms": bound(work)[0]})
    out["mdta_attention"].update(b8_ms=b8[0], b8_plain_ms=b8[1], b8_library_ms=b8[2], b8_bound_ms=b8[3],
                                 bf16_ms=k13[(enc1, "bf16", False)][0], bf16_ms_fp32=k13[(enc1, RESTORMER_FLAVOUR)][0])
    print("  K11-K14 and K5' twice on the same inputs: equal bit for bit at every shape", flush=True)

    # device time a call at the train ymls' batch 8 (torch.profiler) beside the library call's: K11 on
    # SwinIR's map at shift 4; K14 at one enc1 TransformerBlock's qkv and project_in (C 48 on 128 x 128,
    # WithBias, the flavour F.layer_norm computes); K5' at NAFNet-w64's c = 512 stage (16 x 16)
    def device_pair(label, fn, library):
        with torch.no_grad():
            k_dev, l_dev = (sum(device_ms_by_function(f, 10)[0].values()) for f in (fn, library))
        print(f"  {label} at B=8: device {k_dev:.4f} ms a call, library {l_dev:.4f} ms", flush=True)
        return k_dev, l_dev

    x, ws, shift = rand(8, 128, 128, SWIN_C), SWIN_WS, SWIN_WS // 2
    win = ops.window_partition_fused(x, ws, shift)
    k11_b8 = {
        "window_partition_fused": device_pair(
            "K11 partition", lambda: ops.window_partition_fused(x, ws, shift),
            lambda: torch.roll(x, (-shift, -shift), (1, 2)).view(8, 128 // ws, ws, 128 // ws, ws, -1)
            .permute(0, 1, 3, 2, 4, 5).contiguous()),
        "window_reverse_fused": device_pair(
            "K11 reverse", lambda: ops.window_reverse_fused(win, ws, 128, 128, shift),
            lambda: torch.roll(win.view(8, 128 // ws, 128 // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
                               .reshape(x.shape), (shift, shift), (1, 2)))}
    for name, (k_dev, l_dev) in k11_b8.items():
        out[name].update(b8_device_ms=k_dev, b8_library_device_ms=l_dev)
    del x, win

    # K14 and K5' by pass (swin_ab.pass_split: each launch of one call in order), beside the library
    # calls' passes, and the call's bound at 3xTF32 and SIMT fp32
    def by_pass(label, fn, library, work, library_label="F.layer_norm + F.linear"):
        with torch.no_grad():
            split, lib_split = pass_split(fn, 10), pass_split(library, 10)
        if not split or not lib_split:
            raise NoDeviceTime(f"torch.profiler recorded no device time for {label}'s passes")
        b_tc, b_simt = bound([(1, *work)], PEAK_TF32_FLOPS / 3)[0], bound([(1, *work)])[0]
        print_split(f"  {label} at B=8, by pass", split)
        print_split(f"  {label} at B=8, {library_label} by pass", lib_split)
        print(f"  {label} at B=8: bound {b_tc:.4f} ms (3xTF32), SIMT fp32 {b_simt:.4f} ms", flush=True)
        return split, lib_split, b_tc, b_simt

    _, _, eps = PROMPTIR_FLAVOUR
    c = next(iter(K6_BODY))[0]  # enc1's width, 48
    x = rand(8 * 128 * 128, c, scale=2.0, shift=0.5)
    ln_w, ln_b = rand(c, scale=0.3, shift=1.0), rand(c, scale=0.3)
    k14_b8 = {"b8_split": [], "b8_library_split": [], "b8_bound_ms": 0.0, "b8_simt_bound_ms": 0.0}
    for c_out in (3 * c, 2 * int(2.66 * c)):  # qkv, project_in
        w = rand(c, c_out, scale=c ** -0.5)
        split, lib_split, b_tc, b_simt = by_pass(
            f"K14 ({x.shape[0]}, {c}) -> {c_out}", lambda: ln_proj.fused_ln_proj(x, ln_w, ln_b, w, eps),
            lambda: F.linear(F.layer_norm(x, (c,), ln_w, ln_b, eps), w.t()), k14_work(x.shape[0], c, c_out))
        k14_b8["b8_split"] += split
        k14_b8["b8_library_split"] += lib_split
        k14_b8["b8_bound_ms"] += b_tc
        k14_b8["b8_simt_bound_ms"] += b_simt
    k14_b8.update(b8_device_ms=sum(ms for _, ms in k14_b8["b8_split"]),
                  b8_library_device_ms=sum(ms for _, ms in k14_b8["b8_library_split"]))
    out["fused_ln_proj"].update(k14_b8)
    c = K45_C
    x = rand(8 * 16 * 16, c, scale=2.0, shift=0.5)
    ln_w, ln_b, w, b1 = rand(c, scale=0.3, shift=1.0), rand(c, scale=0.3), rand(c, 2 * c, scale=c ** -0.5), rand(2 * c)
    split, lib_split, b_tc, b_simt = by_pass(
        f"K5' ({x.shape[0]}, {c}) -> {2 * c}", lambda: naf_ffn.naf_expand(x, ln_w, ln_b, w, b1, 1e-6),
        lambda: F.linear(F.layer_norm(x, (c,), ln_w, ln_b, 1e-6), w.t(), b1), k14_work(x.shape[0], c, 2 * c, 4, True))
    out["naf_expand"].update(b8_device_ms=sum(ms for _, ms in split), b8_library_device_ms=sum(ms for _, ms in lib_split),
                             b8_split=split, b8_library_split=lib_split, b8_bound_ms=b_tc, b8_simt_bound_ms=b_simt)
    # K13 by pass at enc1 at the train ymls' batch (ReLU) and PromptIR's noise_level3 (softmax), beside
    # F.normalize, torch.bmm, act, torch.bmm; the launches of a call as mdta.launches_per_call reckons them
    for key, (bh, c, length), use_softmax in (("b8", (8, 48, 16384), False), ("noise3", (4, 176, 256), True)):
        q, k, v = (rand(bh, c, length) for _ in range(3))
        t = (torch.rand(bh, 1, 1, generator=gen) + 0.5).to("cuda")

        def library():
            a = torch.bmm(F.normalize(q, dim=-1), F.normalize(k, dim=-1).transpose(1, 2)) * t
            return torch.bmm(a.softmax(-1) if use_softmax else F.relu(a), v)

        split, lib_split, b_tc, b_simt = by_pass(
            f"K13 ({bh}, {c}, {length}) {'softmax' if use_softmax else 'relu'}",
            lambda: mdta.mdta_attention(q, k, v, t, use_softmax), library, k13_work(bh, c, length),
            "F.normalize + torch.bmm + act + torch.bmm")
        if len(split) != mdta.launches_per_call(bh, c, length):
            raise RuntimeError(f"[22] K13 at {(bh, c, length)}: {len(split)} launches a call, expected "
                               f"{mdta.launches_per_call(bh, c, length)}")
        out["mdta_attention"].update({key + "_device_ms": sum(ms for _, ms in split),
                                      key + "_library_device_ms": sum(ms for _, ms in lib_split),
                                      key + "_split": split, key + "_launches_per_call": len(split),
                                      key + "_bound_ms": b_tc, key + "_simt_bound_ms": b_simt})
    print(f"  K13: {out['mdta_attention']['b8_launches_per_call']} and {out['mdta_attention']['noise3_launches_per_call']} "
          "launches a call, as mdta.launches_per_call reckons", flush=True)
    return out


def run_standalone_path() -> dict:
    """The standalone ops through the entry points a user calls, every count set to
    0 just before: the shipped Restormer and PromptIR eval nets (the ymls'
    network_g at full width, seeded weights) on one 128 x 128 image each with
    every TransformerBlock through ``_standalone_transformer_forward`` (K14 at
    each qkv and project_in, K13 at each attention), launches per forward
    checked; K11 on SwinIR's map (partition, reverse), K12 forward and backward
    at StyleGAN2's width and K5' at NAFNet-w64's stages.  Then, outside the
    counted run, each net's output against its K6 route and both routes'
    forward times.  Returns the launches and the per-net results."""
    import torch

    from dcpt_tpu_torch import ops
    from dcpt_tpu_torch.archs import build_network
    from dcpt_tpu_torch.archs.restormer_arch import TransformerBlock
    from dcpt_tpu_torch.utils.options import yaml_load

    counted = [ops.window_partition_fused, ops.window_reverse_fused, ops.fused_bias_leaky_relu, ops.fused_ln_proj,
               ops.naf_expand, ops.mdta_attention]
    nets = {}
    WORK.mkdir(parents=True, exist_ok=True)
    for seed, (arch, yml) in enumerate(TRANSFORMER_YMLS.items()):
        ckpt = WORK / f"{arch}_standalone.pth"
        write_transformer_checkpoint(yml, ckpt, seed=40 + seed)
        net = build_network(yaml_load(str(yml))["network_g"])
        net.load_state_dict(torch.load(ckpt, map_location="cpu")["params_ema"], strict=True)
        nets[arch] = net.cuda().eval()
    gen = torch.Generator().manual_seed(23)
    lq = torch.rand(1, 3, 128, 128, generator=gen).cuda()
    x = torch.randn(1, 128, 128, SWIN_C, generator=gen).cuda()
    y = torch.randn(*K12_SHAPE, generator=gen).cuda().requires_grad_()
    b = (0.2 * torch.randn(K12_SHAPE[-1], generator=gen)).cuda().requires_grad_()
    stages = [(torch.randn(1, s, s, c, generator=gen).cuda(), torch.randn(c, 2 * c, generator=gen).cuda() * c ** -0.5)
              for c, s, _ in K5P_STAGES]
    torch.cuda.synchronize()

    for fn in counted:
        fn.launches = 0
    ops.fused_bias_leaky_relu.bwd_launches = 0
    per_net, outs = {}, {}
    for arch, net in nets.items():
        before = {"fused_ln_proj": ops.fused_ln_proj.launches, "mdta_attention": ops.mdta_attention.launches}
        with torch.inference_mode(), mock.patch.object(TransformerBlock, "forward", _standalone_transformer_forward):
            outs[arch] = net(lq)[0]
        per_net[arch] = {k: getattr(ops, k).launches - v for k, v in before.items()}
    with torch.no_grad():
        back = ops.window_reverse_fused(ops.window_partition_fused(x, SWIN_WS, SWIN_WS // 2), SWIN_WS, 128, 128,
                                        SWIN_WS // 2)
    ops.fused_bias_leaky_relu(y, b).square().sum().backward()
    with torch.no_grad():
        for h, w1 in stages:
            c = h.shape[-1]
            ops.naf_expand(h, torch.ones(c, device="cuda"), torch.zeros(c, device="cuda"), w1,
                           torch.zeros(2 * c, device="cuda"))
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counted}
    launches["fused_bias_leaky_relu_bwd"] = ops.fused_bias_leaky_relu.bwd_launches
    print(f"[22] launches on the path: {launches}", flush=True)

    for arch, net in nets.items():
        if per_net[arch] != STANDALONE_PER_FORWARD[arch]:
            raise RuntimeError(f"[22] {arch}: launches {per_net[arch]} per forward, expected "
                               f"{STANDALONE_PER_FORWARD[arch]}")
        with torch.inference_mode():
            ref = net(lq)[0]  # the K6 route
            with mock.patch.object(TransformerBlock, "forward", _standalone_transformer_forward):
                path_ms = cuda_ms(lambda: net(lq), iters=5)
            k6_ms = cuda_ms(lambda: net(lq), iters=5)
        out = outs[arch]
        rel = _rel_err(out, ref)[1]
        print(f"[22] {arch} at 128x128 through K14 + K13 ({per_net[arch]} launches): against the K6 route {rel:.3e} "
              f"relative to max(1, max|ref|) (limit 1e-4); forward {path_ms:.2f} ms (K6 route {k6_ms:.2f} ms)",
              flush=True)
        if out.shape != (1, 3, 128, 128) or not torch.isfinite(out).all() or rel > 1e-4:
            raise RuntimeError(f"[22] {arch}: output {tuple(out.shape)} against the K6 route {rel:.3e}")
        per_net[arch].update(rel=rel, path_ms=path_ms, k6_ms=k6_ms)
    if not torch.equal(back, x) or not torch.isfinite(y.grad).all() or not torch.isfinite(b.grad).all():
        raise RuntimeError("[22] K11's round trip or K12's gradients are wrong")
    if min(launches.values()) == 0:
        raise RuntimeError(f"[22] a kernel of the path was not launched: {launches}")
    return {"launches": launches, "per_net": per_net}

def _flat_force(prefix: str, opt: dict) -> list[str]:
    """--force_yml entries that set the nested ``opt`` under ``prefix``."""
    out = []
    for k, v in opt.items():
        if isinstance(v, dict):
            out += _flat_force(f"{prefix}:{k}", v)
        elif isinstance(v, list):
            out.append(f"{prefix}:{k}=[{','.join(str(x) for x in v)}]")
        else:
            out.append(f"{prefix}:{k}={v}")
    return out


def _launch_counts() -> dict:
    from dcpt_tpu_torch.ops.layernorm2d import layer_norm_2d
    from dcpt_tpu_torch.ops.naf_block import naf_block_fused
    from dcpt_tpu_torch.ops.naf_block_bwd import naf_block_bwd

    return {"naf_block_fused": naf_block_fused.launches, "naf_block_bwd": naf_block_bwd.launches,
            "layer_norm_2d": layer_norm_2d.launches + layer_norm_2d.bwd_launches}


def _zero_launches() -> None:
    from dcpt_tpu_torch.ops.layernorm2d import layer_norm_2d
    from dcpt_tpu_torch.ops.naf_block import naf_block_fused
    from dcpt_tpu_torch.ops.naf_block_bwd import naf_block_bwd

    naf_block_fused.launches = naf_block_bwd.launches = layer_norm_2d.launches = layer_norm_2d.bwd_launches = 0


def _check_launches(label: str, want: dict) -> dict:
    got = _launch_counts()
    print(f"{label} launches K1 {got['naf_block_fused']}, K2 {got['naf_block_bwd']}, K3 {got['layer_norm_2d']} "
          f"(forward + backward); reckoned {want}", flush=True)
    if got != want:
        raise RuntimeError(f"{label} launches {got}, reckoned {want}")
    return got


def _params_sum(net) -> float:
    import torch

    with torch.no_grad():
        return sum(p.double().abs().sum().item() for p in net.parameters())


def run_probe_finetune() -> dict:
    """[23] DCPT's stage 2 and stage 3 through train_pipeline at full width, batch 8,
    gt_size 128, on synthetic sets with the dehaze set as .jpg (the ymls' suffix):

    * the probe, ``train_NAFNet_dc_probe_5d.yml`` (DCModel: net_g frozen, its
      skip-tail forward under no_grad on K1's inference route, the classifier
      trained, K3 forward and backward): 3 iterations from [7]'s stage-1
      snapshot, top-1 validation every 2 on a ConcatDataset of 2 images a
      class, a SIGTERM sent during iteration 2 (the run saves 2.state and
      returns), ``--auto_resume`` to the end; the validation once more on the
      plain path, top-1 equal;
    * the fine-tune, ``train_NAFNet_dcdist_5d.yml`` (DCDistModel: the classifier
      frozen, gradients through it into net_g's taps) with ``accumulate_steps``
      2: 3 iterations from [7]'s snapshots, the parameters unchanged after
      micro-iteration 1 and changed after 2, PSNR / SSIM on 2 images through K1
      on the EMA net after the final save, against the plain route; one step's
      gradients through the kernels against the plain path at batch 8
      (``check_step_gradients``, float64 at batch 2);
    * one fp32 and one mixed-precision step of each model, K1 / K2 / K3 counted
      on their own (the kernels line's launches a step), no plain version run in
      the mixed one; ms a step (fp32, bf16) and peak memory of both.

    K1 / K2 / K3 launches of every run equal the reckoned counts: per probe step
    36 / 0 / 2 x 16, per fine-tune step 36 / 36 / 2 x 16, per validation batch
    36 / 0 / 16 (probe) and 36 / 0 / 0 (fine-tune)."""
    import os
    import shutil
    import signal

    import cv2
    import numpy as np
    import torch

    from dcpt_tpu_torch.models.degradation_classification_distillation_model import DCDistModel
    from dcpt_tpu_torch.models.degradation_classification_model import DCModel
    from dcpt_tpu_torch.ops import layernorm2d as ln
    from dcpt_tpu_torch.ops import naf_block as nb
    from dcpt_tpu_torch.ops import naf_block_bwd as nbb
    from dcpt_tpu_torch.train import train_pipeline
    from dcpt_tpu_torch.utils.options import yaml_load

    stage1 = ROOT / "build" / "chip_smoke_train" / "experiments" / "NAFNet_dcpt_5d_pretrain" / "models"
    if not (stage1 / "net_g_latest.pth").exists():
        raise RuntimeError(f"[23] no stage-1 snapshot in {stage1}: [7] writes it")
    work = ROOT / "build" / "chip_smoke_stages"
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    force = write_train_sets(work / "train", jpeg_dehaze=True) + ["datasets:train:num_worker_per_gpu=0"]
    val_batch, val_images = 2, 2
    val_force = write_train_sets(work / "val", n=val_images, jpeg_dehaze=True, phase="val", seed=9)
    sets = yaml_load(str(PROBE_YML))["datasets"]["train"]["datasets"]
    val_force += _flat_force("datasets:val", {
        "name": "dcpt_5d_val", "type": "ConcatDataset", "batch_size_per_gpu": val_batch, "num_worker_per_gpu": 0,
        "datasets": {k: {kk: vv for kk, vv in v.items() if not kk.startswith("dataroot")} for k, v in sets.items()}})
    print(f"[23] wrote 5 x 8 synthetic 160x160 train sets and 5 x {val_images} val sets, the dehaze set as JPEG "
          f"(cv2 {cv2.__version__}) in {time.perf_counter() - t0:.1f} s", flush=True)
    common = ["logger:use_tb_logger=false", "logger:print_freq=1", "logger:save_checkpoint_freq=100",
              "train:scheduler:periods=[3]"]
    val_batches = 5 * val_images // val_batch
    out = {}

    # -- the probe --------------------------------------------------------------------
    probe_args = ["-opt", str(PROBE_YML), "--force_yml", *force, *val_force, *common, "val:val_freq=2",
                  "train:total_iter=3", f"path:pretrain_network_g={stage1 / 'net_g_latest.pth'}"]
    real_step = DCModel.optimize_parameters

    def signalled_step(self, current_iter):
        if current_iter == 2:
            os.kill(os.getpid(), signal.SIGTERM)  # during iteration 2: the handler records it, the step goes on
        real_step(self, current_iter)

    _zero_launches()
    t0 = time.perf_counter()
    handler = signal.getsignal(signal.SIGTERM)
    with mock.patch.object(DCModel, "optimize_parameters", signalled_step):
        stopped = train_pipeline(str(work), args=probe_args)
    torch.cuda.synchronize()
    exp = work / "experiments" / "NAFNet_dc_probe_5d"
    states = sorted(os.listdir(exp / "training_states"))
    step = stopped.optimizer_dc.state_dict()["state"][0]["step"].item()
    print(f"[23] probe, {PROBE_YML.name} from [7]'s stage-1 net_g, SIGTERM during iteration 2: returned after "
          f"{time.perf_counter() - t0:.1f} s with training states {states}, optimizer at step {step:.0f}, losses "
          f"{dict(stopped.log_dict)}, top-1 at 2: {stopped.metric_results['top-1']:.2f} %", flush=True)
    if states != ["2.state"] or step != 2 or not (exp / "models" / "net_dc_2.pth").exists():
        raise RuntimeError(f"[23] the SIGTERM save: states {states}, optimizer step {step}")
    if signal.getsignal(signal.SIGTERM) != handler:
        raise RuntimeError(f"[23] the SIGTERM handler was not restored: {signal.getsignal(signal.SIGTERM)}")
    probe_per_step = {"naf_block_fused": 36, "naf_block_bwd": 0, "layer_norm_2d": 2 * K3_PER_STEP}
    probe_per_val = {"naf_block_fused": 36 * val_batches, "naf_block_bwd": 0,
                     "layer_norm_2d": K3_PER_STEP * val_batches}
    _check_launches("[23] probe iterations 1-2 and the validation at 2:",
                    {k: 2 * probe_per_step[k] + probe_per_val[k] for k in probe_per_step})
    del stopped

    _zero_launches()
    seen = []
    real_val = DCModel.nondist_validation

    def recorded_val(self, dataloader, current_iter, tb_logger, save_img=False, clamp=True):
        torch.cuda.synchronize()
        t = time.perf_counter()
        real_val(self, dataloader, current_iter, tb_logger, save_img, clamp)
        torch.cuda.synchronize()
        seen.append((dataloader, current_iter, self.metric_results["top-1"], 1e3 * (time.perf_counter() - t)))

    with mock.patch.object(DCModel, "nondist_validation", recorded_val):
        probe = train_pipeline(str(work), args=["--auto_resume", *probe_args])
    torch.cuda.synchronize()
    step = probe.optimizer_dc.state_dict()["state"][0]["step"].item()
    loader, _, top1, probe_val_ms = seen[-1]
    print(f"[23] probe --auto_resume from 2.state: optimizer at step {step:.0f}, losses {dict(probe.log_dict)}, "
          f"top-1 after the final save {top1:.2f} % over {len(loader)} batches of {val_batch} "
          f"({probe_val_ms:.1f} ms)", flush=True)
    if step != 3 or not (exp / "models" / "net_dc_latest.pth").exists() or [s[1] for s in seen] != [4]:
        raise RuntimeError(f"[23] probe resume: optimizer step {step}, validations at {[s[1] for s in seen]}")
    _check_launches("[23] probe iteration 3 and the validation after the final save:",
                    {k: probe_per_step[k] + probe_per_val[k] for k in probe_per_step})
    with plain_path():
        probe.nondist_validation(loader, 4, None)
    print(f"[23] probe top-1 on the plain path {probe.metric_results['top-1']:.2f} % (kernels {top1:.2f} %)",
          flush=True)
    if probe.metric_results["top-1"] != top1 or len(loader) != val_batches:
        raise RuntimeError(f"[23] probe top-1 {top1} through the kernels, {probe.metric_results['top-1']} plain")
    out["probe"] = {"top1": top1, "val_ms": probe_val_ms,
                    "loss": dict(probe.log_dict)}

    # -- the fine-tune --------------------------------------------------------------------
    dist_val = _flat_force("datasets:val", {"name": "derain_val", "type": "PairedImageDataset",
                                            "batch_size_per_gpu": 2, "num_worker_per_gpu": 0,
                                            "io_backend": {"type": "disk"}})
    dist_val += [f"datasets:val:dataroot_gt={work / 'val' / 'd1_derain' / 'gt'}",
                 f"datasets:val:dataroot_lq={work / 'val' / 'd1_derain' / 'lq'}"]
    dist_args = ["-opt", str(DIST_YML), "--force_yml", *force, *dist_val, *common, "val:val_freq=100",
                 "train:total_iter=3", "train:accumulate_steps=2",
                 f"path:pretrain_network_g={stage1 / 'net_g_latest.pth'}",
                 f"path:pretrain_network_dc={stage1 / 'net_dc_latest.pth'}"]
    sums, seen = [], []
    real_step, real_val = DCDistModel.optimize_parameters, DCDistModel.nondist_validation

    def summed_step(self, current_iter):
        if not sums:
            sums.append(_params_sum(self.net_g))
        real_step(self, current_iter)
        sums.append(_params_sum(self.net_g))

    def recorded_dist_val(self, dataloader, current_iter, tb_logger, save_img, clamp=True, dataset_idx=0):
        torch.cuda.synchronize()
        t = time.perf_counter()
        real_val(self, dataloader, current_iter, tb_logger, save_img, clamp, dataset_idx)
        torch.cuda.synchronize()
        seen.append((dataloader, dict(self.metric_results), 1e3 * (time.perf_counter() - t)))

    _zero_launches()
    t0 = time.perf_counter()
    with mock.patch.object(DCDistModel, "optimize_parameters", summed_step), \
            mock.patch.object(DCDistModel, "nondist_validation", recorded_dist_val):
        dist = train_pipeline(str(work), args=dist_args)
    torch.cuda.synchronize()
    step = dist.optimizer_g.state_dict()["state"][0]["step"].item()
    loader, metrics, dist_val_ms = seen[-1]
    print(f"[23] fine-tune, {DIST_YML.name} with train:accumulate_steps=2 from [7]'s stage-1 snapshots, 3 "
          f"iterations: {time.perf_counter() - t0:.1f} s; sum |net_g| before and after each iteration "
          f"{[f'{v:.6f}' for v in sums]}, optimizer at step {step:.0f}, micro-step {dist._acc_step}, losses "
          f"{dict(dist.log_dict)}; PSNR / SSIM on the EMA net after the final save {metrics} ({dist_val_ms:.1f} ms)",
          flush=True)
    if not (sums[1] == sums[0] and sums[2] != sums[1] and sums[3] == sums[2]) or step != 1 or dist._acc_step != 1:
        raise RuntimeError(f"[23] accumulate_steps 2: parameter sums {sums}, optimizer step {step}")
    if set(dist.log_dict) != {"l_pixel", "l_classify"} or not all(np.isfinite(v) for v in dist.log_dict.values()):
        raise RuntimeError(f"[23] fine-tune losses {dist.log_dict}")
    dist_per_step = {"naf_block_fused": 36, "naf_block_bwd": 36, "layer_norm_2d": 2 * K3_PER_STEP}
    _check_launches("[23] fine-tune 3 iterations and the validation (1 batch of 2) after the final save:",
                    {"naf_block_fused": 3 * 36 + 36, "naf_block_bwd": 3 * 36, "layer_norm_2d": 3 * 2 * K3_PER_STEP})
    with plain_path():
        dist.nondist_validation(loader, 4, None, False)
    print(f"[23] fine-tune PSNR / SSIM on the plain path {dist.metric_results} (kernels {metrics})", flush=True)
    if abs(dist.metric_results["psnr"] - metrics["psnr"]) > 1e-3:
        raise RuntimeError(f"[23] PSNR through K1 {metrics['psnr']} against the plain route "
                           f"{dist.metric_results['psnr']}: more than 1e-3 dB apart")
    grads = check_step_gradients(dist, "[23] fine-tune", batch_size=8, float64_batch=2)
    out["finetune"] = {"psnr": metrics["psnr"],
                       "plain_psnr": dist.metric_results["psnr"], "val_ms": dist_val_ms,
                       "loss": dict(dist.log_dict), "grad_worst_ratio": grads["worst_ratio"]}

    # -- one mixed step of each, the step times -----------------------------------------------
    plain_calls = {"block": 0, "block_bwd": 0, "layer_norm_2d": 0}

    def counted(key, fn):
        def wrapper(*a, **k):
            plain_calls[key] += 1
            return fn(*a, **k)
        return wrapper

    dist.accumulate_steps = 1  # a step of the optimizer at every call from here on
    for name, model, per_step in (("probe", probe, probe_per_step), ("finetune", dist, dist_per_step)):
        model.feed_data(grad_batch(8))
        _zero_launches()  # one fp32 step counted on its own: the kernels line's launches a step
        model.optimize_parameters(0)
        torch.cuda.synchronize()
        out[name]["launches_per_step"] = _check_launches(f"[23] {name}, one fp32 step at batch 8:", per_step)
        model.mixed_precision = True
        _zero_launches()
        with mock.patch.object(nb, "_ref_forward", counted("block", nb._ref_forward)), \
                mock.patch.object(nbb, "naf_block_bwd_ref", counted("block_bwd", nbb.naf_block_bwd_ref)), \
                mock.patch.object(ln, "layer_norm_2d_ref", counted("layer_norm_2d", ln.layer_norm_2d_ref)):
            model.optimize_parameters(0)
            torch.cuda.synchronize()
        got = _check_launches(f"[23] {name}, one mixed-precision step at batch 8 (plain versions run {plain_calls}):",
                              per_step)
        if any(plain_calls.values()) or not all(np.isfinite(v) for v in model.log_dict.values()):
            raise RuntimeError(f"[23] {name} mixed step: plain versions {plain_calls}, losses {model.log_dict}")
        bf16_ms, bf16_peak = ms_per_step(model, 3)
        model.mixed_precision = False
        fp32_ms, fp32_peak = ms_per_step(model, 3)
        print(f"[23] {name} step at batch 8, 128 x 128: fp32 {fp32_ms:.2f} ms/step (peak {fp32_peak:.0f} MiB), bf16 "
              f"{bf16_ms:.2f} ms/step (peak {bf16_peak:.0f} MiB), through K1 / K2 / K3 ({card_line()})", flush=True)
        out[name].update(bf16_launches_per_step=got, fp32_ms=fp32_ms, fp32_peak_mib=fp32_peak, bf16_ms=bf16_ms,
                         bf16_peak_mib=bf16_peak)
    del probe, dist
    return out


PHASE_RESULT = "CHIP_SMOKE_PHASE_RESULT "
PHASE_LOST = "CHIP_SMOKE_PHASE_NO_DEVICE_TIME"  # a --serve process's line when a profile recorded no device time
NO_DEVICE_TIME = 3  # a fresh process's exit code when a profile of its phase recorded no device time
# set once torch.profiler has recorded no device time in this process
_profiler_lost = False
# the fresh process (--serve) that runs the profiling phases one after another once this process's
# profiler is lost: one interpreter, CUDA context and cuDNN cache for all of them, not one a phase
_server = None


def _start_server(env: dict | None = None):
    """A --serve process on the same card, with ``env``'s variables set over this one's."""
    import gc
    import os

    import torch

    gc.collect()  # the earlier phases' tensors, before the child takes its memory from the same card
    torch.cuda.empty_cache()
    return subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--serve"], stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, text=True, env=None if env is None else {**os.environ, **env})


def _stop(proc) -> None:
    proc.stdin.close()
    try:
        proc.wait(timeout=120)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def _stop_server() -> None:
    global _server
    if _server is not None:
        _stop(_server)
        _server = None


def _on_server(proc, fn, args):
    """``fn(*args)`` on the --serve process ``proc``, its output passed on.  Returns the result,
    or None when a profile there recorded no device time (the process then ends); raises if the
    phase failed."""
    proc.stdin.write(json.dumps([fn.__name__, args]) + "\n")
    proc.stdin.flush()
    for line in proc.stdout:
        if line.startswith(PHASE_RESULT):
            return json.loads(line[len(PHASE_RESULT):])
        if line.startswith(PHASE_LOST):
            return None
        print(line, end="", flush=True)
    raise RuntimeError(f"{fn.__name__} failed in a fresh process (exit code {proc.wait()})")


def _serve() -> int:
    """--serve: run each phase named on a line of stdin (``[name, args]``), print its output, then its
    result line; end at the end of stdin, or after a profile that recorded no device time."""
    import gc

    import torch

    for line in sys.stdin:
        name, args = json.loads(line)
        try:
            result = globals()[name](*args)
        except NoDeviceTime as e:
            print(f"  {e}", flush=True)
            print(PHASE_LOST, flush=True)
            return NO_DEVICE_TIME
        print(PHASE_RESULT + json.dumps(result), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


def run_phase(fn, *args, env: dict | None = None, profiles: bool = True):
    """``fn(*args)``, a phase whose arguments and result are JSON.  If a profile
    of the phase records no device time, the phase runs once more in a fresh
    process on the same card (``--serve``), its output passed on, and so does
    every phase after it that ``profiles``, in that same process (one that
    takes no torch.profiler trace runs here all the same); if a profile there
    records none too, one more fresh process runs it and the later ones, and a
    profile there that records none fails the script.
    With ``env`` the phase runs in a --serve process of its own with those
    variables set (the port reads its routes' switches at import), stopped
    after it."""
    global _profiler_lost, _server
    t0 = time.perf_counter()
    if env is not None:
        proc = _start_server(env)
        try:
            result = _on_server(proc, fn, list(args))
        finally:
            _stop(proc)
        if result is None:
            raise RuntimeError(f"{fn.__name__}: torch.profiler recorded no device time in its fresh process")
        print(f"  ({fn.__name__}, fresh process: {time.perf_counter() - t0:.1f} s)", flush=True)
        return result
    if not _profiler_lost or not profiles:
        try:
            result = fn(*args)
            print(f"  ({fn.__name__}: {time.perf_counter() - t0:.1f} s)", flush=True)
            return result
        except NoDeviceTime as e:
            print(f"  {e}: {fn.__name__} again in a fresh process", flush=True)
            _profiler_lost = True
    for attempt in range(2):
        if _server is None:
            _server = _start_server()
        result = _on_server(_server, fn, list(args))
        if result is not None:
            print(f"  ({fn.__name__}, fresh process: {time.perf_counter() - t0:.1f} s)", flush=True)
            return result
        _stop_server()
        if attempt == 0:
            print(f"  {fn.__name__} again in another fresh process: the profiler recorded no device time",
                  flush=True)
    raise RuntimeError(f"{fn.__name__}: torch.profiler recorded no device time in two fresh processes")


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
    if sys.argv[1:2] == ["--serve"]:  # run_phase's fresh process: phases named on stdin
        return _serve()
    try:
        return _main(torch)
    finally:
        _stop_server()


def _main(torch) -> int:

    card = card_line()
    print(f"[1] card: {card}", flush=True)
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    build_s = build_kernels()
    print(f"[2] built K1, K2, K3, K6, K7, K8, K10, K9, K4, K5, K11, K12, K14 (with K5'), K13 in "
          f"{', '.join(f'{b:.1f}' for b in build_s)} s (nvcc, in parallel), "
          f"phase {time.perf_counter() - t0:.1f} s", flush=True)

    print("[3] K1 naf_block_fused vs naf_block_ref, B=2 (and 8 at C=64 and 512), TF32 off", flush=True)
    k1 = run_phase(check_k1)
    print(f"[3] K1 per NAFNet-w64 forward (B=2, 128x128, 36 blocks): kernel {k1['ms']:.3f} ms (device "
          f"{k1['device_ms']:.3f} ms), plain {k1['plain_ms']:.3f} ms, bound {k1['bound_ms']:.3f} ms ({k1['bound_by']}, 3xTF32 on the tensor "
          f"cores; SIMT fp32 {k1['simt_bound_ms']:.3f} ms); one call at B=8, C=64: {k1['b8_ms']:.3f} ms (bf16 "
          f"{k1['b8_bf16_ms']:.3f} ms, plain {k1['b8_plain_ms']:.3f} ms, bound {k1['b8_bound_ms']:.3f} ms, SIMT fp32 "
          f"{k1['b8_simt_bound_ms']:.3f} ms)", flush=True)

    force = run_phase(run_slice)

    print(f"[5] K2 naf_block_bwd vs naf_block_bwd_ref, B=2 (and 8 at C=64, 128x128), fp32, limit {K2_TOL:.0e} "
          f"relative", flush=True)
    k2 = run_phase(check_k2)
    print(f"[5] K2 per NAFNet-w64 backward (B=2, 128x128, 36 blocks): kernel {k2['ms']:.3f} ms, "
          f"plain {k2['plain_ms']:.3f} ms, bound {k2['bound_ms']:.3f} ms ({k2['bound_by']}, 3xTF32 on the tensor "
          f"cores; SIMT fp32 {k2['simt_bound_ms']:.3f} ms); one call at B=8, C=64: {k2['b8_ms']:.3f} ms (plain "
          f"{k2['b8_plain_ms']:.3f} ms, bound {k2['b8_bound_ms']:.3f} ms, SIMT fp32 {k2['b8_simt_bound_ms']:.3f} ms)",
          flush=True)

    print("[6] K3 layer_norm_2d forward + backward vs plain and F.layer_norm, fp32, limit 1e-4", flush=True)
    k3 = run_phase(check_k3)
    print(f"[6] K3 per DCPT step ({K3_PER_STEP} calls each way at batch 8): device {k3['ms']:.3f} ms (plain "
          f"{k3['plain_ms']:.3f} ms, F.layer_norm + backward {k3['library_ms']:.3f} ms), back-to-back calls "
          f"{k3['call_ms']:.3f} ms (F.layer_norm + backward {k3['library_call_ms']:.3f} ms), bound {k3['bound_ms']:.3f} "
          f"ms ({k3['bound_by']})", flush=True)

    train = run_phase(run_training)
    # [7] drives the yml's loader with its four spawned workers; the later training phases load
    # in the process (each loader's workers take about 7 s to start, some 100 s over the script)
    in_process = [*train["force"], "datasets:train:num_worker_per_gpu=0"]

    print("[8] K6 mdta_block_fused vs mdta_block_ref, B=1 (and 8 at 128x128), TF32 off; limits 1e-4 (fp32), 2e-2 "
          "(bf16) relative to max(1, max|ref|)", flush=True)
    k6 = run_phase(check_k6)
    for net, pre, blocks in (("Restormer", "", 44), ("PromptIR", "promptir_", 47)):
        print(f"[8] K6 per {net} forward (128x128, {blocks} blocks): device {k6[pre + 'ms']:.3f} ms (plain "
              f"{k6[pre + 'plain_ms']:.3f} ms), back-to-back calls {k6[pre + 'call_ms']:.3f} ms (plain "
              f"{k6[pre + 'plain_call_ms']:.3f} ms), bound {k6[pre + 'bound_ms']:.3f} ms ({k6[pre + 'bound_by']}, "
              f"3xTF32 on the tensor cores; SIMT fp32 {k6[pre + 'simt_bound_ms']:.3f} ms)", flush=True)
    print(f"[8] K6 one call at B=8, C={K7_BATCH8[0][0]}, 128x128, relu: device {k6['b8_ms']:.3f} ms (bf16 "
          f"{k6['b8_bf16_ms']:.3f} ms, plain {k6['b8_plain_ms']:.3f} ms), back-to-back calls {k6['b8_call_ms']:.3f} "
          f"ms, bound {k6['b8_bound_ms']:.3f} ms (SIMT fp32 {k6['b8_simt_bound_ms']:.3f} ms)", flush=True)

    k6_launches = run_phase(run_transformer_slices, force)

    print(f"[10] K7 mdta_block_bwd vs mdta_block_bwd_ref, B=2 (and 8 at 128x128), fp32, TF32 off, limit "
          f"{K7_TOL:.0e} relative",
          flush=True)
    k7 = run_phase(check_k7)
    for net, pre, blocks in (("Restormer", "", 44), ("PromptIR", "promptir_", 47)):
        print(f"[10] K7 per {net} backward (B=2, 128x128, {blocks} blocks): device {k7[pre + 'ms']:.3f} ms (plain "
              f"{k7[pre + 'plain_ms']:.3f} ms), back-to-back calls {k7[pre + 'call_ms']:.3f} ms (plain "
              f"{k7[pre + 'plain_call_ms']:.3f} ms), bound {k7[pre + 'bound_ms']:.3f} ms ({k7[pre + 'bound_by']}, "
              f"3xTF32 on the tensor cores; SIMT fp32 {k7[pre + 'simt_bound_ms']:.3f} ms)", flush=True)
    print(f"[10] K7 one call at B=8, C={K7_BATCH8[0][0]}, 128x128, relu: device {k7['b8_ms']:.3f} ms (plain "
          f"{k7['b8_plain_ms']:.3f} ms), back-to-back calls {k7['b8_call_ms']:.3f} ms, bound {k7['b8_bound_ms']:.3f} "
          f"ms (SIMT fp32 {k7['b8_simt_bound_ms']:.3f} ms)", flush=True)

    transformer_train = run_phase(run_transformer_training, in_process)

    print(f"[12] K8 fused_swin_block vs swin_block_map_ref, K10 fused_window_attention(_ln) vs "
          f"window_attention_map_ref, C {SWIN_C}, {SWIN_HEADS} heads, ws {SWIN_WS}, TF32 off; limits 1e-4 (fp32), 2e-2 "
          f"(bf16) relative to max(1, max|ref|)", flush=True)
    swin = run_phase(check_k8_k10)
    for name, k in swin.items():
        print(f"[12] {name} per SwinIR forward (128x128, {SWIN_PER_FORWARD} blocks): device {k['ms']:.3f} ms (plain "
              f"{k['plain_ms']:.3f} ms), back-to-back calls {k['call_ms']:.3f} ms (plain {k['plain_call_ms']:.3f} ms), "
              f"bound {k['bound_ms']:.3f} ms ({k['bound_by']}, 3xTF32 on the tensor cores; SIMT fp32 "
              f"{k['simt_bound_ms']:.3f} ms)", flush=True)
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
          f"bound {k9['bound_ms']:.3f} ms ({k9['bound_by']}, 3xTF32 on the tensor cores; SIMT fp32 "
          f"{k9['simt_bound_ms']:.3f} ms); one call at B=8: {k9['b8_ms']:.3f} ms (plain {k9['b8_plain_ms']:.3f} ms, "
          f"bound {k9['b8_bound_ms']:.3f} ms, SIMT fp32 {k9['b8_simt_bound_ms']:.3f} ms); library: none (no PyTorch "
          f"call computes the block's backward)", flush=True)

    swin_train = run_phase(run_swinir_training, in_process)

    print(f"[16] K4 naf_prefix vs naf_prefix_ref and K5 naf_ffn vs naf_ffn_ref at C={K45_C}, TF32 off; limits 1e-4 "
          f"(fp32), 2e-2 (bf16) relative to max(1, max|ref|)", flush=True)
    k45 = run_phase(check_k4_k5)
    for name in ("naf_prefix", "naf_ffn"):
        k = k45[name]
        print(f"[16] {name} per NAFNet-w64 forward (B=1, 128x128, {K45_PER_FORWARD} blocks at C={K45_C}): kernel "
              f"{k['ms']:.3f} ms (bf16 {k['bf16_ms']:.3f}), plain {k['plain_ms']:.3f} ms (bf16 "
              f"{k['bf16_plain_ms']:.3f}), library {k['library_ms']:.3f} ms, bound {k['bound_ms']:.3f} ms "
              f"({k['bound_by']}, 3xTF32 on the tensor cores; SIMT fp32 {k['simt_bound_ms']:.3f} ms); one call at B=8: "
              f"{k['b8_ms']:.4f} ms (device {k['b8_device_ms']:.4f} ms; bf16 {k['b8_bf16_ms']:.4f} ms), library "
              f"{k['b8_library_ms']:.4f} ms (device {k['b8_library_device_ms']:.4f} ms), plain {k['b8_plain_ms']:.4f} "
              f"ms, bound {k['b8_bound_ms']:.4f} ms (SIMT fp32 {k['b8_simt_bound_ms']:.4f} ms)", flush=True)

    pallas = run_phase(run_pallas_eval, force, env=PALLAS_ENV)

    print("[18] K2 naf_block_bwd and K3 layer_norm_2d in bf16 vs their plain versions, limit 2e-2 relative to "
          "max(1, max|ref|)", flush=True)
    bf16 = run_phase(check_bf16_k2_k3)
    print(f"[18] K2 bf16 per NAFNet-w64 backward (B=2, 128x128, 36 blocks): kernel {bf16['naf_block_bwd']['ms']:.3f} "
          f"ms, plain {bf16['naf_block_bwd']['plain_ms']:.3f} ms; K3 bf16 per DCPT step ({K3_PER_STEP} calls each "
          f"way): device {bf16['layer_norm_2d']['ms']:.3f} ms (plain {bf16['layer_norm_2d']['plain_ms']:.3f} ms, "
          f"F.layer_norm + backward {bf16['layer_norm_2d']['library_ms']:.3f} ms), back-to-back calls "
          f"{bf16['layer_norm_2d']['call_ms']:.3f} ms (F.layer_norm + backward "
          f"{bf16['layer_norm_2d']['library_call_ms']:.3f} ms), bf16 bound {bf16['layer_norm_2d']['bound_ms']:.3f} ms",
          flush=True)

    mixed = run_phase(run_mixed_training, in_process, ["NAFNet"], "[19]", profiles=False)["NAFNet"]

    print("[20] K7 mdta_block_bwd and K9 swin_block_bwd in bf16 vs their plain versions, limit 2e-2 relative to "
          "max(1, max|ref|)", flush=True)
    bwd16 = run_phase(check_bf16_k7_k9, profiles=False)
    k7b, k9b = bwd16["mdta_block_bwd"], bwd16["swin_block_bwd"]
    for net, pre, blocks in (("Restormer", "", 44), ("PromptIR", "promptir_", 47)):
        print(f"[20] K7 bf16 per {net} backward (B=2, 128x128, {blocks} blocks): {k7b[pre + 'ms']:.3f} ms (fp32 K7 "
              f"{k7b[pre + 'fp32_ms']:.3f} ms, plain bf16 {k7b[pre + 'plain_ms']:.3f} ms), bf16 bound "
              f"{k7b[pre + 'bound_ms']:.3f} ms ({k7b[pre + 'bound_by']}); K6 with its residuals per forward: bf16 "
              f"{k7b[pre + 'k6_ms']:.3f} ms, fp32 {k7b[pre + 'k6_fp32_ms']:.3f} ms", flush=True)
    print(f"[20] K9 bf16 per SwinIR backward (B=2, 128x128, {SWIN_PER_FORWARD} blocks): {k9b['ms']:.3f} ms (fp32 K9 "
          f"{k9b['fp32_ms']:.3f} ms, plain bf16 {k9b['plain_ms']:.3f} ms), bf16 bound {k9b['bound_ms']:.3f} ms "
          f"({k9b['bound_by']}); one call at B=8: {k9b['b8_ms']:.3f} ms (fp32 {k9b['b8_fp32_ms']:.3f}, plain bf16 "
          f"{k9b['b8_plain_ms']:.3f}); K8 per forward (B=2): bf16 {k9b['k8_ms']:.3f} ms, fp32 {k9b['k8_fp32_ms']:.3f} "
          f"ms", flush=True)

    mixed_tf = run_phase(run_mixed_training, in_process, ["Restormer", "PromptIR", "SwinIR"], "[21]",
                         profiles=False)

    print("[22] dcpt_tpu's standalone ops: K11 window_partition_fused / window_reverse_fused, K12 "
          "fused_bias_leaky_relu, K14 fused_ln_proj, K5' naf_expand, K13 mdta_attention vs their plain versions, TF32 "
          "off; limits: K11 exact, K12 / K14 / K5' 1e-5 (fp32), K13 1e-4 (fp32), 2e-2 (bf16), relative to max(1, "
          "max|ref|)", flush=True)
    standalone = run_phase(check_standalone)
    path = run_phase(run_standalone_path, profiles=False)
    for name in ("window_partition_fused", "window_reverse_fused"):
        k = standalone[name]
        print(f"[22] {name} per SwinIR forward's worth (36 calls at B=1, 128x128x{SWIN_C}): {k['ms']:.3f} ms (bf16 "
              f"{k['bf16_ms']:.3f}), plain {k['plain_ms']:.3f} ms, torch.roll + permute().contiguous() "
              f"{k['library_ms']:.3f} ms, bound {k['bound_ms']:.3f} ms (bytes); one call at B=8: {k['b8_ms']:.3f} ms "
              f"(library {k['b8_library_ms']:.3f}, bound {k['b8_bound_ms']:.3f})", flush=True)
    k = standalone["fused_bias_leaky_relu"]
    print(f"[22] fused_bias_leaky_relu at {K12_SHAPE}: forward {k['ms']:.3f} ms (plain {k['plain_ms']:.3f}, "
          f"F.leaky_relu(x + b) * scale {k['library_ms']:.3f}, bound {k['bound_ms']:.3f}), backward {k['bwd_ms']:.3f} "
          f"ms (plain {k['bwd_plain_ms']:.3f}, bound {k['bwd_bound_ms']:.3f}); bf16 forward {k['bf16_ms']:.3f}, "
          f"backward {k['bf16_bwd_ms']:.3f}", flush=True)
    for name, calls in (("fused_ln_proj", "88 / 94 calls"), ("mdta_attention", "44 / 47 calls")):
        k = standalone[name]
        print(f"[22] {name} per Restormer / PromptIR forward (128x128, {calls}): {k['ms']:.3f} / "
              f"{k['promptir_ms']:.3f} ms, plain {k['plain_ms']:.3f} / {k['promptir_plain_ms']:.3f}, library "
              f"{k['library_ms']:.3f} / {k['promptir_library_ms']:.3f}, bound {k['bound_ms']:.3f} / "
              f"{k['promptir_bound_ms']:.3f} ms ({k['bound_by']})", flush=True)
    k = standalone["naf_expand"]
    print(f"[22] naf_expand per NAFNet-w64 forward's worth (35 blocks at C <= 512, B=1, 128x128): {k['ms']:.3f} ms "
          f"(bf16 {k['bf16_ms']:.3f}), plain {k['plain_ms']:.3f}, F.layer_norm + F.linear {k['library_ms']:.3f}, "
          f"bound {k['bound_ms']:.3f} ms ({k['bound_by']})", flush=True)
    print("[22] device time a call at B=8 (torch.profiler), kernel against the library call: " + "; ".join(
        f"{name} {standalone[name]['b8_device_ms']:.4f} against {standalone[name]['b8_library_device_ms']:.4f} ms"
        + (f" (bound {standalone[name]['b8_bound_ms']:.4f} ms, 3xTF32)" if name in ("fused_ln_proj", "naf_expand",
                                                                                  "mdta_attention") else "")
        for name in ("window_partition_fused", "window_reverse_fused", "fused_ln_proj", "naf_expand", "mdta_attention"))
        + " (K11 at 128x128x180, shift 4; K14 one enc1 block's qkv + project_in, C 48 at 128x128, by pass; K5' at "
        "C 512 on 16x16, by pass; K13 at (8, 48, 16384), ReLU, by pass)", flush=True)

    print("[23] DCPT's stage 2 (the probe, DCModel) and stage 3 (the fine-tune, DCDistModel) through train_pipeline "
          "at full width, batch 8, the dehaze set as .jpg", flush=True)
    stages = run_phase(run_probe_finetune, profiles=False)
    for name in ("probe", "finetune"):
        st = stages[name]
        print(f"[23] {name}: {st['fp32_ms']:.2f} ms/step fp32 (peak {st['fp32_peak_mib']:.0f} MiB), "
              f"{st['bf16_ms']:.2f} ms/step bf16 (peak {st['bf16_peak_mib']:.0f} MiB), validation "
              f"{st['val_ms']:.1f} ms; K1 / K2 / K3 launches a step {st['launches_per_step']}", flush=True)

    launches = dict(train["launches"], mdta_block_fused=k6_launches["Restormer"],
                    mdta_block_bwd=transformer_train["Restormer"]["launches"]["mdta_block_bwd"],
                    fused_swin_block=swin_slice["launches"]["K8"]["fused_swin_block"],
                    fused_window_attention=swin_slice["launches"]["K10"]["fused_window_attention"],
                    swin_block_bwd=swin_train["launches"]["swin_block_bwd"],
                    naf_prefix=pallas["launches"]["naf_prefix"], naf_ffn=pallas["launches"]["naf_ffn"],
                    **{k: v for k, v in path["launches"].items() if k in KERNELS})
    kernels = []
    for name, measured in (("naf_block_fused", k1), ("naf_block_bwd", k2), ("layer_norm_2d", k3),
                           ("mdta_block_fused", k6), ("mdta_block_bwd", k7),
                           ("fused_swin_block", swin["fused_swin_block"]),
                           ("fused_window_attention", swin["fused_window_attention"]), ("swin_block_bwd", k9),
                           ("naf_prefix", k45["naf_prefix"]), ("naf_ffn", k45["naf_ffn"]),
                           *((name, standalone[name]) for name in ("window_partition_fused", "window_reverse_fused",
                                                                    "fused_bias_leaky_relu", "fused_ln_proj",
                                                                    "naf_expand", "mdta_attention"))):
        source, replaces = KERNELS[name]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": measured["max_abs_err"],
                        "ms": measured["ms"], "plain_ms": measured["plain_ms"], "bound_ms": measured["bound_ms"],
                        "bound_by": measured["bound_by"], "library_ms": measured["library_ms"]})
    kernels[0].update({k: v for k, v in k1.items() if k not in kernels[0] and k != "b8_split"})
    kernels[3].update(launches_promptir=k6_launches["PromptIR"],
                      **{k: v for k, v in k6.items()
                         if k not in kernels[3] and k not in ("promptir_bound_by", "b8_split")})
    for entry in kernels[5:7]:
        entry.update(launches_per_image=SWIN_PER_FORWARD, call_ms=swin[entry["name"]]["call_ms"],
                     plain_call_ms=swin[entry["name"]]["plain_call_ms"],
                     simt_bound_ms=swin[entry["name"]]["simt_bound_ms"])
    # library_ms is K10 without its LayerNorm: beside it, the kernel's and the plain version's ms without it
    kernels[6].update(no_ln_ms=k10["no_ln_ms"], no_ln_plain_ms=k10["no_ln_plain_ms"])
    kernels[4].update(launches_per_step=TRANSFORMER_PER_STEP["Restormer"]["mdta_block_bwd"],
                      launches_promptir=transformer_train["PromptIR"]["launches"]["mdta_block_bwd"],
                      **{k: v for k, v in k7.items()
                         if k not in kernels[4] and k not in ("promptir_bound_by", "b8_split")})
    kernels[1].update({k: v for k, v in k2.items() if k not in kernels[1] and k != "b8_split"})
    kernels[7].update(launches_per_step=SWIN_PER_STEP["swin_block_bwd"],
                      **{k: k9[k] for k in ("call_ms", "plain_call_ms", "simt_bound_ms", "b8_ms", "b8_plain_ms",
                                            "b8_call_ms", "b8_bound_ms", "b8_simt_bound_ms")})
    for entry, name in ((kernels[1], "naf_block_bwd"), (kernels[2], "layer_norm_2d")):
        b = bf16[name]
        entry.update(bf16_ms=b["ms"], bf16_plain_ms=b["plain_ms"], bf16_max_abs_err=b["max_abs_err"],
                     bf16_launches=mixed["launches"][name])
    kernels[2].update(call_ms=k3["call_ms"], library_call_ms=k3["library_call_ms"],
                      **{"bf16_" + k: bf16["layer_norm_2d"][k]
                         for k in ("library_ms", "call_ms", "library_call_ms", "bound_ms")})
    for entry, name, arch in ((kernels[4], "mdta_block_bwd", "Restormer"), (kernels[7], "swin_block_bwd", "SwinIR")):
        b = bwd16[name]
        entry.update(bf16_ms=b["ms"], bf16_plain_ms=b["plain_ms"], bf16_max_abs_err=b["max_abs_err"],
                     bf16_launches=mixed_tf[arch]["launches"][name], bf16_bound_ms=b["bound_ms"],
                     bf16_bound_by=b["bound_by"], bf16_fp32_ms=b["fp32_ms"])
    kernels[4].update(bf16_launches_promptir=mixed_tf["PromptIR"]["launches"]["mdta_block_bwd"],
                      **{"bf16_" + k: v for k, v in bwd16["mdta_block_bwd"].items()
                         if k.startswith("promptir_") and k != "promptir_bound_by"})
    for entry in kernels[8:10]:
        entry.update(launches_per_image=K45_PER_FORWARD,
                     **{k: v for k, v in k45[entry["name"]].items() if k not in entry and k != "b8_split"})
    # the standalone ops: their extra columns (bf16, backward, B = 8, PromptIR), and the launches per net forward
    for entry in kernels[10:]:
        entry.update({k: v for k, v in standalone[entry["name"]].items() if k not in entry and not k.endswith("_split")})
    kernels[12]["bwd_launches"] = path["launches"]["fused_bias_leaky_relu_bwd"]
    for entry in (kernels[13], kernels[15]):
        entry.update(launches_per_restormer_forward=path["per_net"]["Restormer"][entry["name"]],
                     launches_per_promptir_forward=path["per_net"]["PromptIR"][entry["name"]])
    for entry in kernels[:3]:  # the probe's and the fine-tune's launches in one step, fp32 and bf16, counted in [23]
        entry.update({f"{stage}_{prec}launches_per_step": stages[stage][f"{prec}launches_per_step"][entry["name"]]
                      for stage in ("probe", "finetune") for prec in ("", "bf16_")})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
