"""Where a transformer DCPT step's gradients on the network as it is part from
float64, and why; on one GPU, at the shipped train yml's full width.

    python -m dcpt_tpu_torch.tools.step_grad_noise [--arch Restormer|PromptIR|SwinIR] [--batches 4]
        [--smoothed | --determinism]

For each of ``--batches`` seeded batches of 2 images at 128 x 128 (the batch of
``chip_smoke.py`` [11]'s float64 comparison), with the yml's seeded initial
weights:

1. the probe's switches smoothed (GELUs and average pools, as in
   ``chip_smoke.smooth_switches``) but the attention as it is: the kernel path
   against the plain path in fp32, tensor by tensor, and how many of the
   attention's ReLU switches differ between the two paths' forwards;
2. the network as it is: both fp32 paths against the plain path in float64
   (worst, median, the five worst tensors side by side) and the attention
   switches each fp32 path flips against float64; for every temperature, the
   cancellation of its float64 gradient, sum |ds n| / |sum ds n| over the
   head's logits (n the normalised Gram, ds the logit's cotangent).

With ``--smoothed`` it measures instead [11]'s strict comparison: every switch
smoothed (``chip_smoke.smooth_switches``), a batch of 8, each path run twice
on the same batch and weights; per tensor the kernel path against the plain
path beside each path's own spread from run to run, relative to the tensor's
max|ref|, and the largest max|ref| of the step.

With ``--determinism`` it names what moves a step's gradients from run to
run: every switch smoothed, each path run twice on the same batch of 2 and
weights, first as the step runs, then with PyTorch's deterministic algorithms
on (``torch.use_deterministic_algorithms(True, warn_only=True)``, cuDNN's
deterministic convolutions, cuBLAS's fixed workspace): per mode each path's
spread from run to run, the tensors that moved, and the ops that warned they
have no deterministic kernel on the card.

SwinIR's float64 batch is ``chip_smoke.SWIN_FLOAT64_BATCH``; it has no
attention switches (softmax), so the switch counts read 0 of 0.

Prints one line per batch and measurement; writes nothing.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
from contextlib import ExitStack
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[2]


class _Recorder:
    """Records, in call order, the attention's ReLU switches of every block
    (K6's attn residual on the kernel path, attn_from_stats on the plain path)
    and, when asked, the float64 logits with their gradients retained."""

    def __init__(self, mb, model=None):
        self.mb, self.model = mb, model
        self.masks, self.logits, self._names = [], [], None
        self._attn, self._kernel = mb.attn_from_stats, mb._kernel_forward

    def attn_from_stats(self, gram, qn2, kn2, temperature, heads, use_softmax):
        if self.model is None:
            out = self._attn(gram, qn2, kn2, temperature, heads, use_softmax)
            self.masks.append(out > 0)
            return out
        import torch

        c = gram.shape[1]
        row_t = temperature.reshape(heads).repeat_interleave(c // heads)[None, :, None]
        n = gram * torch.rsqrt(qn2.clamp_min(1e-24))[:, :, None] * torch.rsqrt(kn2.clamp_min(1e-24))[:, None, :]
        logits = n * row_t
        logits.retain_grad()
        head = torch.arange(c, device=gram.device) // (c // heads)
        blk = head[:, None] == head[None, :]
        out = (torch.softmax(logits.masked_fill(~blk, float("-inf")), dim=-1) if use_softmax
               else torch.where(blk, torch.relu(logits), torch.zeros((), dtype=logits.dtype, device=logits.device)))
        self.masks.append(out > 0)
        if self._names is None:  # the parameters' storage now, in the run's dtype
            self._names = {p.data_ptr(): f"net_g.{name}" for name, p in self.model.net_g.named_parameters()}
        self.logits.append((logits, n.detach(), self._names[temperature.data_ptr()], heads, blk))
        return out

    def kernel_forward(self, x, params, *args, residuals=False):
        out = self._kernel(x, params, *args, residuals=residuals)
        if residuals:
            self.masks.append(out[1][3] > 0)
        return out

    def __enter__(self):
        self._stack = ExitStack()
        self._stack.enter_context(mock.patch.object(self.mb, "attn_from_stats", self.attn_from_stats))
        self._stack.enter_context(mock.patch.object(self.mb, "_kernel_forward", self.kernel_forward))
        return self

    def __exit__(self, *exc):
        self._stack.close()


def flips(a: list, b: list) -> int:
    """Attention switches that differ between two runs of the same blocks."""
    return sum(int((x != y).sum()) for x, y in zip(a, b, strict=True))


def cancellation(rec: _Recorder) -> dict[str, float]:
    """For each temperature (by parameter name), max over its heads of
    sum |ds n| / |sum ds n| over the step's calls, from the float64 logits."""
    import torch

    sums: dict[str, list] = {}
    for logits, n, name, heads, blk in rec.logits:
        if logits.grad is None:  # a block whose output reaches no loss
            continue
        terms = torch.where(blk, logits.grad * n, torch.zeros((), dtype=n.dtype, device=n.device))
        per_head = terms.reshape(terms.shape[0], heads, -1, terms.shape[2]).sum(dim=(0, 2, 3))
        per_head_abs = terms.abs().reshape(terms.shape[0], heads, -1, terms.shape[2]).sum(dim=(0, 2, 3))
        s, a = sums.setdefault(name, [0.0, 0.0])
        sums[name] = [s + per_head, a + per_head_abs]
    return {name: (a / s.abs().clamp_min(1e-300)).max().item() for name, (s, a) in sums.items()}


def smoothed(model, batches: int, cs) -> int:
    """[11]'s smoothed comparison at batch 8, each path twice: the kernel path
    against the plain path beside each path's own run-to-run spread."""
    import torch

    for i in range(batches):
        gen = torch.Generator().manual_seed(200 + i)
        gt = torch.rand(8, 3, 128, 128, generator=gen)
        batch = {"gt": gt, "lq": (0.7 * gt + 0.15 + 0.05 * torch.randn(gt.shape, generator=gen)).clamp(0, 1),
                 "dataset_idx": torch.arange(8) % 5}
        with cs.smooth_switches(model):
            k1, k2 = (cs.step_grads(model, batch)[0] for _ in range(2))
            with cs.plain_path():
                p1, p2 = (cs.step_grads(model, batch)[0] for _ in range(2))
        kp, pp, kk = cs.grad_errs(k1, p1), cs.grad_errs(p2, p1), cs.grad_errs(k2, k1)
        scale = max(g.abs().max().item() for g in p1.values())
        top = sorted(kp, key=kp.get, reverse=True)[:8]
        print(f"smoothed batch {i}: kernel vs plain worst {kp[top[0]]:.3e}, {sum(v > 1e-3 for v in kp.values())} of "
              f"{len(kp)} above 1e-3; plain run to run worst {max(pp.values()):.3e}, kernel run to run worst "
              f"{max(kk.values()):.3e}; largest max|ref| {scale:.3e}; worst (kernel vs plain, plain spread, kernel "
              f"spread, max|ref|): " + ", ".join(f"{n} ({kp[n]:.2e}, {pp[n]:.2e}, {kk[n]:.2e}, "
                                                 f"{p1[n].abs().max().item():.2e})" for n in top), flush=True)
        del k1, k2, p1, p2
        torch.cuda.empty_cache()
    return 0


def determinism(model, batches: int, cs) -> int:
    """Each path twice on the same batch, switches smoothed, as the step runs and
    with the deterministic algorithms on: spread, moved tensors, warned ops."""
    import warnings

    import torch

    for i in range(batches):
        gen = torch.Generator().manual_seed(300 + i)
        gt = torch.rand(2, 3, 128, 128, generator=gen)
        batch = {"gt": gt, "lq": (0.7 * gt + 0.15 + 0.05 * torch.randn(gt.shape, generator=gen)).clamp(0, 1),
                 "dataset_idx": torch.arange(2) % 5}
        for mode in ("as the step runs", "deterministic algorithms"):
            deterministic = mode != "as the step runs"
            torch.use_deterministic_algorithms(deterministic, warn_only=True)
            torch.backends.cudnn.deterministic = deterministic
            torch.backends.cudnn.benchmark = False
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                with cs.smooth_switches(model):
                    k1, k2 = (cs.step_grads(model, batch)[0] for _ in range(2))
                    with cs.plain_path():
                        p1, p2 = (cs.step_grads(model, batch)[0] for _ in range(2))
            ops = sorted({str(w.message).split(" does not have")[0].strip() for w in caught
                          if "deterministic" in str(w.message)})
            parts = []
            for path, a, b in (("kernel", k1, k2), ("plain", p1, p2)):
                e = cs.grad_errs(b, a)
                moved = sorted((n for n, v in e.items() if v > 0), key=e.get, reverse=True)
                parts.append(f"{path} path worst {max(e.values()):.3e}, {len(moved)} of {len(e)} tensors moved"
                             + (f" (largest: {', '.join(f'{n} {e[n]:.1e}' for n in moved[:4])})" if moved else ""))
            print(f"batch {i}, {mode}: " + "; ".join(parts) + f"; ops without a deterministic kernel: {ops or 'none'}",
                  flush=True)
            del k1, k2, p1, p2
            torch.cuda.empty_cache()
    torch.use_deterministic_algorithms(False)
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--arch", default="Restormer", choices=["Restormer", "PromptIR", "SwinIR"])
    parser.add_argument("--batches", type=int, default=4)
    parser.add_argument("--smoothed", action="store_true", help="measure the smoothed comparison at batch 8")
    parser.add_argument("--determinism", action="store_true", help="name what moves the gradients from run to run")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    if args.determinism:  # cuBLAS reads it when its first handle is made
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    import chip_smoke as cs
    from dcpt_tpu_torch.models import build_model
    from dcpt_tpu_torch.ops import mdta_block as mb
    from dcpt_tpu_torch.utils.options import parse_options

    if not torch.cuda.is_available():
        print("step_grad_noise: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {cs.card_line()}", flush=True)
    yml = {**cs.TRANSFORMER_TRAIN_YMLS, "SwinIR": cs.SWIN_TRAIN_YML}[args.arch]
    float64_batch = cs.SWIN_FLOAT64_BATCH if args.arch == "SwinIR" else cs.FLOAT64_GRAD_BATCH
    opt, _ = parse_options(str(ROOT / "build" / "step_grad_noise"), is_train=True, args=["-opt", str(yml)])
    torch.manual_seed(opt["manual_seed"])
    model = build_model(opt)
    if args.smoothed:
        return smoothed(model, args.batches, cs)
    if args.determinism:
        return determinism(model, args.batches, cs)
    for i in range(args.batches):
        gen = torch.Generator().manual_seed(100 + i)
        gt = torch.rand(float64_batch, 3, 128, 128, generator=gen)
        batch = {"gt": gt, "lq": (0.7 * gt + 0.15 + 0.05 * torch.randn(gt.shape, generator=gen)).clamp(0, 1),
                 "dataset_idx": torch.arange(float64_batch) % 5}

        with ExitStack() as probe:
            probe.enter_context(mock.patch.object(torch.nn.functional, "relu", lambda x, inplace=False:
                                                  torch.nn.functional.gelu(x)))
            probe.enter_context(mock.patch.object(torch.nn.MaxPool2d, "forward",
                                                  lambda self, x: torch.nn.functional.avg_pool2d(x, 2)))
            with _Recorder(mb) as kr:
                kernel, _ = cs.step_grads(model, batch)
            with cs.plain_path(), _Recorder(mb) as pr:
                plain, _ = cs.step_grads(model, batch)
        e = cs.grad_errs(kernel, plain)
        top = sorted(e, key=e.get, reverse=True)[:5]
        print(f"batch {i}: probe smoothed, attention as it is: kernel vs plain fp32 worst {e[top[0]]:.3e}, median "
              f"{statistics.median(e.values()):.3e}, {sum(v > 1e-3 for v in e.values())} of {len(e)} above 1e-3; "
              f"attention switches that differ {flips(kr.masks, pr.masks)} of "
              f"{sum(int(m.numel()) for m in kr.masks)}; worst: "
              + ", ".join(f"{n} {e[n]:.2e}" for n in top), flush=True)

        with _Recorder(mb) as kr:
            kernel, kl = cs.step_grads(model, batch)
        with cs.plain_path():
            with _Recorder(mb) as pr:
                plain, _ = cs.step_grads(model, batch)
            with _Recorder(mb, model) as fr:
                ref, rl = cs.step_grads(model, batch, torch.float64)
            ratio = cancellation(fr)
        k64, p64 = cs.grad_errs(kernel, ref), cs.grad_errs(plain, ref)
        top = sorted(k64, key=lambda n: max(k64[n], p64[n]), reverse=True)[:5]
        print(f"batch {i}: as it is, against float64: kernel worst {max(k64.values()):.3e} median "
              f"{statistics.median(k64.values()):.3e}; plain fp32 worst {max(p64.values()):.3e} median "
              f"{statistics.median(p64.values()):.3e}; attention switches flipped against float64: kernel "
              f"{flips(kr.masks, fr.masks)}, plain {flips(pr.masks, fr.masks)}; losses kernel {kl}, float64 {rl}",
              flush=True)
        print(f"batch {i}: five worst (kernel, plain, cancellation of a temperature): "
              + ", ".join(f"{n} ({k64[n]:.2e}, {p64[n]:.2e}" + (f", {ratio[n]:.1e})" if n in ratio else ")")
                          for n in top), flush=True)
        if ratio:
            worst_t = max(ratio, key=ratio.get)
            print(f"batch {i}: temperatures' cancellation: median {statistics.median(ratio.values()):.1e}, largest "
                  f"{ratio[worst_t]:.1e} ({worst_t})", flush=True)
        del kernel, plain, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
