"""A DCPT step's gradients against float64, each tensor held to how far fp32 rounding moves it.

The comparison of ``chip_smoke.py`` [7], [11] and [15]: one step's gradients of
``net_g`` and ``net_dc`` on a path in fp32 (the kernels, or the plain
versions) against the plain path in float64 on the same weights and batch.

A limit that is a fixed fraction of each tensor's max|ref| cannot hold every
tensor: where a gradient is a sum that cancels (Restormer's temperatures cancel
to 1/5.8e4 of their terms; a LayerNorm bias sums its cotangent over every
pixel) or hangs on a ReLU or max-pool switch near its edge, fp32 rounding moves
it by a large share of its size, on the plain path as on the kernels.  So each
tensor's limit scales with how far fp32 rounding moves that tensor, measured by
perturbation (the stochastic-rounding estimate of a computation's rounding
error):

1. the plain fp32 step runs once as it is and ``len(PERTURB_SEEDS)`` times
   with every parameter and every input image moved by one fp32 ulp in a
   seeded random direction (``torch.nextafter``); each rounding of the step
   then falls otherwise, and each switch within rounding distance of its edge
   may flip;
2. a tensor's sensitivity is the largest max-abs departure of those runs from
   the float64 gradient: the size of the fp32 step's rounding error on it,
   with the convolution algorithms cuDNN's timing picked for the step;
3. the fp32 path under test runs the same five ways; its error on a tensor is
   the median of its five runs' max-abs departures from float64, so a switch
   that flips in one run of the path and in none of the plain runs does not
   decide the check, while a fault of the path shows in every run;
4. that error must stay within ``max(FLOOR * max|ref|, K * sensitivity)`` on
   every tensor; the median over tensors of the error relative to max|ref|
   within ``MEDIAN``; each loss of the run as it is within
   ``max(LOSS_TOL, K * departure)`` (relative to max(1, |loss|)) of the
   float64 loss, its departure the largest of the plain fp32 runs'
   (``loss_departure``): on the card the plain Restormer step's own l_pix
   departs from float64 by up to 6.2e-5 (``PERF.md`` section 6), so a fixed
   1e-5 sits below fp32's own rounding there.

A first design moved the float64 step's inputs and parameters by fp32's unit
roundoff instead; on the card it read sensitivities of 4e-7 of max|ref| on the
probe's LayerNorm biases that both fp32 paths missed by 1e-3 (``PERF.md``
section 6): rounding inside a deep step, not at its inputs, moves them.  The
run as it is counts among the samples because the perturbed runs may get
other convolution algorithms from cuDNN's timing (its cache keys on the
buffers' alignment): PromptIR's ``prompt1.prompt_param``, a sum that cancels
to a small gradient, read 7.3e-2 of max|ref| on both fp32 paths as they ran
and 1e-6 on every perturbed run.  ``K`` allows the path under test to round
worse than the worst of the plain path's runs (another summation order, other
kernels, a switch that flips in its run and in none of the plain ones): on the
card PromptIR's kernel path read up to 11.3 times the plain runs' worst on a
tensor, its median error 3.3 times theirs, so K = 8 failed there and K = 32
leaves about three times that; and one run of its kernel path read a probe
LayerNorm weight 2.9e-3 of max|ref| off where all five plain runs were within
2.3e-6, a switch that flipped in that run alone, hence the median of step 3.  The check is loose where rounding is large
(the NAFNet and PromptIR steps' median sensitivity is 3e-3 to 8e-3 of
max|ref|); ``chip_smoke.py``'s comparison with the switches smoothed holds
the kernels to the plain path within 1e-3.  A planted 1 % error in a tensor
whose limit is below 1 % fails the check (``tests/test_torch_grad_check.py``).

``step_grads`` is the step that both sides run: the model's
``compute_gradients`` with both nets and the batch cast to a dtype;
``run_errors`` its five fp32 runs' errors against float64.
"""

from __future__ import annotations

import statistics

import torch

K = 32                      # the error allowed, in units of a tensor's rounding sensitivity
FLOOR = 1e-3                # of the tensor's max|ref|: what the sensitivity rule never goes below
MEDIAN = 2e-2               # of max|ref|, the median over tensors
LOSS_TOL = 1e-5             # of max(1, |loss|)
PERTURB_SEEDS = (1, 2, 3, 4)


def _perturb(t: torch.Tensor, seed: int) -> None:
    """Move every element of t by one ulp of its dtype, up or down as a +-1 tensor
    drawn from ``seed`` on t's device says, in place."""
    gen = torch.Generator(device=t.device).manual_seed(seed)
    up = torch.randint(0, 2, t.shape, generator=gen, device=t.device, dtype=torch.bool)
    t.copy_(torch.nextafter(t, torch.where(up, float("inf"), float("-inf")).to(t.dtype)))


def step_grads(model, batch: dict, dtype=None, perturb_seed: int | None = None):
    """One DCPT step's gradients of net_g and net_dc (float64, by name) and its
    losses, both nets and the batch in ``dtype`` (float32 when None).  With
    ``perturb_seed`` every parameter and every input image is moved by one ulp
    first (``_perturb``); the parameters are restored after, bit for bit.
    The step runs in full precision whatever the model's ``mixed_precision``."""
    dtype = dtype or torch.float32
    nets = {"net_g": model.net_g, "net_dc": model.net_dc}
    mixed = getattr(model, "mixed_precision", False)
    model.mixed_precision = False
    saved = {}
    try:
        for k, net in nets.items():
            net.to(dtype)
            if perturb_seed is not None:
                with torch.no_grad():
                    for i, (n, p) in enumerate(net.named_parameters()):
                        saved[f"{k}.{n}"] = p.detach().clone()
                        _perturb(p.data, perturb_seed * 100003 + i)
        data = {k: v.to(dtype) if v.is_floating_point() else v for k, v in batch.items()}
        if perturb_seed is not None:
            for i, key in enumerate(k for k in ("lq", "gt") if k in data):
                _perturb(data[key], perturb_seed * 100003 + 99991 + i)
        model.feed_data(data)
        losses = {k: v.item() for k, v in model.compute_gradients().items()}
        # the parameters that no loss reaches (a probe level without a tap) keep no gradient
        grads = {f"{k}.{n}": p.grad.double() for k, net in nets.items() for n, p in net.named_parameters()
                 if p.grad is not None}
    finally:
        with torch.no_grad():
            for k, net in nets.items():
                for n, p in net.named_parameters():
                    if f"{k}.{n}" in saved:
                        p.copy_(saved[f"{k}.{n}"])
                net.float()
        model.mixed_precision = mixed
    return grads, losses


def run_errors(model, batch: dict, ref: dict, seeds=PERTURB_SEEDS,
               runs_losses: list | None = None) -> tuple[list[dict], dict]:
    """The fp32 step as it is and on parameters and inputs moved by one ulp
    (``_perturb``) for each of ``seeds``: each run's max-abs error against the
    float64 gradients ``ref``, by tensor (the run as it is first), and the
    losses of the run as it is; every run's losses appended to ``runs_losses``
    when given."""
    errs, losses = [], None
    for seed in (None, *seeds):
        grads, run_losses = step_grads(model, batch, torch.float32, perturb_seed=seed)
        errs.append({n: (grads[n] - g).abs().max().item() for n, g in ref.items()})
        losses = losses or run_losses
        if runs_losses is not None:
            runs_losses.append(run_losses)
        del grads
    return errs, losses


def loss_departure(runs_losses: list[dict], ref_losses: dict) -> dict:
    """Each loss's largest departure over runs from its float64 value, relative to
    max(1, |loss|) as ``compare`` holds it to ``LOSS_TOL``."""
    return {k: max(abs(run[k] - v) / max(1.0, abs(v)) for run in runs_losses) for k, v in ref_losses.items()}


def rounding_sensitivity(plain_errs: list[dict]) -> dict:
    """Each tensor's rounding sensitivity: the largest error of the plain path's runs."""
    return {n: max(e[n] for e in plain_errs) for n in plain_errs[0]}


def path_error(errs: list[dict]) -> dict:
    """Each tensor's error on the path under test: the median of its runs' errors."""
    return {n: statistics.median(e[n] for e in errs) for n in errs[0]}


def median_rel(err: dict, ref: dict) -> float:
    """The median over tensors of a path's error (``path_error``) relative to each tensor's max|ref|,
    the statistic ``compare`` holds to ``MEDIAN``."""
    return statistics.median(err[n] / s if (s := g.abs().max().item()) > 0 else err[n] for n, g in ref.items())


def compare(err: dict, got_losses: dict, ref: dict, ref_losses: dict, sens: dict, k: float = K,
            plain_loss: dict | None = None) -> dict:
    """The check of an fp32 path (``err``, its errors by tensor from
    ``path_error``, and its losses) against the float64 ``ref``; returns a report: ``ok``, the worst tensor by its error over
    its limit (``worst``, ``worst_ratio``, ``worst_rel`` of its max|ref|,
    ``worst_sens`` of its max|ref|), the median error of max|ref| (``median``),
    the tensors over 1e-3 of max|ref| (``over_1e3``), the count held by the
    sensitivity rule rather than the floor (``by_sensitivity``), the worst
    loss error (``loss_err``) and the largest of a loss's error over its limit
    (``loss_ratio``; the limit ``max(LOSS_TOL, k * plain_loss[loss])``, or
    ``LOSS_TOL`` without ``plain_loss``)."""
    ratio, rel, srel = {}, {}, {}
    by_sens = 0
    for n, g in ref.items():
        scale = g.abs().max().item()
        limit = max(FLOOR * scale, k * sens[n])
        by_sens += k * sens[n] > FLOOR * scale
        ratio[n] = err[n] / limit if limit > 0 else (0.0 if err[n] == 0 else float("inf"))
        rel[n] = err[n] / scale if scale > 0 else err[n]
        srel[n] = sens[n] / scale if scale > 0 else sens[n]
    worst = max(ratio, key=ratio.get)
    median = median_rel(err, ref)
    loss_errs = {key: abs(got_losses[key] - v) / max(1.0, abs(v)) for key, v in ref_losses.items()}
    loss_limits = {key: max(LOSS_TOL, k * plain_loss[key]) if plain_loss else LOSS_TOL for key in ref_losses}
    loss_ratio = max(loss_errs[key] / loss_limits[key] for key in ref_losses)
    return {"ok": ratio[worst] <= 1 and median <= MEDIAN and loss_ratio <= 1, "worst": worst,
            "worst_ratio": ratio[worst], "worst_rel": rel[worst], "worst_sens": srel[worst], "median": median,
            "over_1e3": sum(v > 1e-3 for v in rel.values()), "by_sensitivity": by_sens, "tensors": len(ref),
            "loss_err": max(loss_errs.values()), "loss_limit": min(loss_limits.values()), "loss_ratio": loss_ratio,
            "max_rel": max(rel.values())}


def describe(report: dict) -> str:
    """One line of a ``compare`` report."""
    return (f"worst {report['worst_rel']:.3e} of max|ref| ({report['worst']}, sensitivity "
            f"{report['worst_sens']:.3e} of max|ref|), {report['worst_ratio']:.3f} of its limit; median "
            f"{report['median']:.3e} (limit {MEDIAN:.0e}); largest {report['max_rel']:.3e}; {report['over_1e3']} of "
            f"{report['tensors']} above 1e-3; {report['by_sensitivity']} limits set by the sensitivity; loss error "
            f"{report['loss_err']:.3e}, {report['loss_ratio']:.3f} of its limit (the tightest {report['loss_limit']:.3e})")
