"""LR schedules as pure ``step -> lr`` functions (dcpt_tpu/models/lr_scheduler.py).

The model sets every optimizer's ``param_group["lr"]`` from them each
iteration, as dcpt_tpu's ``update_learning_rate`` does on the host.  Closed
forms of the reference's stateful torch schedulers
(``basicsr/models/lr_scheduler.py:7-131``):

* ``MultiStepRestartLR`` — multiplicative gamma decay at milestones, weight
  resets at restart iterations;
* ``CosineAnnealingRestartLR`` — per-period cosine from ``weight*base`` down to
  ``eta_min`` (list-capable), restarting each period;
* linear warmup wrapper (``base_model.py:223-244``).
"""

from __future__ import annotations

import bisect
import math
from typing import Callable, Sequence


def multi_step_restart_lr(
    base_lr: float,
    milestones: Sequence[int],
    gamma: float = 0.1,
    restarts: Sequence[int] = (0,),
    restart_weights: Sequence[float] = (1,),
) -> Callable[[int], float]:
    assert len(restarts) == len(restart_weights), "restarts and their weights do not match."
    milestones = sorted(milestones)
    restarts_sorted = sorted(zip(restarts, restart_weights))

    def schedule(step: int) -> float:
        # find the last restart at or before `step`
        weight, restart_at = 1.0, 0
        for r, w in restarts_sorted:
            if step >= r:
                weight, restart_at = w, r
        # count milestones hit in (restart_at, step]
        n = bisect.bisect_right(milestones, step) - bisect.bisect_right(milestones, restart_at)
        return base_lr * weight * (gamma**n)

    return schedule


def cosine_annealing_restart_lr(
    base_lr: float,
    periods: Sequence[int],
    restart_weights: Sequence[float] = (1,),
    eta_min=0.0,
) -> Callable[[int], float]:
    assert len(periods) == len(restart_weights), "periods and restart_weights should have the same length."
    cumulative = [sum(periods[: i + 1]) for i in range(len(periods))]
    eta_mins = list(eta_min) if isinstance(eta_min, (list, tuple)) else [eta_min] * len(periods)
    if len(eta_mins) == 1:
        eta_mins = eta_mins * len(periods)

    def schedule(step: int) -> float:
        idx = next((i for i, p in enumerate(cumulative) if step <= p), len(cumulative) - 1)
        weight = restart_weights[idx]
        nearest_restart = 0 if idx == 0 else cumulative[idx - 1]
        period = periods[idx]
        em = eta_mins[min(idx, len(eta_mins) - 1)]
        return em + weight * 0.5 * (base_lr - em) * (1 + math.cos(math.pi * ((step - nearest_restart) / period)))

    return schedule


def with_linear_warmup(schedule: Callable[[int], float], warmup_iter: int, base_lr: float) -> Callable[[int], float]:
    """Linear warm-up over the first ``warmup_iter`` steps (base_model.py:223-244)."""
    if warmup_iter <= 0:
        return schedule

    def warmed(step: int) -> float:
        if step < warmup_iter:
            return base_lr / warmup_iter * step
        return schedule(step)

    return warmed


def build_schedule(scheduler_opt: dict, base_lr: float, warmup_iter: int = -1) -> Callable[[int], float]:
    """Build a schedule from the yml dict (reference: base_model.py:141-160)."""
    opt = dict(scheduler_opt)
    scheduler_type = opt.pop("type")
    if scheduler_type in ["MultiStepLR", "MultiStepRestartLR"]:
        sched = multi_step_restart_lr(base_lr, **opt)
    elif scheduler_type == "CosineAnnealingRestartLR":
        sched = cosine_annealing_restart_lr(base_lr, **opt)
    elif scheduler_type in ("none", "constant", None):
        sched = lambda step: base_lr  # noqa: E731
    else:
        raise NotImplementedError(f"Scheduler {scheduler_type} is not implemented yet.")
    return with_linear_warmup(sched, warmup_iter, base_lr)
