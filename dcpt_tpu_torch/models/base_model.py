"""BaseModel (dcpt_tpu/models/base_model.py): device, loading, validation
bookkeeping, and the training half: optimizers, schedules, EMA, loss logging
and checkpoints.

Optimizers make the update dcpt_tpu's optax chains make (``get_optimizer``):
``torch.optim``'s where it has the same one, and the two small classes below
where it has not; the schedules are ``step -> lr`` functions and
``update_learning_rate`` writes each optimizer's ``param_group["lr"]`` every
iteration, as dcpt_tpu multiplies its update by the host-scheduled lr.
Networks are saved as ``{param_key: state_dict}`` ``.pth`` files (the
reference's format) and training states with ``torch.save``, the newest
``logger.keep_checkpoints`` of them kept; dcpt_tpu's npz and orbax files do not
load here.
"""

from __future__ import annotations

import os
import os.path as osp
from collections import OrderedDict
from copy import deepcopy

import torch

from ..utils.logger import get_root_logger
from .lr_scheduler import build_schedule


class OptaxRMSprop(torch.optim.Optimizer):
    """dcpt_tpu's RMSprop, ``optax.scale_by_rms(alpha, eps)`` times -lr:
    nu = alpha nu + (1 - alpha) g^2, p -= lr g / sqrt(nu + eps).  The eps sits
    inside the root (``torch.optim.RMSprop`` adds it outside)."""

    def __init__(self, params, lr: float, alpha: float = 0.99, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, alpha=alpha, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in (p for p in group["params"] if p.grad is not None):
                state = self.state[p]
                if not state:
                    state["step"], state["nu"] = torch.tensor(0.0), torch.zeros_like(p)
                state["step"] += 1
                nu = state["nu"].mul_(group["alpha"]).addcmul_(p.grad, p.grad, value=1 - group["alpha"])
                p.addcdiv_(p.grad, (nu + group["eps"]).sqrt(), value=-group["lr"])


class OptaxRprop(torch.optim.Optimizer):
    """dcpt_tpu's Rprop, ``optax.scale_by_rprop(learning_rate=1.0)`` (optax
    0.2.6) times -lr.  Each element keeps a step size that starts at 1 and has
    no unit (the lr scales it, so its bounds [1e-6, 50] are not the lr's, as
    ``torch.optim.Rprop``'s are): x 1.2 where g keeps its sign, x 0.5 where it
    flips.  As optax computes it, a step applies the previous step's
    sign(g) * step size, and nothing where the sign flipped: the first step
    moves nothing."""

    def __init__(self, params, lr: float):
        super().__init__(params, dict(lr=lr))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in (p for p in group["params"] if p.grad is not None):
                state = self.state[p]
                if not state:
                    state["step"], state["size"], state["prev"] = (torch.tensor(0.0), torch.ones_like(p),
                                                                   torch.zeros_like(p))
                state["step"] += 1
                s = p.grad * state["prev"]
                size = torch.where(s == 0, state["size"],
                                   (state["size"] * torch.where(s > 0, 1.2, 0.5)).clamp(1e-6, 50.0))
                flipped = s < 0
                update = torch.where(flipped, 0.0, state["prev"])
                state["size"], state["prev"] = size, torch.where(flipped, 0.0, size * p.grad.sign())
                p.sub_(update, alpha=group["lr"])


class BaseModel:
    def __init__(self, opt: dict):
        self.opt = opt
        self.is_train = opt.get("is_train", False)
        # num_gpu 0 is the CPU; parse_options has already refused CUDA requests without a device
        self.device = torch.device("cuda" if opt["num_gpu"] != 0 else "cpu")
        self.optimizers: list[torch.optim.Optimizer] = []
        self.schedulers: list = []
        self.log_dict: OrderedDict = OrderedDict()
        self._current_lrs: list[float] = []

    # -- optimizers and schedules ------------------------------------------

    def get_optimizer(self, optim_type: str, params, lr: float, **kwargs) -> torch.optim.Optimizer:
        """The optimizer zoo (reference: base_model.py:120-139), each the update of
        dcpt_tpu's optax chain: ``Adam`` adds the weight decay to the gradient
        (``add_decayed_weights`` before ``scale_by_adam``); ``AdamW`` decays the
        weights apart from the Adam step, 1e-2 when no decay is given
        (``chain(scale_by_adam, add_decayed_weights(wd)) x (-lr)``); ``SGD``'s
        momentum is optax's ``trace`` (no dampening); ``ASGD`` is plain SGD
        (``optax.identity``: no momentum, no decay); ``RMSprop`` and ``Rprop``
        are ``OptaxRMSprop`` and ``OptaxRprop``."""
        betas = tuple(kwargs.pop("betas", (0.9, 0.999)))
        wd = kwargs.pop("weight_decay", 0.0)
        if optim_type == "Adam":
            return torch.optim.Adam(params, lr=lr, betas=betas, eps=kwargs.get("eps", 1e-8), weight_decay=wd)
        if optim_type == "AdamW":
            return torch.optim.AdamW(params, lr=lr, betas=betas, eps=kwargs.get("eps", 1e-8),
                                     weight_decay=wd if wd else 1e-2)
        if optim_type == "Adamax":
            return torch.optim.Adamax(params, lr=lr, betas=betas, eps=kwargs.get("eps", 1e-8))
        if optim_type == "SGD":
            return torch.optim.SGD(params, lr=lr, momentum=kwargs.get("momentum", 0.0), weight_decay=wd)
        if optim_type == "ASGD":
            get_root_logger().warning("ASGD has no optax equivalent in dcpt_tpu; running plain SGD "
                                      "(no momentum, no weight decay).")
            return torch.optim.SGD(params, lr=lr)
        if optim_type == "RMSprop":
            return OptaxRMSprop(params, lr=lr, alpha=kwargs.get("alpha", 0.99), eps=kwargs.get("eps", 1e-8))
        if optim_type == "Rprop":
            return OptaxRprop(params, lr=lr)
        raise NotImplementedError(f"optimizer {optim_type} is not supported yet.")

    def _check_train_options(self) -> None:
        """Options of dcpt_tpu's training that the port does not have yet raise
        (``mixed_precision`` is the model's own to check: ``DCPTModel``)."""
        train_opt = self.opt.get("train") or {}
        for key in ("batched_trunk", "zero_sharding"):
            if train_opt.get(key):
                raise NotImplementedError(f"train.{key} is not ported to dcpt_tpu_torch yet (ROADMAP Q1)")
        if int(train_opt.get("accumulate_steps", 1) or 1) > 1:
            raise NotImplementedError("train.accumulate_steps is not ported to dcpt_tpu_torch yet (ROADMAP Q1)")

    def setup_schedulers(self) -> None:
        """One schedule per optimizer, warm-up folded in (reference: base_model.py:141-160)."""
        train_opt = self.opt["train"]
        warmup = train_opt.get("warmup_iter", -1)
        self.schedulers = [build_schedule(deepcopy(train_opt["scheduler"]), group["lr"], warmup)
                           for optimizer in self.optimizers for group in optimizer.param_groups[:1]]
        self.update_learning_rate(0)

    def update_learning_rate(self, current_iter: int) -> None:
        """Set every optimizer's lr for this iteration (reference: base_model.py:223-244);
        the warm-up is already part of the schedules."""
        self._current_lrs = [sched(current_iter) for sched in self.schedulers]
        for optimizer, lr in zip(self.optimizers, self._current_lrs):
            for group in optimizer.param_groups:
                group["lr"] = lr

    def get_current_learning_rate(self) -> list[float]:
        return list(self._current_lrs)

    def clip_gradients(self) -> None:
        """``train.grad_clip``: clip each optimizer's gradients by their own global
        norm, as dcpt_tpu chains ``clip_by_global_norm`` into each optimizer's
        transform (``base_model.py:110-112``): net_g's norm never scales net_dc's."""
        grad_clip = self.opt.get("grad_clip", 0) or (self.opt.get("train") or {}).get("grad_clip", 0)
        if grad_clip:
            for optimizer in self.optimizers:
                torch.nn.utils.clip_grad_norm_([p for g in optimizer.param_groups for p in g["params"]],
                                               float(grad_clip))

    @staticmethod
    @torch.no_grad()
    def ema_update(ema_net: torch.nn.Module, net: torch.nn.Module, decay: float) -> None:
        """ema = ema * decay + params * (1 - decay) (reference: base_model.py:86-95)."""
        for e, p in zip(ema_net.parameters(), net.parameters()):
            e.mul_(decay).add_(p, alpha=1 - decay)

    @staticmethod
    def reduce_loss_dict(loss_dict: dict) -> OrderedDict:
        """Losses as floats for logging (reference: base_model.py:432-457), one process."""
        return OrderedDict((k, float(v)) for k, v in loss_dict.items())

    def get_current_log(self) -> OrderedDict:
        return self.log_dict

    # -- validation bookkeeping -------------------------------------------------

    def validation(self, dataloader, current_iter, tb_logger, save_img=False):
        self.nondist_validation(dataloader, current_iter, tb_logger, save_img)

    def _initialize_best_metric_results(self, dataset_name: str) -> None:
        """Track the best value of each metric per dataset (reference: base_model.py:58-76)."""
        if hasattr(self, "best_metric_results") and dataset_name in self.best_metric_results:
            return
        if not hasattr(self, "best_metric_results"):
            self.best_metric_results = {}
        record = {}
        for metric, content in self.opt["val"]["metrics"].items():
            better = content.get("better", "higher")
            record[metric] = dict(better=better, val=float("-inf") if better == "higher" else float("inf"), iter=-1)
        self.best_metric_results[dataset_name] = record

    def _update_best_metric_result(self, dataset_name, metric, val, current_iter) -> None:
        rec = self.best_metric_results[dataset_name][metric]
        if (rec["better"] == "higher" and val >= rec["val"]) or (rec["better"] == "lower" and val <= rec["val"]):
            rec["val"] = val
            rec["iter"] = current_iter

    # -- checkpoints ---------------------------------------------------------------

    def load_network(self, net: torch.nn.Module, load_path: str, strict: bool = True, param_key: str | None = "params") -> None:
        """Load a reference ``.pth`` (``{param_key: state_dict}``) into ``net``,
        falling back from a missing ``params_ema`` to ``params`` and dropping a
        DDP ``module.`` prefix (reference: base_model.py:300-369)."""
        logger = get_root_logger()
        load_net = torch.load(load_path, map_location="cpu", weights_only=True)
        if param_key is not None:
            if param_key not in load_net and "params" in load_net:
                param_key = "params"
                logger.info("Loading: params_ema does not exist, use params.")
            load_net = load_net[param_key]
        logger.info(f"Loading {net.__class__.__name__} model from {load_path}, with param key: [{param_key}].")
        load_net = {(k[len("module."):] if k.startswith("module.") else k): v for k, v in load_net.items()}
        net.load_state_dict(load_net, strict=strict)

    def save_network(self, nets: dict[str, torch.nn.Module], net_label: str, current_iter) -> None:
        """``{param_key: state_dict}`` to ``models/net_<label>_<iter>.pth`` (reference:
        base_model.py:249-298); ``current_iter`` -1 saves as ``latest``."""
        if current_iter == -1:
            current_iter = "latest"
        path = osp.join(self.opt["path"]["models"], f"{net_label}_{current_iter}.pth")
        torch.save({key: {k: v.detach().cpu() for k, v in net.state_dict().items()} for key, net in nets.items()},
                   path)

    def save_training_state(self, epoch: int, current_iter: int) -> None:
        """Epoch, iteration and every optimizer's state to ``training_states/<iter>.state``
        (reference: base_model.py:371-411); nothing for ``current_iter`` -1.  With
        ``logger.keep_checkpoints`` N, only the newest N states stay (dcpt_tpu's
        ``base_model.py:336-354``); the save has finished before any is removed."""
        if current_iter == -1:
            return
        state = {"epoch": epoch, "iter": current_iter, "optimizers": [o.state_dict() for o in self.optimizers]}
        root = self.opt["path"]["training_states"]
        os.makedirs(root, exist_ok=True)
        torch.save(state, osp.join(root, f"{current_iter}.state"))  # written when it returns
        keep = (self.opt.get("logger") or {}).get("keep_checkpoints")
        if keep:
            states = sorted((f for f in os.listdir(root) if f.endswith(".state")), key=lambda f: int(f[:-6]))
            for old in states[:-int(keep)]:
                os.remove(osp.join(root, old))

    def resume_training(self, resume_state: dict) -> None:
        """Restore the optimizers' states (reference: base_model.py:413-430)."""
        saved = resume_state["optimizers"]
        if len(saved) != len(self.optimizers):
            raise ValueError(f"training state has {len(saved)} optimizers, the model has {len(self.optimizers)}")
        for optimizer, state in zip(self.optimizers, saved):
            optimizer.load_state_dict(state)

    def print_network(self, net: torch.nn.Module) -> None:
        n_params = sum(p.numel() for p in net.parameters())
        get_root_logger().info(f"Network: {net.__class__.__name__}, with parameters: {n_params:,d}")
