"""DCPTModel and DCTModel (dcpt_tpu/models/degradation_classification_pretrain_model.py).

The DCPT pre-training step (reference
``basicsr/models/degradation_classification_pretrain_model.py:133-169``):

1. a full forward of the restoration net on the clean ``gt`` (DCPT) or on the
   degraded ``lq`` (DCT) -> the pixel loss against ``gt``;
2. a feature-only (skip-tail) forward on ``lq``; the taps named by
   ``hook_names``, reversed, go to the classifier -> the classification loss
   on ``dataset_idx``;
3. one backward of the sum of both losses (the taps are not detached, so the
   classifier's gradients reach the restoration net), then both optimizers step.

On the card every NAFBlock's forward is kernel K1 and its backward K2, every
Restormer / PromptIR TransformerBlock's forward K6 and its backward K7, and the
classifier's LayerNorms of 512 channels and more are K3.  A probe level that
no tap reaches (Restormer's yml gives its four levels three taps) gets no
gradient, and AdamW leaves it as it is.

``train.mixed_precision`` is dcpt_tpu's recipe (its
``degradation_classification_pretrain_model.py:89-92``), not autocast: both
nets run on bf16 copies of their fp32 parameters (``p.to(torch.bfloat16)``
through ``torch.func.functional_call``, so the gradients flow back through the
cast into the fp32 masters), on bf16 ``lq`` and ``gt``; the pixel loss is taken
on ``output.float()`` against the fp32 ``gt`` and the cross-entropy on
``logits.float()``; the clip, the optimizers, the schedules and the checkpoints
stay on the fp32 masters (``base_model.py::bf16_call``).  On the card the blocks run their kernels in bf16,
each keeping fp32 residuals and doing fp32 math: the NAFBlocks K1 and K2, the
Restormer / PromptIR TransformerBlocks K6 and K7, the SwinIR Swin blocks K8
and K9; the classifier's wide LayerNorms are K3 in bf16.
``train.accumulate_steps`` steps both optimizers once in k iterations on the
mean gradient (``BaseModel.step_optimizers``); dcpt_tpu's ``batched_trunk``
and ``zero_sharding`` are not ported yet and raise.
"""

from __future__ import annotations

import torch

from ..losses import build_loss
from ..utils.registry import MODEL_REGISTRY
from .base_model import bf16_call
from .dc_util import select_taps
from .degradation_classification_model import DCModel


@MODEL_REGISTRY.register()
class DCPTModel(DCModel):
    FROZEN_NETWORKS = ()  # DCPT trains and saves both nets
    # what the pixel-loss forward consumes: the clean gt for DCPT (...pretrain:140)
    _pixel_input = "gt"

    def init_training_settings(self) -> None:
        self._check_train_options()
        train_opt = self.opt["train"]
        self.net_g.train()
        self.net_dc.train()
        self.cri_pixel = build_loss(train_opt["pixel_opt"]) if train_opt.get("pixel_opt") else None
        self.cri_classify = build_loss(train_opt["classify_opt"]) if train_opt.get("classify_opt") else None
        if self.cri_classify is None:
            raise ValueError("Classify loss is None.")
        self.setup_optimizers()
        self.setup_schedulers()

    def setup_optimizers(self) -> None:
        train_opt = self.opt["train"]
        optims = []
        for key, net in (("optim_g", self.net_g), ("optim_dc", self.net_dc)):
            optim_opt = dict(train_opt[key])
            optim_type = optim_opt.pop("type")
            optims.append(self.get_optimizer(optim_type, net.parameters(), **optim_opt))
        self.optimizer_g, self.optimizer_dc = optims
        self.optimizers = optims

    def compute_gradients(self) -> dict:
        """Both forwards, the two losses and one backward of their sum into every
        parameter's ``.grad``; returns the losses."""
        for optimizer in self.optimizers:
            optimizer.zero_grad(set_to_none=True)
        net_g, net_dc, lq, gt = self._step_nets()
        losses = {}
        total = 0.0
        if self.cri_pixel is not None:
            output, _ = net_g(gt if self._pixel_input == "gt" else lq)
            losses["l_pix"] = self.cri_pixel(output.float(), self.gt)
            total = total + losses["l_pix"]
        _, taps = net_g(lq, skip_tail=True)
        logits = net_dc(lq, select_taps(taps, self.hook_names)[::-1])
        losses["l_classify"] = self.cri_classify(logits.float(), self.dataset_idx)
        (total + losses["l_classify"]).backward()
        return losses

    def _step_nets(self):
        """(net_g, net_dc, lq, gt) as the step calls them: the modules and the
        batch as they are, or under mixed precision the modules on bf16 copies
        of their fp32 parameters and the batch in bf16."""
        if not self.mixed_precision:
            return self.net_g, self.net_dc, self.lq, self.gt
        gt = self.gt.to(torch.bfloat16) if self.gt is not None else None
        return bf16_call(self.net_g), bf16_call(self.net_dc), self.lq.to(torch.bfloat16), gt

    def optimize_parameters(self, current_iter: int) -> None:
        losses = self.compute_gradients()
        self.step_optimizers()
        self.log_dict = self.reduce_loss_dict({k: v.detach() for k, v in losses.items()})

    def save(self, epoch: int, current_iter: int) -> None:
        """Both networks and both optimizers (reference: ...pretrain_model.py:171-174)."""
        self.save_network({"params": self.net_g}, "net_g", current_iter)
        self.save_network({"params": self.net_dc}, "net_dc", current_iter)
        self.save_training_state(epoch, current_iter)


@MODEL_REGISTRY.register()
class DCTModel(DCPTModel):
    """Direct-train ablation: the pixel forward consumes the degraded image
    (reference: ...direct_train_model.py:133-170)."""

    _pixel_input = "lq"
