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
gradient, and AdamW leaves it as it is.  dcpt_tpu's
``mixed_precision``, ``batched_trunk``, ``accumulate_steps`` and
``zero_sharding`` are not ported yet and raise.
"""

from __future__ import annotations

from ..losses import build_loss
from ..utils.registry import MODEL_REGISTRY
from .dc_util import select_taps
from .degradation_classification_model import DCModel


@MODEL_REGISTRY.register()
class DCPTModel(DCModel):
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
        losses = {}
        total = 0.0
        if self.cri_pixel is not None:
            output, _ = self.net_g(self.gt if self._pixel_input == "gt" else self.lq)
            losses["l_pix"] = self.cri_pixel(output.float(), self.gt)
            total = total + losses["l_pix"]
        _, taps = self.net_g(self.lq, skip_tail=True)
        logits = self.net_dc(self.lq, select_taps(taps, self.hook_names)[::-1])
        losses["l_classify"] = self.cri_classify(logits.float(), self.dataset_idx)
        (total + losses["l_classify"]).backward()
        return losses

    def optimize_parameters(self, current_iter: int) -> None:
        losses = self.compute_gradients()
        self.clip_gradients()
        for optimizer in self.optimizers:
            optimizer.step()
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
