"""The Restormer DCPT pre-training step of the PyTorch port against dcpt_tpu's, on the CPU.

A width-8 Restormer (blocks [1, 1, 1, 1], one refinement block) tapped at its
decoder levels, as ``train_Restormer_dcpt_5d.yml`` taps it, feeds a
PromptIR_NoImg_DC probe of the yml's shape (feature_dims [16, 16, 32, 64]
against its [96, 96, 192, 384], no downsampling): three taps, so the probe's
fourth level sees none.  On the CPU every TransformerBlock runs through the
port's autograd Function with K7's plain version as its backward, so three
steps check that decomposition inside the whole step.

The attention runs as the softmax (``use_softmax``, an option of both
frameworks' Restormer), not the shipped ReLU: fp32 rounding flips a ReLU
logit near zero in one framework and not the other, and the step's gradients
then part by about 1e-3 of their max (seed 1, ``patch_embed``, with the
probe smoothed).  The ReLU flavour's backward is held against dcpt_tpu's
kernel and ``jax.vjp`` in ``test_torch_mdta_block_bwd.py``, and inside the
shipped yml's step on the card (``chip_smoke.py`` [11]).
"""

import _torch_threads  # noqa: F401
from test_torch_dcpt import three_transformer_steps

NETWORK_G = {"type": "Restormer", "dim": 8, "num_blocks": [1, 1, 1, 1], "num_refinement_blocks": 1,
             "window_size": 8, "use_softmax": True, "h": 32}
NETWORK_DC = {"type": "PromptIR_NoImg_DC", "feature_dims": [16, 16, 32, 64], "num_res_blocks": 1, "num_classes": 5,
              "downsample": False}


def test_three_steps_match_dcpt_tpu(tmp_path):
    three_transformer_steps(tmp_path, NETWORK_G, NETWORK_DC, "decoder_level", n_taps=3)

