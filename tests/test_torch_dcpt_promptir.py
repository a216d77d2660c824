"""The PromptIR DCPT pre-training step of the PyTorch port against dcpt_tpu's, on the CPU.

A width-8 PromptIR (blocks [1, 2, 1, 1], one refinement block; its prompts
keep their 64/128/320 widths) tapped per block at ``decoder_level2``, as
``train_PromptIR_dcpt_5d.yml`` taps it, feeds a PromptIR_NoImg_DC probe of the
yml's shape (two 16-wide levels against its six 96-wide ones, downsampling
each level by 1 / 2^i).  The skip-tail pass stops after ``noise_level1``,
whose output reaches no loss.  On the CPU every PromptTransformerBlock runs
through the port's autograd Function with K7's plain version as its backward,
so three steps check that decomposition inside the whole step.  The shipped
yml runs through ``train_pipeline`` at full width on the card
(``chip_smoke.py`` [11]).
"""

import _torch_threads  # noqa: F401
from test_torch_dcpt import three_transformer_steps

NETWORK_G = {"type": "PromptIR", "dim": 8, "num_blocks": [1, 2, 1, 1], "num_refinement_blocks": 1,
             "window_size": 8, "h": 32}
NETWORK_DC = {"type": "PromptIR_NoImg_DC", "feature_dims": [16, 16], "num_res_blocks": 1, "num_classes": 5,
              "downsample": True}


def test_three_steps_match_dcpt_tpu(tmp_path):
    three_transformer_steps(tmp_path, NETWORK_G, NETWORK_DC, "decoder_level2", n_taps=2)

