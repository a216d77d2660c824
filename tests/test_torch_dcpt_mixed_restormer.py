"""The mixed-precision Restormer DCPT step of the PyTorch port against dcpt_tpu's, on the CPU.

The width-8 Restormer and its probe of ``test_torch_dcpt_restormer.py``
(softmax attention, for the reason given there: a ReLU logit near zero flips
in one framework and not the other, and in bf16 the logits are about 1e-2
apart) take three mixed steps from the same weights on the same batches as
dcpt_tpu's mixed step, held to twice dcpt_tpu's own fp32-to-bf16 spread
(``test_torch_dcpt_mixed.py::three_mixed_steps``).  On the CPU every
TransformerBlock runs through the port's autograd Function in bf16, with K7's
plain version (fp32 math on the bf16 inputs) as its backward; the shipped
yml's step runs on the card (``chip_smoke.py`` [21]).
"""

import _torch_threads  # noqa: F401
from test_torch_dcpt_mixed import three_mixed_steps
from test_torch_dcpt_restormer import NETWORK_DC, NETWORK_G


def test_three_mixed_steps_match_dcpt_tpu(tmp_path):
    three_mixed_steps(tmp_path, NETWORK_G, NETWORK_DC, "decoder_level", n_taps=3)
