"""The mixed-precision SwinIR DCPT step of the PyTorch port against dcpt_tpu's, on the CPU.

The tiny SwinIR and its probe of ``test_torch_dcpt_swinir.py`` (window 8 on
32 x 32 crops, every second block shifted by 4) take three mixed steps from
the same weights on the same batches as dcpt_tpu's mixed step, held to twice
dcpt_tpu's own fp32-to-bf16 spread
(``test_torch_dcpt_mixed.py::three_mixed_steps``).  On the CPU every
SwinTransformerBlock runs through ``SwinBlockFunction`` in bf16, with K9's
plain version (fp32 math on the bf16 inputs) as its backward; the shipped
yml's step runs on the card (``chip_smoke.py`` [21]).
"""

from test_torch_dcpt_mixed import three_mixed_steps
from test_torch_dcpt_swinir import NETWORK_DC, NETWORK_G


def test_three_mixed_steps_match_dcpt_tpu(tmp_path):
    three_mixed_steps(tmp_path, NETWORK_G, NETWORK_DC, "encode_layers", n_taps=1)
