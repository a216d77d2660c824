"""Kernel K6's wrapper in the PyTorch port (dcpt_tpu_torch/ops/mdta_block.py) on
the CPU: it runs the plain version and launches nothing, refuses a device
without a kernel, checks what the CUDA path would refuse before any launch,
and lays the parameters out as PyTorch's modules hold them.  Its numbers
against dcpt_tpu are in tests/test_torch_mdta_block.py.
"""

import numpy as np
import pytest
import torch

from test_torch_mdta_block import HEADS, _torch, block_inputs

from dcpt_tpu_torch.ops import mdta_block as tmb


def test_cpu_wrapper_runs_the_plain_version_and_launches_nothing():
    x, params = block_inputs(2, 4, 6, seed=1)
    xt, pt = torch.from_numpy(x), _torch(params)
    with torch.no_grad():
        z = tmb.mdta_block_fused(xt, *pt, HEADS, True, True, 1e-5)
    assert tmb.mdta_block_fused.launches == 0
    assert torch.equal(z, tmb.mdta_block_ref(xt, *pt, HEADS, True, True, 1e-5))


def test_wrapper_raises_on_a_device_without_a_kernel():
    x, params = block_inputs(1, 4, 4)
    with pytest.raises(ValueError, match="no kernel"):
        tmb.mdta_block_fused(torch.from_numpy(x).to("meta"), *[p.to("meta") for p in _torch(params)], HEADS, False,
                             False)


@pytest.mark.parametrize("case", ["noncontiguous", "empty", "dtype", "heads", "weight_shape", "temperature",
                                  "weight_dtype"])
def test_kernel_input_checks_raise(case):
    """What the CUDA path refuses, checked before any launch."""
    x, params = block_inputs(1, 4, 6)
    xt, pt, heads = torch.from_numpy(x), _torch(params), HEADS
    if case == "noncontiguous":
        xt = xt.transpose(1, 2)
    elif case == "empty":
        xt = xt[:, :0]
    elif case == "dtype":
        xt, pt = xt.double(), [p.double() for p in pt]
    elif case == "heads":
        heads = 5
    elif case == "weight_shape":
        pt[8] = pt[8][:, :-2]
    elif case == "temperature":
        pt[4] = pt[4].reshape(HEADS)
    else:
        pt[5] = pt[5].bfloat16()
    with pytest.raises((ValueError, TypeError)):
        tmb._check(xt, pt, heads)
    tmb._check(torch.from_numpy(x), _torch(params), HEADS)  # the unmodified inputs pass


def test_torch_layout_is_the_kernels_layout():
    """1x1 weights (in, out) -> (out, in), depthwise (3, 3, D) -> (D, 3, 3), temperature -> (heads,)."""
    _, params = block_inputs(1, 2, 2)
    laid = tmb.torch_layout(_torch(params))
    assert [tuple(t.shape) for t in laid] == [(12,), (12,), (36, 12), (36, 3, 3), (3,), (12, 12), (12,), (12,),
                                              (62, 12), (62, 3, 3), (12, 31)]
    assert all(t.is_contiguous() for t in laid)
    np.testing.assert_array_equal(laid[3][5].numpy(), params[3][:, :, 5])
