"""The PyTorch port's own file formats against the libraries dcpt_tpu reads them
with: its PNG decoder on the row filters Average and Paeth."""

import numpy as np
import pytest

import _torch_threads  # noqa: F401
from _torch_io_util import KINDS, cv2_decode, image, png_with_filter
from dcpt_tpu_torch.utils import png


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("ftype", [3, 4])
def test_png_decodes_every_row_filter(kind, ftype):
    img = image(KINDS[kind], seed=ftype)
    buf = png_with_filter(img, ftype)
    np.testing.assert_array_equal(cv2_decode(buf), img)  # the test's encoder is right
    np.testing.assert_array_equal(png.decode(buf), img)
