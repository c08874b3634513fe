"""Byte equality of the port's encode_many (device="cpu") with
mozjpeg_tpu.encode_many for the colour spaces: grayscale from RGB and
from 2-D planes with gray_sample, RGB (with smoothing), CMYK and YCCK
frames; each on an aligned and an unaligned image, and each different
from the q75 default's bytes."""
import numpy as np
import pytest

from test_torch_encode import _photo, assert_config_encodes

RGB = [_photo(48, 64, 21), _photo(29, 37, 22)]
GRAY = [im[..., 1].copy() for im in RGB]
CMYK = [np.concatenate([im, 255 - im[..., :1]], -1) for im in RGB]


@pytest.mark.parametrize("imgs,kw", [
    (RGB, dict(grayscale=True, gray_sample=(2, 2))),
    (GRAY, dict(gray_sample=(1, 2))),
    (RGB, dict(colorspace="rgb", smoothing_factor=20)),
    (CMYK, dict(overshoot_deringing=False)),
    (CMYK, dict(colorspace="ycck", subsampling=(2, 1))),
], ids=["gray-from-rgb", "gray-2d", "rgb-smooth", "cmyk-no-dering",
        "ycck"])
def test_colour_spaces(imgs, kw):
    assert_config_encodes(imgs, **kw)
