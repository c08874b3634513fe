"""Byte equality of the port's encode_many (device="cpu") with
mozjpeg_tpu.encode_many for the ifast and float DCTs: ifast with
deringing and a restart interval in blocks, float with its own deringing
and without it; each on an aligned and an unaligned image, each
different from the q75 default's bytes."""
import pytest

import mozjpeg_tpu_torch as mjt
from test_torch_encode import _photo, assert_config_encodes

RGB = [_photo(48, 64, 5), _photo(29, 37, 5)]


@pytest.mark.parametrize("kw", [
    dict(dct_method=mjt.DCTMethod.IFAST, restart_interval=4),
    dict(dct_method=mjt.DCTMethod.FLOAT),
    dict(dct_method=mjt.DCTMethod.FLOAT, overshoot_deringing=False,
         subsampling=(1, 1)),
], ids=["ifast-restart", "float", "float-no-dering-444"])
def test_dct_methods(kw):
    assert_config_encodes(RGB, **kw)
