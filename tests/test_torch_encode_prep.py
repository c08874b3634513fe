"""Byte equality of the port's encode_many (device="cpu") with
mozjpeg_tpu.encode_many for the device prep: a subsampling the host prep
does not compute exactly (1x2), and host_prep=False with input smoothing
at 2x2 (4x2 and 1x2 smoothing are held op by op in
test_torch_encode_ops.py); each on an aligned and an unaligned image, and each
different from the q75 default's bytes."""
import pytest

from test_torch_encode import _photo, assert_config_encodes

RGB = [_photo(48, 64, 21), _photo(29, 37, 22)]


@pytest.mark.parametrize("kw", [
    dict(subsampling=(1, 2)),
    dict(host_prep=False, smoothing_factor=30),
], ids=["device-prep-1x2", "no-host-prep-smooth-2x2"])
def test_device_prep_and_smoothing(kw):
    assert_config_encodes(RGB, **kw)
