"""Byte equality of the port's encode_many (device="cpu") with
mozjpeg_tpu.encode_many for the trellis options: trellis off, the DC
trellis and deringing off with other lambda scales, the EOB-run DP,
several trellis loops, per-band trellis passes, the DC delta weight, and
their combinations; each on an aligned and an unaligned image (images on
which the EOB-run DP changes the output), each different from the q75
default's bytes."""
import pytest

from test_torch_encode import _photo, assert_config_encodes

RGB = [_photo(48, 64, 1), _photo(29, 37, 4)]


@pytest.mark.parametrize("kw", [
    dict(trellis_quant=False),
    dict(trellis_quant_dc=False, overshoot_deringing=False,
         lambda_log_scale1=15.5, lambda_log_scale2=17.0),
    dict(trellis_eob_opt=True),
    dict(trellis_num_loops=2, trellis_delta_dc_weight=0.5),
    dict(use_scans_in_trellis=True, trellis_freq_split=5,
         trellis_eob_opt=True),
    dict(use_scans_in_trellis=True, trellis_freq_split=5,
         trellis_num_loops=2, optimize_coding=False),
], ids=["no-trellis", "no-dc-no-dering-lambda", "eob-opt",
        "loops-delta-dc", "scans-eob", "scans-loops-std-tables"])
def test_trellis_options(kw):
    assert_config_encodes(RGB, **kw)
