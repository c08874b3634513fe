"""Byte equality of the port's encode_many (device="cpu") with
mozjpeg_tpu.encode_many for the scan scripts and the entropy stage:
sequential with standard and optimized tables, the FASTEST profile (one
DQT and DHT per table), the simple and custom progressive scripts, DC
scan modes, restart intervals per scan and in the scan search, quant
tables from several qualities and base tables, ICC chunks and density;
each on an aligned and an unaligned image, each different from the q75
default's bytes."""
import numpy as np
import pytest

import mozjpeg_tpu_torch as mjt
from test_torch_encode import _photo, assert_config_encodes

RGB = [_photo(48, 64, 41), _photo(29, 37, 42)]
BASE = (np.arange(64) % 17 + 4).reshape(8, 8)


@pytest.mark.parametrize("kw", [
    dict(progressive=False, optimize_coding=False, restart_in_rows=1),
    dict(progressive=False, trellis_quant=False, quality=[75, 60]),
    dict(profile=mjt.Profile.FASTEST, progressive=True),
    dict(optimize_scans=False, dc_scan_opt_mode=2, restart_in_rows=1),
    dict(scan_script=[((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 63, 0, 0),
                      ((1,), 1, 63, 0, 0), ((2,), 1, 63, 0, 0),
                      ((0, 1, 2), 0, 0, 1, 0)],
         base_quant_tables=[BASE, BASE.T], force_baseline=True),
    dict(icc=bytes(range(256)) * 300, density=(1, 72, 96),
         dc_scan_opt_mode=1, restart_in_rows=1),
], ids=["seq-std-restart", "seq-opt-qlist", "fastest-progressive",
        "simple-progression-rows", "custom-script-base-tables",
        "icc-search-restart"])
def test_scripts_and_markers(kw):
    assert_config_encodes(RGB, **kw)
