"""trellis_q_opt and quant slots other than the colorspace's through the
port's encode_many on the CPU, byte-identical to
mozjpeg_tpu.encode_many: q_opt through the host engine and through the
per-image route (each image refits its own tables, also in one group),
qslots alone and with q_opt; and, with the scan search, the port's frame
header names the slots the coefficients were quantized with."""
import numpy as np
import pytest

import mozjpeg_tpu as mj
import mozjpeg_tpu_torch as mjt
from mozjpeg_tpu_torch.codec import marker
from test_torch_decode import torch_render
from test_torch_encode import _photo, assert_config_encodes

RGB = [_photo(48, 64, 51), _photo(29, 37, 52)]
QOPT = dict(trellis_q_opt=True, optimize_scans=False)


def test_qopt_host_engine_matches_jax():
    assert_config_encodes(RGB, quality=75, **QOPT)


@pytest.mark.parametrize("imgs,kw", [
    (RGB[1:], dict(dct_method=mjt.DCTMethod.IFAST, trellis_num_loops=2,
                   restart_interval=4, **QOPT)),
    (RGB[:1], dict(qslots=(1, 0, 1), optimize_scans=False)),
    (RGB[1:], dict(qslots=(1, 0), progressive=False, **QOPT)),
], ids=["qopt-ifast-loops2-rst4", "qslots-101", "qslots-qopt"])
def test_per_image_route_matches_jax(imgs, kw):
    """(q_opt for RGB is in test_torch_host_engine.py.)"""
    assert_config_encodes(imgs, quality=75, **kw)


def _dqt(data: bytes):
    return marker.parse(data).qtables


def test_qopt_two_images_in_one_group(monkeypatch):
    """Two different images of one shape share a group on the port's
    per-image route; each gets its own refit tables, as the JAX package's
    per-image encodes give them."""
    monkeypatch.setenv("MJ_HOST_ENGINE", "0")
    imgs = [RGB[0], _photo(48, 64, 53)]
    got = mjt.encode_many(imgs, mjt.EncoderConfig(quality=75, **QOPT),
                          device="cpu")
    assert got == mj.encode_many(imgs, mj.EncoderConfig(quality=75, **QOPT))
    assert not all(np.array_equal(a, b) for a, b in zip(
        _dqt(got[0]).values(), _dqt(got[1]).values()))


def test_qslots_with_scan_search_names_the_slots():
    """The scan search's frame header takes the slots (the JAX package
    writes slots 0 and 1 there whatever qslots says; ROADMAP.md Faults):
    the stream decodes to the pixels of the same coefficients in one
    sequential scan, which the test above holds equal to the JAX
    package's."""
    img = RGB[0]
    kw = dict(quality=75, qslots=(1, 0, 1))
    searched = mjt.encode(img, mjt.EncoderConfig(**kw), device="cpu")
    seq = mjt.encode(img, mjt.EncoderConfig(progressive=False, **kw),
                     device="cpu")
    jp = marker.parse(searched)
    assert [c.quant_tbl for c in jp.components] == [1, 0, 1]
    with torch_render():
        np.testing.assert_array_equal(mjt.decode(searched, device="cpu"),
                                      mjt.decode(seq, device="cpu"))
