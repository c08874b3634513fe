"""The port's 12-bit sequential grayscale route (DICOM's lossy 12-bit
JPEG: precision 12, progressive off, mozjpeg's other defaults) on the
CPU, held against portbench's independent reference
(portbench/reference/gray12_ref.py: SOF1 parsing, the 12-bit islow FDCT,
overshoot deringing at mozjpeg's threshold, 127 centered at every
precision, the AC trellis at 14-bit lengths and maxq 16383, the DC
trellis, the one scan recoded with its own optimal tables), without a
JAX oracle.

Seeded radiograph-like images (portbench/core/radiographs.py, with a
raw-beam border saturated at 4095) at two small whole-block sizes give 0
on all four counts. The controls the reference must catch: the trellis
off (bad_trellis), the ifast DCT (bad_coefs), the reference itself at
the 8-bit trellis limits or at the threshold of MAXJSAMPLE (2047
centered) on the port's correct streams, and deringing off (a departure
on the blocks the threshold splits alone). The scan counters of the
sequential route are on every traced image span and cost no clock read
untraced; the progressive route's spans carry none.
"""
import numpy as np
import pytest
import torch

import mozjpeg_tpu_torch as mjt
from mozjpeg_tpu_torch.codec import stages
from portbench.core import radiographs
from portbench.reference import encode_ref, gray12_ref, jpeg_read

Q = 90
CFG = dict(quality=Q, precision=12, progressive=False)
SIZES = {"112x152": (112, 152), "72x96": (72, 96)}
CLEAN = {"bad_stream": 0, "bad_coef": 0, "bad_scan": 0, "bad_trellis": 0}
SCAN_COUNTERS = ("scan_gather_ns", "scan_emit_ns", "scan_blocks",
                 "scan_bytes")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def images():
    out = {}
    for k, (name, (h, w)) in enumerate(SIZES.items()):
        out[name] = radiographs.suites([(h, w)] * 2, 1, 2**33 + 41 + k,
                                       "cpu")[0]
        assert all((im == 4095).any() for im in out[name])
    return out


def _encode(imgs, **kw):
    return mjt.encode_many(imgs, mjt.EncoderConfig(**dict(CFG, **kw)),
                           device="cpu")


def _check(data, img, **kw):
    r = gray12_ref.check_stream(data, img, Q, True, seed=5, n_blocks=96,
                                n_rows=4, **kw)
    return {k: r[k] for k in CLEAN}


@pytest.fixture(scope="module")
def streams(images):
    return {name: _encode(imgs) for name, imgs in images.items()}


@pytest.mark.parametrize("size", list(SIZES))
def test_port_matches_the_reference(images, streams, size):
    h, w = SIZES[size]
    for img, data in zip(images[size], streams[size]):
        assert gray12_ref.header_ok(data, w, h, Q)
        assert _check(data, img) == CLEAN


def _summed(images, streams, **kw):
    """The counts summed over the images of the larger size."""
    tot = dict.fromkeys(CLEAN, 0)
    for name in list(SIZES)[:1]:
        for img, data in zip(images[name], streams[name]):
            for k, v in _check(data, img, **kw).items():
                tot[k] += v
    return tot


@pytest.mark.parametrize("control,caught", [
    ("trellis_off", "bad_trellis"), ("ifast", "bad_coef")])
def test_the_reference_catches_the_controls(images, control, caught):
    kw = {"trellis_off": dict(trellis_quant=False),
          "ifast": dict(dct_method=mjt.DCTMethod.IFAST)}[control]
    name = list(SIZES)[0]
    got = _summed(images, {name: _encode(images[name], **kw)})
    assert got["bad_stream"] == 0 and got[caught] > 0, got


def test_the_maxjsample_threshold_fails_the_12_bit_streams(images,
                                                          streams):
    """The check tells mozjpeg's threshold from MAXJSAMPLE's, the open
    question a 12-bit cjpeg would settle."""
    got = _summed(images, streams, maxs=2047)
    assert got["bad_stream"] == 0 and got["bad_coef"] > 0, got


def test_8_bit_trellis_limits_fail_the_12_bit_streams(images, streams):
    got = _summed(images, streams, kmax=10, maxq=1023)
    assert got["bad_coef"] + got["bad_trellis"] > 0, got


def test_deringing_off_departs_on_the_saturated_blocks_alone(images):
    """Without deringing the coefficients outside the trellis's candidates
    all lie in blocks that hold samples at or above the threshold (and
    not all 64)."""
    qt = encode_ref.qtable(Q)
    inside = outside = 0
    for name, (h, w) in SIZES.items():
        plain = _encode(images[name], overshoot_deringing=False)
        for img, data in zip(images[name], plain):
            got = gray12_ref.read(data, w, h, Q)
            nat = np.zeros_like(got.coefs, dtype=np.int64)
            nat[..., jpeg_read.ZIGZAG] = got.coefs
            raw = gray12_ref.raw_coefficients(img, int(qt[0]), True)
            sat = (gray12_ref.blocks(img.astype(np.int64))
                   >= gray12_ref.CENTER + gray12_ref.MAXS).sum(-1)
            mixed = (sat > 0) & (sat < 64)
            inside += gray12_ref.outside_candidates(raw[mixed], nat[mixed],
                                                    qt)
            outside += gray12_ref.outside_candidates(raw[~mixed],
                                                     nat[~mixed], qt)
    assert inside > 0 and outside == 0, (inside, outside)


def test_scan_counters_on_traced_image_spans(images, streams, monkeypatch):
    imgs = images["72x96"]
    with stages.tracing() as spans:
        outs = _encode(imgs)
    assert outs == streams["72x96"]
    got = [s for s in spans if s.name == "enc.entropy_image"]
    assert len(got) == len(imgs)
    for s in got:
        assert set(SCAN_COUNTERS) <= set(s.attrs), s.attrs
        assert s.attrs["scan_blocks"] == (72 // 8) * (96 // 8)
        fr = jpeg_read.parse(outs[s.attrs["image"]])
        # the scan's entropy-coded bytes, stuffing included
        raw = fr.scans[0].raw
        assert s.attrs["scan_bytes"] == len(raw) - raw.index(b"\xff\xda") \
            - 2 - int.from_bytes(raw[raw.index(b"\xff\xda") + 2:
                                     raw.index(b"\xff\xda") + 4], "big")
        assert s.attrs["scan_gather_ns"] > 0 and s.attrs["scan_emit_ns"] > 0
    # the progressive route codes its scans in the native search
    with stages.tracing() as spans:
        _encode(imgs, progressive=True)
    got = [s for s in spans if s.name == "enc.entropy_image"]
    assert got and not any(set(SCAN_COUNTERS) & set(s.attrs) for s in got)
    assert all("candidates" in s.attrs for s in got)
    # untraced: no span, no clock read
    reads = []
    monkeypatch.setattr(stages, "_clock", lambda: reads.append(1) or 0)
    stages.clear_spans()
    assert _encode(imgs) == streams["72x96"]
    assert reads == [] and stages.recent_spans() == []
