"""The port's host engine (codec/host_engine.py: native prep, p1 and
trellis, the arithmetic trellis with its trained coder, then the port's
entropy stage) is byte-identical to mozjpeg_tpu.encode, which takes the
JAX package's host engine for the same configurations; each case checks
that the configuration is in the port's matrix. No JAX program compiles
for these: both sides are native host code. The file also runs half of
test_torch_encode_serial.py's cases with the port's host engine off, and
trellis_q_opt for RGB through both packages' per-image routes."""
import pytest

import mozjpeg_tpu as mj
import mozjpeg_tpu_torch as mjt
from mozjpeg_tpu_torch.codec import encoder as tenc
from mozjpeg_tpu_torch.codec import host_engine
from test_torch_encode import _photo, assert_config_encodes
import test_torch_encode_serial as serial

RGB = [_photo(48, 64, 11), _photo(29, 37, 12)]

CFGS = [
    dict(quality=75),
    dict(quality=75, trellis_eob_opt=True, optimize_scans=False),
    dict(quality=75, use_scans_in_trellis=True, optimize_scans=False),
    dict(quality=75, trellis_num_loops=3, restart_interval=5,
         optimize_scans=False),
    dict(quality=75, trellis_q_opt=True, optimize_scans=False),
    dict(quality=75, trellis_delta_dc_weight=0.5, subsampling=(2, 1),
         optimize_scans=False),
    dict(quality=95, subsampling=(1, 1), progressive=False,
         optimize_scans=False),
    dict(quality=75, arithmetic=True),
    dict(quality=75, arithmetic=True, restart_in_rows=1,
         optimize_scans=False),
    dict(quality=75, arithmetic=True, restart_interval=4, progressive=False,
         trellis_q_opt=True, use_scans_in_trellis=True),
]
IDS = ["default", "eobopt", "bands", "loops3-rst5", "qopt", "dcweight-2x1",
       "q95-1x1-seq", "arith", "arith-rst-rows", "arith-seq-rst4-qopt-bands"]


def _host(img, **kw):
    ctx = tenc.resolve_group(img, mjt.EncoderConfig(**kw))
    assert host_engine.supported(ctx.cfg, ctx.cs), kw
    assert tenc._default_slots(ctx)
    return host_engine.encode_host(img, ctx)


@pytest.mark.parametrize("kw", CFGS, ids=IDS)
def test_host_engine_matches_jax_encode(kw):
    for img in RGB:
        assert _host(img, **kw) == mj.encode(img, mj.EncoderConfig(**kw))


@pytest.mark.parametrize("kw", [
    dict(quality=75, grayscale=True),
    dict(quality=85, grayscale=True, gray_sample=(2, 2), arithmetic=True),
], ids=["gray", "gray-sample-arith"])
def test_host_engine_grayscale_matches_jax_encode(kw):
    """2-D planes and gray from RGB (the native Y conversion)."""
    for img in (RGB[0][..., 1].copy(), RGB[1]):
        assert _host(img, **kw) == mj.encode(img, mj.EncoderConfig(**kw))


def test_host_engine_matrix():
    """The matrix is the JAX package's: 8-bit islow YCbCr or gray,
    without smoothing, at 2x2, 2x1 or 1x1."""
    from mozjpeg_tpu.codec import host_engine as jhe
    from mozjpeg_tpu.codec.encoder import _resolve
    for kw in (dict(), dict(dct_method=mj.DCTMethod.IFAST),
               dict(smoothing_factor=10), dict(subsampling=(1, 2)),
               dict(colorspace="rgb"), dict(grayscale=True)):
        _, jcfg, jcs, _, _, _ = _resolve(RGB[0], mj.EncoderConfig(**kw), {})
        tkw = dict(kw)
        if "dct_method" in tkw:
            tkw["dct_method"] = mjt.DCTMethod(kw["dct_method"].value)
        ctx = tenc.resolve_group(RGB[0], mjt.EncoderConfig(**tkw))
        assert (host_engine.supported(ctx.cfg, ctx.cs)
                == jhe.supported(jcfg, jcs)), kw


@pytest.mark.parametrize("img,kw", serial.CASES[3:], ids=serial.IDS[3:])
def test_encode_cpu_without_host_engine_matches_jax(monkeypatch, img, kw):
    """The rest of test_torch_encode_serial.py's cases: the port's group
    route (MJ_HOST_ENGINE=0 on the port only) against mozjpeg_tpu.encode
    through its host engine, which the JAX package pins to its batched
    route; the port's group route is held against that batched route
    for these configurations in test_torch_encode*.py, so the JAX
    compiles are not repeated here."""
    want = mj.encode(img, **kw)
    monkeypatch.setenv("MJ_HOST_ENGINE", "0")
    assert mjt.encode(img, device="cpu", **kw) == want


def test_qopt_rgb_per_image_route_matches_jax():
    """trellis_q_opt for RGB, which no host route serves: the per-image
    route on both sides (kept here, beside the host engine's q_opt case,
    to spread the JAX compiles of test_torch_encode_qopt.py)."""
    assert_config_encodes(RGB[:1], quality=75, colorspace="rgb",
                          trellis_q_opt=True, optimize_scans=False)
