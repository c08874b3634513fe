"""The port's colour spaces beyond YCbCr and gray on the CPU equal the
JAX package's exactly: ycck_to_cmyk and rgb_to_gray on seeded arrays
with the extremes, and decode / decode_many (RGB and YUV output) of the
port's own RGB, CMYK and YCCK streams at several samplings, with fancy
and replicating upsampling, against mozjpeg_tpu. A YCCK stream whose K
plane is subsampled (rewritten SOF) takes K's own upsampling mode."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mozjpeg_tpu as mj
import mozjpeg_tpu_torch as mjt
from mozjpeg_tpu.ops import color as jcolor
from mozjpeg_tpu_torch.codec import decoder as tdec
from mozjpeg_tpu_torch.codec import marker as tmarker
from mozjpeg_tpu_torch.ops import color as tcolor
from test_torch_decode import _photo, _truncate, _with_sof, on_torch_render


def _seeded(seed, channels):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (5, 37, channels)).astype(np.uint8)
    a[0, :2] = 0
    a[0, 2:4] = 255
    return a


def test_ycck_to_cmyk_exact():
    a = _seeded(60, 4)
    want = np.asarray(jcolor.ycck_to_cmyk(jnp.asarray(a)))
    got = tcolor.ycck_to_cmyk(torch.from_numpy(a)).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_rgb_to_gray_exact():
    a = _seeded(61, 3)
    want = np.asarray(jcolor.rgb_to_gray(jnp.asarray(a)))
    got = tcolor.rgb_to_gray(torch.from_numpy(a)).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _cmyk(img, seed):
    return np.concatenate([img, _photo(img.shape[0], img.shape[1],
                                       seed)[..., :1]], -1)


@pytest.fixture(scope="module")
def streams():
    img, odd = _photo(48, 64, 62), _photo(29, 37, 63)

    def enc(im, **kw):
        return mjt.encode(im, mjt.EncoderConfig(quality=80, **kw),
                          device="cpu")

    s = {
        "rgb": enc(img, colorspace="rgb"),
        "rgb_odd_seq": enc(odd, colorspace="rgb", progressive=False),
        "cmyk": enc(_cmyk(img, 64)),
        "cmyk_odd": enc(_cmyk(odd, 65)),
        "ycck_420": enc(_cmyk(img, 66), colorspace="ycck"),
        "ycck_odd_2x1": enc(_cmyk(odd, 67), colorspace="ycck",
                            subsampling=(2, 1)),
        "ycck_odd_1x1_arith": enc(_cmyk(odd, 68), colorspace="ycck",
                                  subsampling=(1, 1), arithmetic=True),
        # a fourth component at 1x1 beside 2x2 luma: K upsamples h2v2
        "ycck_k_subsampled": _with_sof(enc(img), extra_comp=True,
                                       adobe=2),
    }
    s["cmyk_truncated"] = _truncate(s["cmyk"], 0.6)
    return s


NAMES = ["rgb", "rgb_odd_seq", "cmyk", "cmyk_odd", "ycck_420",
         "ycck_odd_2x1", "ycck_odd_1x1_arith", "ycck_k_subsampled",
         "cmyk_truncated"]
WANT_CS = {"rgb": "rgb", "cmyk": "cmyk", "ycck": "ycck"}


def test_inputs_cover_the_paths(streams):
    for name in NAMES:
        jp = tmarker.parse(streams[name])
        assert tdec._jpeg_colorspace(jp) == WANT_CS[name.split("_")[0]]
    modes = {n: (tdec._upsample_mode(tmarker.parse(streams[n]))[0],
                 tdec._upsample_mode(tmarker.parse(streams[n]),
                                     comp=3)[0])
             for n in ("ycck_420", "ycck_odd_2x1", "ycck_k_subsampled")}
    assert modes == {"ycck_420": ("h2v2", "none"),
                     "ycck_odd_2x1": ("h2v1", "none"),
                     "ycck_k_subsampled": ("h2v2", "h2v2")}


def _equal(got, want):
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
        return
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fancy", [True, False])
@pytest.mark.parametrize("name", NAMES)
def test_decode_equals_jax(streams, name, fancy):
    data = streams[name]
    want = mj.decode(data, fancy_upsample=fancy)
    got = mjt.decode(data, fancy_upsample=fancy, device="cpu")
    _equal(got, want)
    assert got.shape[-1] == (3 if name.startswith("rgb") else 4)


@pytest.mark.parametrize("output", ["rgb", "yuv"])
def test_decode_many_equals_jax(streams, output):
    """A mixed list: every stream above between two YCbCr ones."""
    ycc = mjt.encode(_photo(48, 64, 69), mjt.EncoderConfig(quality=75),
                     device="cpu")
    datas = [ycc] + [streams[n] for n in NAMES] + [ycc]
    _equal(on_torch_render(mjt.decode_many, datas, output=output,
                           device="cpu"),
           mj.decode_many(datas, output=output))
