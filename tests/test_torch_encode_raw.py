"""encode_raw_yuv (pre-subsampled planes, jpeg_write_raw_data) of the
port on the CPU, byte for byte against the JAX package's: 4:2:0 at the
full mozjpeg default, grayscale, an unaligned 29x37 frame whose planes
are shorter than the block grid (edge replication) and the ifast DCT; the
property that encode_raw_yuv of the planes encode() prepares gives
encode()'s bytes; and ops/sample.downsample_h1v2 against the JAX op."""
import numpy as np
import pytest
import torch

import mozjpeg_tpu as mj
import mozjpeg_tpu_torch as mjt
from mozjpeg_tpu.codec import encoder as jenc
from mozjpeg_tpu.ops import sample as jsample
from mozjpeg_tpu_torch.codec import encoder as tenc
from mozjpeg_tpu_torch.ops import color, sample
from test_torch_decode import _photo


def _i420(img):
    """The YCbCr planes of an RGB image at 4:2:0, as encode() prepares
    them for a frame whose sides are even."""
    ycc = color.rgb_to_ycc(torch.from_numpy(img))
    return [ycc[..., 0].numpy()] + [
        sample.downsample_h2v2(ycc[..., c].contiguous()).numpy()
        for c in (1, 2)]


def _both(planes, w, h, samp, **cfg):
    a = jenc.encode_raw_yuv(planes, w, h, samp, mj.EncoderConfig(**cfg))
    b = tenc.encode_raw_yuv(planes, w, h, samp, mjt.EncoderConfig(**cfg),
                            device="cpu")
    return a, b


S420 = [(2, 2), (1, 1), (1, 1)]


def test_default_420_equals_jax_and_encode():
    img = _photo(48, 64, 41)
    a, b = _both(_i420(img), 64, 48, S420, quality=75)
    assert a == b
    # the raw planes of an MCU-aligned image give encode()'s bytes
    assert b == mjt.encode(img, mjt.EncoderConfig(quality=75), device="cpu")


def test_gray_equals_jax():
    plane = _photo(48, 64, 42)[..., 1]
    a, b = _both([plane], 64, 48, [(1, 1)], quality=80)
    assert a == b
    assert b == mjt.encode(plane, mjt.EncoderConfig(quality=80),
                           device="cpu")


def test_unaligned_edge_replication_equals_jax():
    """29x37 at 4:2:0: the luma plane is 30x38 (tjPlaneWidth/Height) and
    the block grid 32x40, so the last row and column replicate."""
    rng = np.random.default_rng(43)
    planes = [rng.integers(0, 256, (30, 38), dtype=np.uint8),
              rng.integers(0, 256, (15, 19), dtype=np.uint8),
              rng.integers(0, 256, (15, 19), dtype=np.uint8)]
    a, b = _both(planes, 37, 29, S420, quality=75)
    assert a == b


def test_ifast_equals_jax():
    img = _photo(48, 64, 44)
    a, b = _both(_i420(img), 64, 48, S420, quality=75,
                 dct_method=mjt.DCTMethod.IFAST)
    assert a == b
    assert b != tenc.encode_raw_yuv(_i420(img), 64, 48, S420,
                                    mjt.EncoderConfig(quality=75),
                                    device="cpu")


def test_overrides_build_the_config():
    """A departure kept on purpose: with config None the port builds its
    configuration from **overrides, as encode() does; the JAX function
    ignores them and encodes at EncoderConfig()."""
    planes = _i420(_photo(48, 64, 41))
    got = tenc.encode_raw_yuv(planes, 64, 48, S420, device="cpu",
                              quality=90)
    assert got == tenc.encode_raw_yuv(planes, 64, 48, S420,
                                      mjt.EncoderConfig(quality=90),
                                      device="cpu")
    jax_default = jenc.encode_raw_yuv(planes, 64, 48, S420,
                                      mj.EncoderConfig())
    assert jenc.encode_raw_yuv(planes, 64, 48, S420,
                               quality=90) == jax_default
    assert got != jax_default


def test_raw_yuv_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tenc.encode_raw_yuv(_i420(_photo(16, 16, 45)), 16, 16, S420)


@pytest.mark.parametrize("shape", [(2, 6), (6, 9), (3, 8, 5)])
def test_downsample_h1v2_equals_jax(shape):
    rng = np.random.default_rng(46)
    x = rng.integers(0, 256, shape, dtype=np.uint8)
    x[..., 0, :] = 255
    want = np.asarray(jsample.downsample_h1v2(x))
    got = sample.downsample_h1v2(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)
    wide = x.astype(np.int32) << 4
    assert np.array_equal(
        sample.downsample_h1v2(torch.from_numpy(wide)).numpy(),
        np.asarray(jsample.downsample_h1v2(wide)))
