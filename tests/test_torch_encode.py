"""The port's batched encode_many on the CPU is byte-identical to
mozjpeg_tpu.encode_many, and the configuration both packages share
(quant tables, trellis rate tables) is equal."""
import dataclasses
import enum

import numpy as np
import pytest

import mozjpeg_tpu as mj
import mozjpeg_tpu_torch as mjt
from mozjpeg_tpu.codec import encoder as jenc
from mozjpeg_tpu.codec import trellis as jtr
from mozjpeg_tpu_torch.codec import encoder as tenc
from mozjpeg_tpu_torch.codec import trellis as ttr


def _photo(h, w, seed):
    """Seeded photo-like RGB: gradients, edges, a saturated-white patch
    (drives the deringing) and noise."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([255 * xx / w, 255 * yy / h,
                    128 + 90 * np.sin((xx + 2 * yy) / 5.0)], -1)
    img[: h // 2, w // 2:] = r.uniform(0, 255, 3)          # hard edge
    img[h // 4:h // 2, w // 5:w // 2] = 255                # clipped white
    img += r.normal(0, 9, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


IMAGES = [_photo(48, 64, 1), _photo(48, 64, 2), _photo(29, 37, 3),
          _photo(40, 48, 4)]


def _fields(cfg):
    return {k: (v.value if isinstance(v, enum.Enum) else v)
            for k, v in dataclasses.asdict(cfg).items()}


def _jax_kw(kw):
    """The port's enum members in kw as the JAX package's."""
    return {k: (getattr(mj, type(v).__name__)(v.value)
                if isinstance(v, (mjt.Profile, mjt.DCTMethod)) else v)
            for k, v in kw.items()}


def assert_byte_identical(imgs, **kw):
    """The port's CPU bytes equal mozjpeg_tpu.encode_many's; returns
    them."""
    want = mj.encode_many(imgs, mj.EncoderConfig(**_jax_kw(kw)))
    got = mjt.encode_many(imgs, mjt.EncoderConfig(**kw), device="cpu")
    assert [len(g) for g in got] == [len(w) for w in want]
    assert got == want
    return got


def assert_config_encodes(imgs, **kw):
    """Byte-identical to the JAX package, and different from the q75
    default's bytes for the same images, so that an option the port
    ignored could not pass."""
    got = assert_byte_identical(imgs, **kw)
    default = mjt.encode_many(imgs, mjt.EncoderConfig(quality=75),
                              device="cpu")
    for g, d in zip(got, default):
        assert g != d


def test_encode_many_byte_identical_q75():
    """Mixed shapes (two aligned 64x48, unaligned 37x29 and 48x40) at the
    bench's configuration, 4:2:0."""
    assert_byte_identical(IMAGES, quality=75)


@pytest.mark.parametrize("kw", [
    dict(quality=75), dict(quality=30, quant_tbl_idx=0),
    dict(quality=97, force_baseline=True, subsampling=(1, 1))])
def test_shared_config_and_tables_match(kw):
    jcfg = mj.EncoderConfig(**kw)
    tcfg = mjt.EncoderConfig.from_fields(_fields(jcfg))
    assert _fields(tcfg) == _fields(jcfg)
    jq = jenc.make_qtables(jcfg.resolved())
    tq = tenc.make_qtables(tcfg.resolved())
    assert len(jq) == len(tq)
    for a, b in zip(jq, tq):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(6)
    for slot in (0, 1):
        hist = rng.integers(0, 500, 256).astype(np.int32)
        hist[rng.random(256) < 0.5] = 0
        ja, jd = jtr.trellis_tables_from_hist(hist, slot, True)
        ta, td = ttr.trellis_tables_from_hist(hist, slot)
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(td, jd)
        assert ta.dtype == ja.dtype and td.dtype == jd.dtype


@pytest.mark.parametrize("kw,image", [
    (dict(device_entropy=True), None),
    (dict(precision=12), None),
    (dict(sparse_download=True), None),
    (dict(plane_pack=True), None),
    (dict(device_scanopt=True), None),
    (dict(coef_transport=True), np.zeros((16, 16), np.uint8)),
])
def test_out_of_slice_configs_raise(kw, image):
    """Each configuration an earlier slice refused with
    NotImplementedError is ported since and equals the JAX package:
    12-bit precision (uint8 samples at precision=12), the device engines
    (on an image whose planes carry iMCU dummy blocks, which the device
    scan search hands to the host search in both) and the transfer
    codecs (sparse_download, plane_pack, coef_transport)."""
    img = IMAGES[2] if image is None else image
    assert_byte_identical([img], **kw)


@pytest.mark.parametrize("host_engine", ["1", "0"])
def test_images_over_the_batch_limit_encode_like_jax(monkeypatch,
                                                     host_engine):
    """An image over MJ_BATCH_MAX_MP leaves the batched route, as in the
    JAX package (slow_idx): the host engine on the CPU where it serves
    (MJ_HOST_ENGINE=1), else the per-image route; beside it an image
    under the limit stays batched. Both give the JAX package's bytes."""
    monkeypatch.setenv("MJ_BATCH_MAX_MP", "0.002")     # 2,000 pixels
    monkeypatch.setenv("MJ_HOST_ENGINE", host_engine)
    imgs = [IMAGES[0], IMAGES[2]]                      # 3,072 and 1,073 px
    assert tenc._over_batch_limit(imgs[0])
    assert not tenc._over_batch_limit(imgs[1])
    assert_byte_identical(imgs, quality=75)
