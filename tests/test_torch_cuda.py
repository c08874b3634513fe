"""Tests that need the card: the AC trellis kernel against its plain
version (ragged tiles, N = 1, all-zero, dense and rate-less inputs, three
bands), the port's encode on the GPU against its CPU path (the batched
families, and the per-image routes: arithmetic coding with and without
the trellis, trellis_q_opt, other quant slots; serial encode() against
the CPU's host engine), the arithmetic row trellis on the GPU against
the CPU on a tie-heavy row, and its decode (decode, decode_many in RGB
and YUV, a truncated progressive stream; arithmetic, RGB, CMYK and YCCK
streams with the islow, ifast and float IDCTs, a corrupt stream with
16-bit quant tables, decode_grayscale, decode_cropped and BufferedImage;
decode_scaled at every M/8, the scaled IDCTs on int16 extremes,
decode_rgb565 and decode_many(output="rgb565")) on the GPU against its
CPU path. They skip
without a GPU; run them on one with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(tests/conftest.py imports jax, which a GPU host need not have).
"""
import numpy as np
import pytest
import torch

import mozjpeg_tpu_torch as mjt
from mozjpeg_tpu_torch.codec import marker
from mozjpeg_tpu_torch.codec import trellis as ttr
from mozjpeg_tpu_torch.ops import trellis_ac as tac
from test_torch_trellis_order import BANDS

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("band,tie", [((1, 63), False), ((1, 8), True),
                                      ((9, 63), True), ((1, 63), True)])
def test_kernel_equals_plain_on_the_card(cuda, band, tie):
    rng = np.random.default_rng(21)
    b, n_img = 3, 1000
    n = b * n_img
    if tie:
        vals = np.array([0, 8, 16, 64, 256, 1024], np.int32)
        raw = (vals[rng.integers(0, len(vals), (64, n))]
               * rng.choice([-1, 1], (64, n))).astype(np.int32)
        lam = np.full(n, 2.0, np.float32)
    else:
        raw = rng.integers(-12000, 12000, (64, n)).astype(np.int32)
        raw[rng.random(raw.shape) < 0.6] = 0
        lam = (rng.random(n) * 4 + 0.01).astype(np.float32)
    qz = np.clip(rng.integers(1, 60, 64), 1, 255).astype(np.int32)
    si = rng.integers(2, 17, (b, 256)).astype(np.int32)
    si[:, 0] = rng.integers(2, 10, b)
    si[1, 0xF0] = 0
    args = (torch.as_tensor(raw, device=cuda),
            torch.as_tensor(qz, device=cuda),
            torch.as_tensor(ttr.recip2_table()[qz], device=cuda),
            ttr.rate_lut(torch.as_tensor(si, device=cuda)),
            torch.as_tensor(lam, device=cuda)) + band + (n_img,)
    before = tac.trellis_ac.launches
    nb, ei = tac.trellis_ac(*args)
    assert tac.trellis_ac.launches == before + 1
    nb_p, ei_p = tac.trellis_ac_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(nb, nb_p)
    assert torch.equal(ei, ei_p)


@pytest.mark.parametrize("band", BANDS)
@pytest.mark.parametrize("kind,b,n_img", [
    ("sparse", 3, 1001), ("sparse", 3, 2752), ("tie", 3, 1001),
    ("sparse", 1, 1), ("dense", 1, 1), ("zero", 3, 1001),
    ("dense", 3, 1001), ("no_codes", 3, 1001)])
def test_kernel_tiles_and_extremes_equal_plain(cuda, kind, b, n_img, band):
    """Ragged last tiles and odd N (n_img 1,001 and 2,752 with B = 3),
    N = 1, all-zero and fully dense blocks, and blocks where no step
    beats BIG."""
    args = tuple(torch.as_tensor(a, device=cuda)
                 for a in ttr.ac_example_inputs(kind, b, n_img, seed=n_img)) \
        + band + (n_img,)
    before = tac.trellis_ac.launches
    nb, ei = tac.trellis_ac(*args)
    assert tac.trellis_ac.launches == before + 1
    nb_p, ei_p = tac.trellis_ac_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(nb, nb_p)
    assert torch.equal(ei.view(torch.int32), ei_p.view(torch.int32))


def test_encode_on_the_card_equals_cpu(cuda):
    rng = np.random.default_rng(5)
    imgs = [np.clip(rng.normal(128, 60, (h, w, 3)), 0, 255).astype(np.uint8)
            for h, w in ((64, 96), (64, 96), (45, 77))]
    cfg = mjt.EncoderConfig(quality=75)
    assert (mjt.encode_many(imgs, cfg)
            == mjt.encode_many(imgs, cfg, device="cpu"))


@pytest.mark.parametrize("channels,kw", [
    (1, dict(gray_sample=(1, 2), restart_interval=3)),
    (4, dict(colorspace="ycck")),
    (3, dict(dct_method=mjt.DCTMethod.IFAST, restart_in_rows=1)),
    (3, dict(dct_method=mjt.DCTMethod.FLOAT, smoothing_factor=20)),
    (3, dict(trellis_eob_opt=True, trellis_num_loops=2)),
    (3, dict(use_scans_in_trellis=True, trellis_delta_dc_weight=0.5)),
    (3, dict(profile=mjt.Profile.FASTEST, subsampling=(1, 2))),
], ids=["gray-2d", "ycck", "ifast-rows", "float-smooth", "eob-loops",
        "scans-delta-dc", "fastest-1x2"])
def test_config_on_the_card_equals_cpu(cuda, channels, kw):
    """The configuration families of the batched encode surface: the
    card's bytes equal the CPU path's (which the CPU tests hold equal to
    the JAX package's)."""
    imgs = _images(channels)
    cfg = mjt.EncoderConfig(quality=75, **kw)
    assert (mjt.encode_many(imgs, cfg)
            == mjt.encode_many(imgs, cfg, device="cpu"))


def _images(channels=3, seed=6):
    rng = np.random.default_rng(seed)
    imgs = []
    for h, w in ((64, 96), (64, 96), (45, 77)):
        base = rng.normal(128, 60, (h, w, 3))
        base[h // 4:h // 2, w // 4:w // 2] = 255
        if channels == 4:
            base = np.concatenate([base, base[..., :1]], -1)
        img = np.clip(base, 0, 255).astype(np.uint8)
        imgs.append(img[..., 0].copy() if channels == 1 else img)
    return imgs


@pytest.mark.parametrize("channels,kw", [
    (3, dict(arithmetic=True)),
    (3, dict(arithmetic=True, restart_in_rows=1, colorspace="rgb")),
    (1, dict(arithmetic=True, trellis_quant=False)),
    (4, dict(arithmetic=True, progressive=False, restart_interval=2,
             trellis_quant=False)),
    (3, dict(trellis_q_opt=True, trellis_num_loops=2)),
    (3, dict(qslots=(1, 0, 1), trellis_q_opt=True, optimize_scans=False)),
], ids=["arith", "arith-rgb-rows1", "arith-notrellis-gray",
        "arith-seq-rst2-cmyk", "qopt-loops2", "qslots-qopt"])
def test_per_image_config_on_the_card_equals_cpu(cuda, channels, kw):
    """The configurations the batched route does not carry run the
    per-image route on the card (the arithmetic row trellis in PyTorch,
    the AC kernel for q_opt and other slots); on the CPU the host engine
    serves the YCbCr ones, as in the JAX package. Same bytes."""
    imgs = _images(channels)
    cfg = mjt.EncoderConfig(quality=75, **kw)
    assert (mjt.encode_many(imgs, cfg)
            == mjt.encode_many(imgs, cfg, device="cpu"))


@pytest.mark.parametrize("kw", [dict(), dict(arithmetic=True),
                                dict(trellis_q_opt=True)],
                         ids=["default", "arith", "qopt"])
def test_serial_encode_on_the_card_equals_host_engine(cuda, kw):
    for img in _images():
        assert (mjt.encode(img, quality=75, **kw)
                == mjt.encode(img, quality=75, device="cpu", **kw))


def test_arith_rows_on_the_card_equal_cpu(cuda):
    """A tie-heavy row (q = 1, raw on multiples of 8, lambda 1/64: equal
    costs are common) with trained rates: the card's first-minimum
    choices are the CPU's."""
    from mozjpeg_tpu_torch.codec import encoder as tenc
    rng = np.random.default_rng(12)
    n = 192
    raw = (rng.integers(-6, 7, (64, n)) * 8).astype(np.int32)
    raw[rng.random(raw.shape) < 0.6] = 0
    q = raw // 8
    lam = np.full(n, 1 / 64, np.float32)
    qz = np.ones(64, np.int32)
    with tenc.ArithTrainer(tenc.EncoderConfig().resolved(), 0) as coder:
        for _ in range(3):
            blk = np.zeros((40, 64), np.int16)
            blk[:, :12] = rng.integers(-6, 7, (40, 12))
            coder.train(blk)
        dc_rates, ac_rates = (r.copy() for r in coder.rates())
    args = [raw, q.astype(np.int16), qz, lam]
    for band in ((1, 63), (1, 8)):
        out = [ttr.arith_ac_row(*(torch.as_tensor(a, device=d)
                                  for a in args), ac_rates, *band)
               for d in (cuda, "cpu")]
        assert torch.equal(out[0].cpu(), out[1])
    dcs = [ttr.arith_dc_imcu_row(
        torch.as_tensor(raw[0].reshape(2, -1), device=d), 1, dc_rates, 9,
        torch.as_tensor(lam.reshape(2, -1), device=d))
        for d in (cuda, "cpu")]
    assert torch.equal(dcs[0].cpu(), dcs[1])


@pytest.fixture(scope="module")
def port_jpegs():
    """Port-encoded q75 4:2:0, 2x1 and 1x1 streams (two shapes each) and a
    truncated copy of the first, which takes block smoothing."""
    rng = np.random.default_rng(9)
    outs = []
    for samp in ((2, 2), (2, 1), (1, 1)):
        imgs = [np.clip(rng.normal(128, 50, (h, w, 3)), 0, 255)
                .astype(np.uint8) for h, w in ((48, 64), (29, 37))]
        outs += mjt.encode_many(imgs, mjt.EncoderConfig(
            quality=75, subsampling=samp), device="cpu")
    trunc = outs[0][:len(outs[0]) * 2 // 3] + b"\xff\xd9"
    return outs + [trunc]


def _same(a, b):
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and np.array_equal(a, b)


def test_decode_on_the_card_equals_cpu(cuda, port_jpegs):
    for data in port_jpegs:
        assert _same(mjt.decode(data), mjt.decode(data, device="cpu"))


@pytest.mark.parametrize("output", ["rgb", "yuv"])
def test_decode_many_on_the_card_equals_cpu(cuda, port_jpegs, output):
    datas = port_jpegs * 3               # more than one group of a shape
    assert _same(mjt.decode_many(datas, output=output),
                 mjt.decode_many(datas, output=output, device="cpu"))


@pytest.fixture(scope="module")
def more_jpegs():
    """Port-encoded arithmetic (progressive, and sequential with
    restarts), RGB, CMYK and YCCK streams, a truncated arithmetic copy,
    and a corrupt stream with 16-bit quant tables (the float IDCT's
    saturating conversion)."""
    rng = np.random.default_rng(10)
    img = np.clip(rng.normal(128, 50, (48, 64, 3)), 0, 255).astype(np.uint8)
    k_img = np.concatenate([img, img[..., :1]], -1)
    out = {}
    for name, im, kw in (
            ("arith", img, dict(arithmetic=True)),
            ("arith_seq", img, dict(arithmetic=True, progressive=False,
                                    restart_interval=2)),
            ("rgb", img, dict(colorspace="rgb")),
            ("cmyk", k_img, dict()),
            ("ycck", k_img, dict(colorspace="ycck")),
            ("wide", img, dict(quality=5, force_baseline=False,
                               progressive=False))):
        kw.setdefault("quality", 75)
        out[name] = mjt.encode(im, mjt.EncoderConfig(**kw), device="cpu")
    out["arith_trunc"] = out["arith"][:len(out["arith"]) * 2 // 3] \
        + b"\xff\xd9"
    b = bytearray(out["wide"])
    for scan in marker.parse(out["wide"]).scans:
        for f in (0.3, 0.5, 0.7):
            i = scan.data_start + int(f * (scan.data_end - scan.data_start))
            if b[i] not in (0xFF, 0x00) and b[i - 1] != 0xFF:
                b[i] ^= 0x5A
    out["wide_corrupt"] = bytes(b)
    return out


@pytest.mark.parametrize("method", ["islow", "ifast", "float"])
def test_more_streams_decode_on_the_card_equals_cpu(cuda, more_jpegs, method):
    for data in more_jpegs.values():
        assert _same(mjt.decode(data, dct_method=method),
                     mjt.decode(data, dct_method=method, device="cpu"))


@pytest.mark.parametrize("output", ["rgb", "yuv"])
def test_more_streams_decode_many_on_the_card_equals_cpu(cuda, more_jpegs,
                                                   output):
    datas = list(more_jpegs.values()) * 2
    assert _same(mjt.decode_many(datas, output=output),
                 mjt.decode_many(datas, output=output, device="cpu"))


def test_more_streams_entry_points_on_the_card_equal_cpu(cuda, more_jpegs):
    for name in ("arith", "rgb"):
        data = more_jpegs[name]
        assert _same(mjt.decode_grayscale(data),
                     mjt.decode_grayscale(data, device="cpu"))
    for name in ("arith_trunc", "ycck", "cmyk"):
        data = more_jpegs[name]
        card = mjt.decode_cropped(data, 5, 30)
        cpu = mjt.decode_cropped(data, 5, 30, device="cpu")
        assert card[1:] == cpu[1:] and _same(card[0], cpu[0])
    data = more_jpegs["arith"]
    assert _same(list(mjt.BufferedImage(data)),
                 list(mjt.BufferedImage(data, device="cpu")))


@pytest.mark.parametrize("method", ["ifast", "float"])
def test_more_streams_idct_extremes_on_the_card_equal_cpu(cuda, method):
    """int16 extremes with 16-bit tables: ifast's int32 products wrap and
    float's sums leave int32's range before the saturating cast, on the
    card as on the CPU."""
    from mozjpeg_tpu_torch.ops import dct
    rng = np.random.default_rng(11)
    coef = rng.integers(-32768, 32768, (4, 50, 8, 8)).astype(np.int16)
    coef.reshape(-1)[:4] = [-32768, 32767, -32768, 32767]
    q = rng.integers(1, 65536, (4, 8, 8))
    q[0] = 65535
    mult = dct.ifast_multipliers if method == "ifast" \
        else dct.float_multipliers
    tbl = np.stack([mult(t) for t in q])[:, None]
    fn = dct.idct_ifast if method == "ifast" else dct.idct_float
    card = fn(torch.as_tensor(coef, device=cuda),
              torch.as_tensor(tbl, device=cuda)).cpu()
    cpu = fn(torch.as_tensor(coef), torch.as_tensor(tbl))
    assert torch.equal(card, cpu)


@pytest.mark.parametrize("m", range(1, 17))
def test_decode_scaled_on_the_card_equals_cpu(cuda, port_jpegs, more_jpegs,
                                              m):
    for data in port_jpegs + [more_jpegs[n] for n in ("arith", "rgb",
                                                       "cmyk", "ycck")]:
        for fancy in (True, False):
            assert _same(mjt.decode_scaled(data, m, 8, fancy),
                         mjt.decode_scaled(data, m, 8, fancy, device="cpu"))


@pytest.mark.parametrize("size", range(1, 17))
def test_scaled_idct_extremes_on_the_card_equal_cpu(cuda, size):
    """int16 extremes with 16-bit tables: the int32 products wrap on the
    card as on the CPU."""
    from mozjpeg_tpu_torch.codec import decoder
    rng = np.random.default_rng(12)
    zz = rng.integers(-32768, 32768, (6, 7, 64)).astype(np.int16)
    zz.reshape(-1)[:4] = [-32768, 32767, -32768, 32767]
    q = rng.integers(1, 65536, (8, 8)).astype(np.int32)
    card, cpu = (decoder.render_plane_scaled(
        torch.as_tensor(zz, device=d), torch.as_tensor(q, device=d),
        6 * size - 1, 7 * size, size).cpu() for d in (cuda, "cpu"))
    assert torch.equal(card, cpu)


def test_decode_rgb565_on_the_card_equals_cpu(cuda, port_jpegs):
    for data in port_jpegs:
        for fancy in (True, False):
            for dither in (True, False):
                assert _same(mjt.decode_rgb565(data, fancy, dither),
                             mjt.decode_rgb565(data, fancy, dither,
                                               device="cpu"))
    assert _same(mjt.decode_many(port_jpegs, output="rgb565"),
                 mjt.decode_many(port_jpegs, output="rgb565", device="cpu"))
