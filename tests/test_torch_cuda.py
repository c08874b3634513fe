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
CPU path; and sample precision: the kernel's <14, 16383> instantiation
against its plain version (the shared generator's 12-bit inputs, whose
squares wrap int32, and the 12-bit groups' launches), 12-bit encode and
decode, decode_scaled at 12 bits and lossless round trips at 8, 12 and
16 bits on the GPU's entry points against the CPU path; and the remaining
surfaces: encode_raw_yuv (4:2:0 and gray) with its AC kernel launches,
the TurboJPEG API (TJ(device="cuda") against TJ(device="cpu")) and cjpeg
and yuvjpeg's main(device="cuda") against device="cpu"; and the device
engines: the Annex-K tablegen kernel against its plain version, and
device_scanopt, deployment="local", device_entropy and the
device-tablegen trellis route on the card against the CPU path and the
host engines; and the transfer codecs: their device ops (sparse pack and
expands, plane pack and expand, the transport pack at 8 and 12 bits)
and encode_many with each codec flag on the card against the CPU, and
the remote decode routes (host render, packed with and without the plane
pack) against the card's default; and the trellis program's row scans:
the DC trellis and EOB-run DP kernels against their plain versions on
seeded, tie, all-tie (nc 1 to 9), 12-bit, tile-crossing and wide inputs,
and the eob_opt and delta-weight
encodes with one launch of each per component; and p1's two kernels
(csrc/p1.cu) against their plain versions on ops/p1.example_plane's
adversarial planes (uint8 and int32 samples, views into a host-prep
buffer at the chroma offsets, B = 1 and 8, restart intervals), the EOB
kernel on runs at its tile edges and a 12 MP plane's flags, p1_blocks
on a 12 MP image's components, a strided view at an odd offset, int32
samples whose FDCT wraps and clipped blocks, the EOB-run DP on
adversarial rows up to 1,024 blocks, and encode_many at 8 and 12 bits
with two p1 launches a component against the CPU. They skip without a GPU;
run them on one with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(tests/conftest.py imports jax, which a GPU host need not have).
"""
import numpy as np
import pytest
import torch

import mozjpeg_tpu_torch as mjt
from mozjpeg_tpu_torch.codec import marker
from mozjpeg_tpu_torch.codec import trellis as ttr
from mozjpeg_tpu_torch.ops import p1 as tp1
from mozjpeg_tpu_torch.ops import trellis_ac as tac
from mozjpeg_tpu_torch.ops import trellis_rows as trw
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


@pytest.mark.parametrize("band", [(1, 63), (1, 8), (9, 63)])
@pytest.mark.parametrize("kind,b,n_img", [
    ("sparse", 3, 1001), ("tie", 3, 1001), ("dense", 3, 1001),
    ("dense", 1, 1), ("zero", 2, 700), ("no_codes", 3, 1001)])
def test_kernel_kmax14_equals_plain(cuda, kind, b, n_img, band):
    """The <14, 16383> instantiation on 12-bit inputs: raw past 46,341
    (the squares wrap int32), qval clamped at 16383, ties at 14 bit
    lengths, ragged tiles and N = 1."""
    args = tuple(torch.as_tensor(a, device=cuda)
                 for a in ttr.ac_example_inputs(kind, b, n_img, seed=n_img,
                                                precision=12)) \
        + band + (n_img, 14, 16383)
    before = dict(tac.trellis_ac.launches_by_kmax)
    nb, ei = tac.trellis_ac(*args)
    assert tac.trellis_ac.launches_by_kmax[14] == before[14] + 1
    assert tac.trellis_ac.launches_by_kmax[10] == before[10]
    nb_p, ei_p = tac.trellis_ac_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(nb, nb_p)
    assert torch.equal(ei.view(torch.int32), ei_p.view(torch.int32))


def _photo12(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 4095.0 / w, yy * 4095.0 / h,
                    2048 + 1500 * np.sin(xx / 5.0)], -1)
    img[h // 4:h // 2, w // 4:w // 2] = 4095
    return np.clip(img + rng.normal(0, 200, img.shape), 0, 4095) \
        .astype(np.uint16)


@pytest.mark.parametrize("kw", [dict(), dict(profile=mjt.Profile.FASTEST),
                                dict(dct_method=mjt.DCTMethod.FLOAT,
                                     subsampling=(1, 1)),
                                dict(trellis_eob_opt=True,
                                     use_scans_in_trellis=True)])
def test_12_bit_encode_on_the_card_equals_cpu(cuda, kw):
    imgs = [_photo12(64, 96, 1), _photo12(64, 96, 2), _photo12(45, 77, 3)]
    cfg = mjt.EncoderConfig(quality=75, precision=12, **kw)
    card = mjt.encode_many(imgs, cfg)
    assert card == mjt.encode_many(imgs, cfg, device="cpu")
    assert mjt.encode(imgs[2], cfg) == card[2]
    gray = [im[..., 0] for im in imgs]
    assert mjt.encode_many(gray, cfg) == mjt.encode_many(gray, cfg,
                                                         device="cpu")


def test_12_bit_decode_on_the_card_equals_cpu(cuda):
    img = _photo12(64, 96, 4)
    datas = [mjt.encode(img, mjt.EncoderConfig(quality=75, precision=12,
                                               **kw), device="cpu")
             for kw in (dict(), dict(progressive=False),
                        dict(colorspace="rgb"), dict(grayscale=True))]
    for data in datas:
        for method in ("islow", "ifast", "float"):
            assert _same(mjt.decode(data, dct_method=method),
                         mjt.decode(data, dct_method=method, device="cpu"))
        assert _same(mjt.decode_grayscale(data),
                     mjt.decode_grayscale(data, device="cpu"))
        got, want = (mjt.decode_cropped(data, 17, 40),
                     mjt.decode_cropped(data, 17, 40, device="cpu"))
        assert got[1:] == want[1:] and _same(got[0], want[0])
        assert _same(list(mjt.BufferedImage(data)),
                     list(mjt.BufferedImage(data, device="cpu")))
        for m in (1, 3, 4, 8, 13, 16):
            assert _same(mjt.decode_scaled(data, m, 8),
                         mjt.decode_scaled(data, m, 8, device="cpu"))
    for output in ("rgb", "yuv", "rgb565"):
        assert _same(mjt.decode_many(datas[:2] + datas[3:], output=output),
                     mjt.decode_many(datas[:2] + datas[3:], output=output,
                                     device="cpu"))


def test_lossless_on_the_card_entry_points_equals_cpu(cuda):
    from mozjpeg_tpu_torch.codec import lossless
    rng = np.random.default_rng(7)
    for prec in (8, 12, 16):
        dt = np.uint8 if prec == 8 else np.uint16
        img = rng.integers(0, 1 << prec, (37, 53, 3)).astype(dt)
        data = lossless.encode_lossless(img, 5, 0, prec, 0, 2)
        for got in (mjt.decode(data), mjt.decode_many([data])[0]):
            assert _same(got, mjt.decode(data, device="cpu"))
            assert _same(got, img)


def _photo8(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([255 * xx / w, 255 * yy / h,
                    128 + 90 * np.sin((xx + 2 * yy) / 5.0)], -1)
    return np.clip(img + rng.normal(0, 9, img.shape), 0, 255) \
        .astype(np.uint8)


@pytest.mark.parametrize("gray", [False, True], ids=["420", "gray"])
def test_encode_raw_yuv_on_the_card_equals_cpu(cuda, gray):
    from mozjpeg_tpu_torch.codec.encoder import encode_raw_yuv
    from mozjpeg_tpu_torch.ops import color, sample
    img = _photo8(64, 96, 11)
    ycc = color.rgb_to_ycc(torch.from_numpy(img))
    if gray:
        planes, samp = [ycc[..., 0].numpy()], [(1, 1)]
    else:
        planes = [ycc[..., 0].numpy()] + [sample.downsample_h2v2(
            ycc[..., c].contiguous()).numpy() for c in (1, 2)]
        samp = [(2, 2), (1, 1), (1, 1)]
    cfg = mjt.EncoderConfig(quality=75)
    tac.reset_launches()
    card = encode_raw_yuv(planes, 96, 64, samp, cfg)
    assert tac.trellis_ac.launches_by_kmax[10] == len(planes)
    assert card == encode_raw_yuv(planes, 96, 64, samp, cfg, device="cpu")
    assert card == mjt.encode(planes[0] if gray else img, cfg,
                              device="cpu")


def test_turbojpeg_on_the_card_equals_cpu(cuda):
    from mozjpeg_tpu_torch import turbojpeg as tj
    img = _photo8(48, 64, 12)
    card, cpu = tj.TJ(device="cuda"), tj.TJ(device="cpu")
    for samp in (tj.TJSAMP_420, tj.TJSAMP_440, tj.TJSAMP_GRAY):
        for t in (card, cpu):
            t.set(tj.TJPARAM_SUBSAMP, samp)
        bgrx = np.concatenate([img[..., ::-1], img[..., :1]], -1)
        data = card.compress(bgrx, tj.TJPF_BGRX)
        assert data == cpu.compress(bgrx, tj.TJPF_BGRX)
        yuv = card.encode_yuv(img, align=4)
        assert yuv == cpu.encode_yuv(img, align=4)
        assert _same(card.decode_yuv(yuv, 64, 48, align=4),
                     cpu.decode_yuv(yuv, 64, 48, align=4))
        assert card.compress_from_yuv(yuv, 64, 48, align=4) == \
            cpu.compress_from_yuv(yuv, 64, 48, align=4)
        assert card.decompress_to_yuv(data) == cpu.decompress_to_yuv(data)
        for pf in (tj.TJPF_RGB, tj.TJPF_GRAY):
            assert _same(card.decompress(data, pf), cpu.decompress(data, pf))
    for t in (card, cpu):
        t.set_scaling_factor(1, 2)
    assert _same(card.decompress(data), cpu.decompress(data))
    assert card.transform(data, tj.TJXOP_ROT90) == \
        cpu.transform(data, tj.TJXOP_ROT90)


def test_cjpeg_and_yuvjpeg_on_the_card_equal_cpu(cuda, tmp_path):
    from mozjpeg_tpu_torch.cli import cjpeg, yuvjpeg
    img = _photo8(48, 64, 13)
    src = tmp_path / "in.ppm"
    src.write_bytes(b"P6\n64 48\n255\n" + img.tobytes())
    for flags in ([], ["-quality", "90", "-dct", "float"], ["-arithmetic"],
                  ["-revert", "-restart", "1"]):
        outs = []
        for device in ("cuda", "cpu"):
            out = tmp_path / (device + ".jpg")
            assert cjpeg.main(flags + ["-outfile", str(out), str(src)],
                              device=device) == 0
            outs.append(out.read_bytes())
        assert outs[0] == outs[1]
    yuv = tmp_path / "in.yuv"
    yuv.write_bytes(np.random.default_rng(14).integers(
        0, 256, 64 * 48 * 3 // 2, dtype=np.uint8).tobytes())
    outs = []
    for device in ("cuda", "cpu"):
        out = tmp_path / (device + ".jpg")
        assert yuvjpeg.main(["75", "64x48", str(yuv), str(out)],
                            device=device) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]


def _tablegen_cases(kind):
    """(T, 257) int32 counts: `mixed` (ties, sparse and dense histograms,
    counts of 2^20, an empty and a one-symbol histogram), `edges`
    (tablegen.edge_freqs: the live sums around 2^23 where the kernel's
    keys switch width, all 257 counts equal, sums and counts at 2^30) or
    `T=1136` (a sizes pass's batch: seeded sparse histograms)."""
    from mozjpeg_tpu_torch.ops import tablegen as tg
    if kind == "edges":
        return tg.edge_freqs()
    rng = np.random.default_rng(31 if kind == "mixed" else 32)
    t, rows, top = (70, 64, 257) if kind == "mixed" else (1136, 1136, 40)
    f = np.zeros((t, 257), np.int32)
    for i in range(rows):
        k = int(rng.integers(1, top))
        f[i, rng.choice(256, k, replace=False)] = rng.integers(
            1, int(rng.choice([2, 50, 1 << 20])), k)
    if kind == "mixed":
        f[64, :100] = 7
        f[65, ::2] = 1
        f[66, 42] = 10
        f[67, :40] = [2 ** min(i, 25) for i in range(40)]
        f[68, :8] = 1 << 26
    return f


@pytest.mark.parametrize("kind", ["mixed", "edges", "T=1136"])
def test_tablegen_kernel_equals_plain_on_the_card(cuda, kind):
    """The Annex-K kernel (csrc/tablegen.cu) against its plain version,
    with and without the code lengths, on _tablegen_cases(kind)."""
    from mozjpeg_tpu_torch.ops import tablegen as tg
    freqs = torch.as_tensor(_tablegen_cases(kind), device=cuda)
    before = tg.launches
    got = tg.gen_optimal_tables(freqs, sizes=True)
    assert tg.launches == before + 1
    bits, vals, ok = tg.gen_optimal_tables_plain(freqs)
    want = (bits, vals, ok, tg.derive_codes(bits, vals)[1])
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    if kind == "mixed":
        assert not bool(got[2][69]) and bool(got[2][66])
    for a, b in zip(tg.gen_optimal_tables(freqs), want[:3]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kw", [
    dict(device_scanopt=True), dict(deployment="local"),
    dict(device_entropy=True, progressive=False, restart_interval=5),
    dict(device_entropy=True, optimize_scans=False),
    dict(trellis_num_loops=2, device_scanopt=True)])
def test_device_engines_on_the_card_equal_cpu(cuda, kw):
    """The device engines and the device-tablegen route (one tablegen
    launch a trellis loop) on the card: the CPU path's bytes, and the
    host engines' (which the CPU tests hold equal to them)."""
    from mozjpeg_tpu_torch.codec import encoder as E
    from mozjpeg_tpu_torch.ops import tablegen as tg
    imgs = [_photo8(48, 64, 40 + i) for i in range(3)]
    cfg = mjt.EncoderConfig(quality=75, **kw)
    E.reset_host_routes()
    tg.reset_launches()
    card = mjt.encode_many(imgs, cfg)
    assert tg.launches >= cfg.trellis_num_loops
    assert card == mjt.encode_many(imgs, cfg, device="cpu")
    plain = {k: v for k, v in kw.items()
             if k not in ("device_scanopt", "device_entropy", "deployment")}
    assert card == mjt.encode_many(imgs, mjt.EncoderConfig(quality=75,
                                                           **plain))
    assert E.engine_host_routes == {"emit": 0, "search": 0}


def _codec_blocks(kind, nt=600, seed=3):
    """(nt, 64) int16 zigzag blocks: JPEG-like, all zero, one dense block
    past 48 nonzeros, or int16 extremes."""
    rng = np.random.default_rng(seed)
    a = np.zeros((nt, 64), np.int16)
    if kind == "zero":
        return a
    keep = rng.random((nt, 64)) < 0.2
    a[keep] = rng.integers(-200, 200, int(keep.sum()))
    if kind == "dense":
        a[3] = 9
    elif kind == "extremes":
        a[5], a[6] = 32767, -32768
    return a


@pytest.mark.parametrize("kind", ["random", "zero", "dense", "extremes"])
def test_transfer_codec_ops_on_the_card_equal_cpu(cuda, kind):
    """The transfer codecs' device halves on the card against the CPU:
    the sparse pack and both sparse expands, the plane pack and expand,
    the transport pack at 8 and 12 bits and three capacities."""
    from mozjpeg_tpu_torch.ops import planepack, sparsepack, transport
    a = _codec_blocks(kind)
    flat = torch.from_numpy(a.T.copy())
    for x, y in zip(sparsepack.pack_exact(flat.to(cuda)),
                    sparsepack.pack_exact(flat)):
        assert torch.equal(x.cpu(), y)
    masks, lo, esc, nt = sparsepack.pack_flat_host(a)[:4]
    up = [torch.from_numpy(v) for v in (masks, lo, esc)]
    assert torch.equal(sparsepack.expand_flat_dev(
        *(u.to(cuda) for u in up), nt).cpu(),
        sparsepack.expand_flat_dev(*up, nt))
    packed = sparsepack.pack_host(a)
    if packed is not None:
        m, v, nt, cap = packed
        m, v = torch.from_numpy(m), torch.from_numpy(v)
        assert torch.equal(sparsepack.expand_dev(m.to(cuda), v.to(cuda), nt,
                                                 cap).cpu(),
                           sparsepack.expand_dev(m, v, nt, cap))
    samples = torch.from_numpy((a.reshape(-1)[:5000] & 255).astype(np.uint8))
    nst = -(-samples.numel() // 16)
    got = planepack.pack_stream(samples.to(cuda), nst, nst * 4 + 4)
    want = planepack.pack_stream(samples, nst, nst * 4 + 4)
    for x, y in zip(got, want):
        assert torch.equal(x.cpu(), y)
    assert torch.equal(planepack.expand_stream(
        got[0], got[1], samples.numel()).cpu(), samples)
    for precision in (8, 12):
        for scap in (12, 32, 1):
            args = (2, 300, -(-600 * scap // 512) * 512, 13 * 300 + 2,
                    precision)
            for x, y in zip(transport.pack_transport(flat.to(cuda), *args),
                            transport.pack_transport(flat, *args)):
                assert torch.equal(x.cpu(), y)


@pytest.mark.parametrize("kw", [
    dict(sparse_download=True), dict(plane_pack=True),
    dict(coef_transport=True), dict(coef_transport=True, precision=12),
    dict(sparse_download=True, plane_pack=True, coef_transport=True)])
def test_transfer_codecs_on_the_card_equal_cpu(cuda, kw):
    """encode_many with each transfer codec on the card: the CPU path's
    bytes with the same flags, and the dense route's; the codec's route
    taken."""
    from mozjpeg_tpu_torch.codec import encoder as E
    twelve = kw.get("precision") == 12
    imgs = [(_photo12 if twelve else _photo8)(48, 64, 50 + i)
            for i in range(3)]
    cfg = mjt.EncoderConfig(quality=75, **kw)
    E.reset_codec_routes()
    card = mjt.encode_many(imgs, cfg)
    routes = dict(E.codec_routes)
    assert card == mjt.encode_many(imgs, cfg, device="cpu")
    dense = {k: v for k, v in kw.items() if k == "precision"}
    assert card == mjt.encode_many(imgs, mjt.EncoderConfig(quality=75,
                                                           **dense))
    if kw.get("coef_transport"):
        assert routes["transport"] == 1
    elif kw.get("sparse_download"):
        assert routes["sparse"] == 1
    assert routes["plane_pack"] == int(bool(kw.get("plane_pack")))


@pytest.mark.parametrize("env", [("1", "0"), ("0", "0"), ("0", "1")],
                         ids=["host", "packed", "packed-planepack"])
@pytest.mark.parametrize("output", ["rgb", "yuv"])
def test_remote_decode_routes_on_the_card_equal_cpu(cuda, port_jpegs,
                                                    monkeypatch, env,
                                                    output):
    """MJ_DEPLOYMENT=remote on the card: decode_many through the host
    render, or (MJ_HOST_ENGINE=0) the packed route with MJ_PLANEPACK 0
    and 1, and decode() through the host render, equal the card's
    default."""
    datas = port_jpegs * 3
    want = mjt.decode_many(datas, output=output)
    one = mjt.decode(datas[0])
    monkeypatch.setenv("MJ_DEPLOYMENT", "remote")
    monkeypatch.setenv("MJ_HOST_ENGINE", env[0])
    monkeypatch.setenv("MJ_PLANEPACK", env[1])
    assert _same(mjt.decode_many(datas, output=output), want)
    assert _same(mjt.decode(datas[0]), one)


@pytest.mark.parametrize("kind,b,bh,bw,v,q0,nc,delta_w,precision", [
    ("seeded", 8, 64, 96, 2, 8, 9, 0.0, 8),
    ("seeded", 2, 5, 7, 2, 2, 9, 0.5, 8),
    ("tie", 3, 9, 33, 2, 1, 9, 0.5, 8),
    ("seeded", 2, 7, 40, 2, 3000, 9, 0.5, 12),
    ("seeded", 2, 7, 40, 1, 1, 9, 0.0, 12),
    ("seeded", 1, 7, 3, 4, 5, 1, 1.0, 8),
    ("seeded", 1, 2, 8192, 1, 40, 3, 0.0, 8),
    ("seeded", 1, 378, 504, 2, 8, 9, 0.0, 8),
    ("tie", 1, 3, 260, 2, 1, 9, 0.5, 8),
    ("seeded", 1, 3, 33, 1, 3000, 9, 0.0, 12),
    ("seeded", 1, 3, 33, 1, 1, 9, 0.0, 12),
    ("seeded", 2, 5, 33, 2, 2, 9, 0.5, 8),
] + [("alltie", 2, 3, bw, 2, 8, nc, 0.5, 8) for nc in (1, 2, 8, 9)
     for bw in (1, 33)],
    ids=["group-luma", "odd-delta", "tie", "12bit-wrap", "12bit-clamp",
         "v4-nc1", "bw8192", "12mp-luma", "tiles-260", "12bit-wrap-bw33",
         "12bit-clamp-16383", "grad-v2-odd-bh"]
    + ["alltie-nc%d-bw%d" % (nc, bw) for nc in (1, 2, 8, 9)
       for bw in (1, 33)])
def test_dc_trellis_kernel_equals_plain_on_the_card(
        cuda, kind, b, bh, bw, v, q0, nc, delta_w, precision):
    raw, lam, si = trw.dc_example_inputs(kind, b, bh, bw, q0, precision,
                                         seed=bw)
    args = (torch.as_tensor(raw, device=cuda),
            torch.as_tensor(lam, device=cuda), q0,
            float(ttr.recip2_table()[q0]), si, nc, v, delta_w,
            ttr.kmax_maxq(precision)[1])
    before = trw.trellis_dc.launches
    got = trw.trellis_dc(*args)
    assert trw.trellis_dc.launches == before + 1
    want = trw.trellis_dc_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("b,bh,bw", [(8, 64, 96), (1, 378, 504), (3, 4, 70),
                                     (2, 5, 1), (1, 4, 8192)])
def test_eob_dp_kernel_equals_plain_on_the_card(cuda, b, bh, bw):
    ei, si = trw.eob_example_inputs(bw, b, bh, bw)
    args = (torch.as_tensor(ei, device=cuda), torch.as_tensor(si, device=cuda),
            bh, bw)
    before = trw.eob_dp.launches
    got = trw.eob_dp(*args)
    assert trw.eob_dp.launches == before + 1
    want = trw.eob_dp_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_row_scans_launch_once_per_component_on_the_card(cuda):
    """encode_many with trellis_eob_opt and the delta weight: one DC launch
    a component, one EOB launch a component and band, the CPU's bytes."""
    imgs = _images(3)
    cfg = mjt.EncoderConfig(quality=75, trellis_eob_opt=True,
                            trellis_delta_dc_weight=0.5)
    mjt.encode_many(imgs, cfg)
    trw.reset_launches()
    got = mjt.encode_many(imgs, cfg)
    torch.cuda.synchronize()
    assert trw.trellis_dc.launches == trw.eob_dp.launches
    assert trw.trellis_dc.launches % 3 == 0 and trw.trellis_dc.launches > 0
    assert got == mjt.encode_many(imgs, cfg, device="cpu")


def _p1_buffer(b, precision, geoms, seed):
    """A (B, total) host-prep style buffer of example planes, back to back,
    and each plane's (offset, bh, bw, ph, pw)."""
    parts, where, off = [], [], 0
    for i, (bh, bw, ph, pw) in enumerate(geoms):
        p = tp1.example_plane(b, bh, bw, precision, seed + i, ph, pw)
        parts.append(p.reshape(b, -1))
        where.append((off, bh, bw, p.shape[1], p.shape[2]))
        off += p.shape[1] * p.shape[2]
    return np.concatenate(parts, 1), where


@pytest.mark.parametrize("precision,b,dering", [
    (8, 1, True), (8, 8, True), (8, 8, False), (12, 1, True), (12, 8, False),
    (12, 8, True)])
def test_p1_kernels_equal_plain_on_the_card(cuda, precision, b, dering):
    """p1_blocks on views into one buffer (a luma plane, then two chroma
    planes at their offsets, one wider than its blocks), a channel view
    with a column stride, and p1_eob_hist at restart intervals 0, 1, 5,
    n - 1, n and n + 3, each exactly against its plain version."""
    geoms = [(21, 33, 0, 0), (11, 17, 0, 0), (11, 17, 96, 152)]
    buf, where = _p1_buffer(b, precision, geoms, 3 * b + precision)
    buf_t = torch.as_tensor(buf, device=cuda)
    qt = np.random.default_rng(b).integers(1, 40, 64).astype(np.int32)
    qt[0] = 3
    views = [buf_t[:, off:off + ph * pw].reshape(b, ph, pw)
             for off, bh, bw, ph, pw in where]
    rgb = torch.as_tensor(np.stack([tp1.example_plane(
        b, 9, 13, precision, 9)] * 3, -1), device=cuda)
    cases = [(v, bh, bw) for v, (_, bh, bw, _, _) in zip(views, where)]
    cases.append((rgb[..., 1], 9, 13))
    for plane, bh, bw in cases:
        before = tp1.p1_blocks.launches
        got = tp1.p1_blocks(plane, bh, bw, qt, dering, precision)
        assert tp1.p1_blocks.launches == before + 1
        want = tp1.p1_blocks_plain(plane, bh, bw, qt, dering, precision)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
        n = bh * bw
        for ri in (0, 1, 5, n - 1, n, n + 3):
            before = tp1.p1_eob_hist.launches
            h = tp1.p1_eob_hist(got[4], got[3].clone(), b, ri)
            assert tp1.p1_eob_hist.launches == before + 1
            torch.cuda.synchronize()
            assert torch.equal(h, tp1.p1_eob_hist_plain(
                want[4], want[3].clone(), b, ri))


def test_p1_eob_kernel_past_0x7fff_on_the_card(cuda):
    """Segments of more than 0x7FFF blocks: all zero, one nonzero block in
    each of two images with runs past the forced flush between them."""
    n = 0x7FFF + 5000
    flags = np.full(3 * n, 2, np.uint8)
    flags[n + 3] = 3
    flags[n + 3 + 0x7FFF + 10] = 1
    flags[2 * n + 40:2 * n + 50] = 1
    f = torch.as_tensor(flags, device=cuda)
    for ri in (0, 33, 0x7FFF, n - 1):
        h = tp1.p1_eob_hist(f, torch.zeros((3, 256), dtype=torch.int32,
                                           device=cuda), 3, ri)
        want = tp1.p1_eob_hist_plain(f, torch.zeros(
            (3, 256), dtype=torch.int32, device=cuda), 3, ri)
        torch.cuda.synchronize()
        assert torch.equal(h, want)


@pytest.mark.parametrize("ri", [0, 1, 5, tp1.EOB_TILE - 1, tp1.EOB_TILE,
                                tp1.EOB_TILE + 1, tp1.EDGE_N - 1,
                                tp1.EDGE_N, tp1.EDGE_N + 3])
def test_p1_eob_kernel_at_tile_edges_on_the_card(cuda, ri):
    """The tiled EOB kernel on ops/p1.edge_flags (runs ending beside and
    on tile edges, one nonzero block, an all-zero image) at each restart
    interval, exactly against its plain version."""
    f = torch.as_tensor(tp1.edge_flags(17).reshape(-1), device=cuda)
    zero = torch.zeros((6, 256), dtype=torch.int32, device=cuda)
    before = tp1.p1_eob_hist.launches
    h = tp1.p1_eob_hist(f, zero.clone(), 6, ri)
    assert tp1.p1_eob_hist.launches == before + 1
    want = tp1.p1_eob_hist_plain(f, zero.clone(), 6, ri)
    torch.cuda.synchronize()
    assert torch.equal(h, want)


@pytest.mark.parametrize("ri", [0, 504, 0x7FFF])
def test_p1_eob_kernel_12mp_on_the_card(cuda, ri):
    """One 12 MP luma plane's flags (190,512 blocks: 745 tiles, so that
    the combine runs over three blocks of 256 tiles), three images, and
    the same launch twice (the counters back at 0 after each)."""
    rng = np.random.default_rng(ri)
    n = 378 * 504
    flags = np.where(rng.random(3 * n) < 0.05,
                     rng.choice([1, 3], 3 * n), 2).astype(np.uint8)
    flags[n:n + 40000] = 2                   # a run past 0x7FFF
    f = torch.as_tensor(flags, device=cuda)
    want = tp1.p1_eob_hist_plain(f, torch.zeros(
        (3, 256), dtype=torch.int32, device=cuda), 3, ri)
    for _ in range(2):
        h = tp1.p1_eob_hist(f, torch.zeros((3, 256), dtype=torch.int32,
                                           device=cuda), 3, ri)
        torch.cuda.synchronize()
        assert torch.equal(h, want)


def _p1_equal(plane, bh, bw, qt, dering, precision):
    """One p1_blocks launch against its plain version, every output."""
    before = tp1.p1_blocks.launches
    got = tp1.p1_blocks(plane, bh, bw, qt, dering, precision)
    assert tp1.p1_blocks.launches == before + 1
    want = tp1.p1_blocks_plain(plane, bh, bw, qt, dering, precision)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("precision", [8, 12])
def test_p1_blocks_12mp_components_on_the_card(cuda, precision):
    """p1_blocks on a 4032x3024 image's three components (4:2:0: 378 x
    504 luma blocks, 189 x 252 chroma), deringing on."""
    qt = np.random.default_rng(precision).integers(1, 60, 64).astype(np.int32)
    for i, (bh, bw) in enumerate(((378, 504), (189, 252), (189, 252))):
        plane = torch.as_tensor(tp1.example_plane(1, bh, bw, precision,
                                                  40 + i), device=cuda)
        _p1_equal(plane, bh, bw, qt, True, precision)


@pytest.mark.parametrize("precision", [8, 12])
def test_p1_blocks_strided_unaligned_view_on_the_card(cuda, precision):
    """A plane view with a column stride of 3 at an odd element offset,
    and a row view at an odd offset (contiguous columns, rows that no
    vector load may take)."""
    p = tp1.example_plane(2, 5, 9, precision, 11, 41, 3 * 73 + 1)
    flat = torch.as_tensor(p, device=cuda)
    strided = flat[:, 1:, 1::3]
    assert strided.stride(2) == 3
    _p1_equal(strided, 5, 9, np.arange(1, 65, dtype=np.int32), True,
              precision)
    buf = torch.as_tensor(tp1.example_plane(1, 6, 9, precision, 12, 48, 80)
                          .reshape(-1), device=cuda)
    odd = buf[3:3 + 47 * 79].reshape(1, 47, 79)
    _p1_equal(odd, 5, 9, np.full(64, 7, np.int32), True, precision)


@pytest.mark.parametrize("q", [1, 65535, 0], ids=["q1", "q65535", "q1-64"])
@pytest.mark.parametrize("precision", [8, 12])
def test_p1_blocks_int32_wrap_on_the_card(cuda, precision, q):
    """int32 samples whose FDCT wraps int32 (ops/p1.adversarial_plane
    "wrap": the DC at -2^30, the largest |c| the FDCT gives), deringing
    off, with quant values 1, 65535 and 1..64."""
    qt = (np.full(64, q, np.int32) if q else
          np.arange(1, 65, dtype=np.int32))
    plane = torch.as_tensor(tp1.adversarial_plane("wrap", 3, 4, 10,
                                                  precision, 5), device=cuda)
    _p1_equal(plane, 4, 10, qt, False, precision)


@pytest.mark.parametrize("precision", [8, 12])
def test_p1_blocks_clipped_blocks_on_the_card(cuda, precision):
    """Deringing on all-clipped, half-clipped (even zigzag positions) and
    top-half-clipped blocks (ops/p1.adversarial_plane "clipped")."""
    plane = torch.as_tensor(tp1.adversarial_plane("clipped", 2, 6, 11,
                                                  precision, 6), device=cuda)
    for q0 in (1, 5, 40):
        qt = np.full(64, 3, np.int32)
        qt[0] = q0
        _p1_equal(plane, 6, 11, qt, True, precision)


@pytest.mark.parametrize("bw", [1, 31, 32, 33, 96, 504, 513, 1024])
def test_eob_dp_kernel_adversarial_rows_on_the_card(cuda, bw):
    """The EOB-run DP on rows of every cost tied, all zero, every other
    block all zero, keep-heavy and seeded (trellis_rows.eob_example_inputs
    "adversarial"), at row lengths around a warp, the group's luma, a 12
    MP luma row, past the registers' 512 steps and at 1,024."""
    ei, si = trw.eob_example_inputs(bw, 2, 5, bw, "adversarial")
    args = (torch.as_tensor(ei, device=cuda), torch.as_tensor(si, device=cuda),
            5, bw)
    before = trw.eob_dp.launches
    got = trw.eob_dp(*args)
    assert trw.eob_dp.launches == before + 1
    want = trw.eob_dp_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("precision", [8, 12])
def test_p1_launches_twice_per_component_on_the_card(cuda, precision):
    """encode_many at 8 bits (host prep) and 12 bits (device prep): two p1
    launches a component and group, and the CPU's bytes."""
    if precision == 8:
        imgs = _images(3)
    else:
        imgs = [_photo12(64, 96, 1), _photo12(64, 96, 2)]
    cfg = mjt.EncoderConfig(quality=75, precision=precision)
    mjt.encode_many(imgs, cfg)
    tp1.reset_launches()
    got = mjt.encode_many(imgs, cfg)
    torch.cuda.synchronize()
    assert tp1.p1_blocks.launches == tp1.p1_eob_hist.launches
    assert tp1.p1_blocks.launches % 3 == 0 and tp1.p1_blocks.launches > 0
    assert got == mjt.encode_many(imgs, cfg, device="cpu")
