"""The port's multi-device encode (mozjpeg_tpu_torch/parallel/) on an
eight-entry CPU mesh, as the JAX tests run eight virtual CPU devices.

  * against the JAX package: each one-process sharded encoder (the four
    row-sharded ones on an unaligned height, encode_batch with and
    without device entropy) byte-equal to mozjpeg_tpu.parallel's; each
    JAX program compiled once, on a two-device mesh (by the byte-exact
    contract the bytes do not depend on the shard count);
  * against the port's single-device encode with the same restart
    configuration (itself held to the JAX package): every case of
    tests/test_parallel.py's TestRowSharded* classes on seeded synthetic
    images, the samplings, restart_rows 2 and 3, the (1, 2) refusal and
    the 1920x1080 remainder rows;
  * the new ops (the sequential histograms, the dummy blocks) and the
    AC-first / AC-refinement counts the sharded scans take from
    ops/bitpack.py, against the JAX functions;
  * the dry run, and encode_many's routing of huge singles (_route_rows).
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mozjpeg_tpu_torch as mjt
from mozjpeg_tpu.ops import bitpack as jbitpack
from mozjpeg_tpu.ops import layout as jlayout
from mozjpeg_tpu.ops import symbols as jsym
from mozjpeg_tpu.parallel import batch as jbatch
from mozjpeg_tpu.parallel import rows as jrows
from mozjpeg_tpu_torch.codec.config import EncoderConfig, Profile
from mozjpeg_tpu_torch.ops import bitpack, layout, symbols
from mozjpeg_tpu_torch.parallel import batch as pbatch
from mozjpeg_tpu_torch.parallel import dryrun
from mozjpeg_tpu_torch.parallel import rows as prows

MESH = pbatch.make_mesh(["cpu"] * 8)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _img(h, w, seed, k=(3, 1, 1, 2, 2, 5), noise=8):
    """tests/test_parallel.py's synthetic images: three linear ramps mod
    256 plus seeded uniform noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    im = np.stack([(yy * k[0] + xx * k[1]) % 256,
                   (yy * k[2] + xx * k[3]) % 256,
                   (yy * k[4] + xx * k[5]) % 256], -1)
    return np.clip(im + rng.integers(-noise, noise, im.shape), 0,
                   255).astype(np.uint8)


# the JAX oracle's geometry: 56 rows = 3.5 iMCU rows (padded to 4)
ORACLE = _img(56, 48, 21)
BATCH = np.stack([_img(32, 48, 30 + i) for i in range(8)])
ENCODERS = {"baseline": prows.encode_row_sharded,
            "trellis": prows.encode_row_sharded_trellis,
            "progressive": prows.encode_row_sharded_progressive,
            "scanopt": prows.encode_row_sharded_scanopt}


@pytest.fixture(scope="module")
def jax_bytes():
    """The JAX package's bytes of every one-process sharded encoder on
    the oracle inputs, and the seconds it took."""
    mesh = jbatch.make_mesh(jax.devices()[:2])
    t0 = time.perf_counter()
    out = {name: getattr(jrows, fn.__name__)(ORACLE, 75.0, mesh=mesh,
                                             restart_rows=1)
           for name, fn in ENCODERS.items()}
    for de in (False, True):
        out["batch", de] = jbatch.encode_batch(BATCH, 75.0, mesh=mesh,
                                               device_entropy=de)
    out["seconds"] = time.perf_counter() - t0
    print("JAX sharded programs: %.1f s" % out["seconds"])
    return out


@pytest.mark.parametrize("name", list(ENCODERS))
def test_rows_vs_jax(jax_bytes, name):
    assert ENCODERS[name](ORACLE, 75.0, MESH, restart_rows=1) \
        == jax_bytes[name]


@pytest.mark.parametrize("device_entropy", [False, True])
def test_batch_vs_jax(jax_bytes, device_entropy):
    got = pbatch.encode_batch(BATCH, 75.0, MESH,
                              device_entropy=device_entropy)
    assert got == jax_bytes["batch", device_entropy]


# ---------------------------------------------------------------------------
# against the port's single-device encoder
# ---------------------------------------------------------------------------

def _single(im, kind, q, rr, subsampling=(2, 2)):
    base = dict(quality=q, restart_in_rows=rr, subsampling=subsampling)
    kw = {"baseline": dict(profile=Profile.FASTEST, progressive=False,
                           optimize_coding=True, optimize_scans=False,
                           trellis_quant=False, overshoot_deringing=False),
          "trellis": dict(progressive=False, optimize_scans=False,
                          trellis_quant=True, overshoot_deringing=True,
                          optimize_coding=True),
          "progressive": dict(progressive=True, optimize_scans=False,
                              trellis_quant=True, overshoot_deringing=True,
                              optimize_coding=True),
          "scanopt": {}}[kind]
    return mjt.encode(im, EncoderConfig(**base, **kw), device="cpu")


def _sharded(im, kind, q, rr, subsampling=(2, 2)):
    return ENCODERS[kind](im, q, MESH, restart_rows=rr,
                          subsampling=subsampling)


@pytest.mark.parametrize("kind,h,w,q,rr,seed,k", [
    # TestRowSharded: 16 iMCU rows over 8 shards; odd height (dummy rows
    # and the chroma row fix); restart every 2 rows with dummy columns;
    # an even but unaligned height (chroma padding)
    ("baseline", 256, 256, 75, 1, 3, (3, 1, 1, 2, 2, 5)),
    ("baseline", 250, 200, 85, 1, 3, (3, 1, 1, 2, 2, 5)),
    ("baseline", 256, 100, 75, 2, 3, (3, 1, 1, 2, 2, 5)),
    ("baseline", 244, 333, 60, 1, 3, (3, 1, 1, 2, 2, 5)),
    # TestRowShardedTrellis: odd dimensions (dummy rows and columns and
    # the statistics' fake-row correction), restart_rows 2
    ("trellis", 256, 256, 75, 1, 5, (2, 1, 1, 3, 5, 2)),
    ("trellis", 250, 201, 85, 1, 5, (2, 1, 1, 3, 5, 2)),
    ("trellis", 128, 160, 60, 2, 5, (2, 1, 1, 3, 5, 2)),
    ("progressive", 256, 224, 75, 1, 11, (1, 2, 3, 1, 2, 7)),
    ("progressive", 250, 201, 85, 1, 11, (1, 2, 3, 1, 2, 7)),
    ("scanopt", 256, 224, 75, 1, 13, (2, 3, 1, 1, 4, 5)),
    ("scanopt", 250, 201, 80, 2, 13, (2, 3, 1, 1, 4, 5)),
])
def test_rows_vs_single_device(kind, h, w, q, rr, seed, k):
    im = _img(h, w, seed, k, noise=8 if kind == "baseline" else 6)
    assert _sharded(im, kind, q, rr) == _single(im, kind, q, rr)


def test_rows_decodes():
    """A q90 row-sharded stream decodes (the port's decoder) close to its
    source."""
    yy, xx = np.mgrid[0:128, 0:160]
    im = np.repeat((((yy + xx) // 2) % 256).astype(np.uint8)[..., None], 3,
                   -1)
    dec = mjt.decode(prows.encode_row_sharded(im, 90.0, MESH),
                     device="cpu")
    assert dec.shape == im.shape
    assert np.abs(dec.astype(int) - im.astype(int)).mean() < 6.0


@pytest.mark.parametrize("kind,samp", [
    ("baseline", (2, 1)), ("baseline", (1, 1)), ("baseline", "gray"),
    ("trellis", (2, 1)), ("trellis", "gray"),
    ("progressive", (1, 1)), ("progressive", "gray"),
])
def test_rows_samplings(kind, samp):
    """4:2:2, 4:4:4 and grayscale (a 2-D image)."""
    yy, xx = np.mgrid[0:200, 0:173]
    im = np.stack([(yy + xx) % 256, (yy * 2 + xx) % 256,
                   (yy + xx * 3) % 256], -1).astype(np.uint8)
    sp = (2, 2) if samp == "gray" else samp
    if samp == "gray":
        im = im[..., 0]
    assert _sharded(im, kind, 78, 1, sp) == _single(im, kind, 78, 1, sp)


def test_rows_unaligned_restart_and_stats_segments():
    """restart_rows 2 with dummy rows sharing a statistics segment with
    real rows (odd real bh); restart_rows 3, which does not divide the
    iMCU rows, falls back to one shard; sampling (1, 2) is refused."""
    yy, xx = np.mgrid[0:248, 0:160]
    im = np.stack([(yy + xx) % 256] * 3, -1).astype(np.uint8)
    assert _sharded(im, "trellis", 75, 2) == _single(im, "trellis", 75, 2)
    assert prows._rows_mesh(MESH, 16, 3).size == 1
    assert _sharded(im[:256], "baseline", 75, 3) \
        == _single(im[:256], "baseline", 75, 3)
    with pytest.raises(NotImplementedError):
        prows.encode_row_sharded(im, mesh=MESH, subsampling=(1, 2))


def _photo(h, w, seed):
    """A seeded photo-like image: gradients, a hard edge, noise."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([255 * xx / w, 255 * yy / h,
                    128 + 90 * np.sin((xx + 2 * yy) / 5.0)], -1)
    img[: h // 2, w // 2:] = r.uniform(0, 255, 3)
    img += r.normal(0, 9, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("kind", ["baseline", "progressive"])
def test_rows_kodak_size(kind):
    """TestRowShardedRealSizes at 768x512 (32 iMCU rows over 8 shards):
    baseline, and the progressive script with the AC/DC trellis."""
    im = _photo(512, 768, 60)
    assert _sharded(im, kind, 75, 1) == _single(im, kind, 75, 1)


def test_rows_hd_remainder_rows():
    """1920x1080: 67.5 iMCU rows padded to 68, and 68 % 8 != 0, so the
    mesh shrinks to 4 shards of 17 rows."""
    im = _photo(1080, 1920, 61)
    assert prows._rows_mesh(MESH, 68).size == 4
    assert _sharded(im, "baseline", 80, 1) == _single(im, "baseline", 80, 1)


# ---------------------------------------------------------------------------
# the ops, against the JAX functions
# ---------------------------------------------------------------------------

def _coefs(shape, seed, density=0.15, hi=40):
    """Sparse zigzag coefficients, large and small, int16."""
    r = np.random.default_rng(seed)
    v = r.integers(-hi, hi + 1, shape) * (r.random(shape) < density)
    v[..., 0] = r.integers(-300, 300, shape[:-1])
    return v.astype(np.int16)


def test_ac_histogram_vs_jax():
    zz = _coefs((777, 64), 1)
    zz[:5, 1:] = 0                      # all-zero AC blocks
    zz[5:9, 63] = 3                     # no EOB
    zz[9, 1:] = 0
    zz[9, 40] = 1                       # a run over 16 (ZRLs)
    want = np.asarray(jsym.ac_histogram(jnp.asarray(zz)))
    got = symbols.ac_histogram(torch.from_numpy(zz)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,v,mx,my,r,al", [
    (2, 2, 5, 3, 2, 0), (1, 1, 7, 4, 3, 1), (2, 1, 4, 3, 1, 2)])
def test_dc_histograms_vs_jax(h, v, mx, my, r, al):
    plane = _coefs((my * v, mx * h, 64), 2 + al)
    want = np.asarray(jsym.dc_histogram_restart(jnp.asarray(plane), h, v,
                                                mx, my, r, Al=al))
    got = symbols.dc_histogram_restart(torch.from_numpy(plane), h, v, mx,
                                       my, r, Al=al).numpy()
    np.testing.assert_array_equal(got, want)
    want = np.asarray(jsym.dc_histogram_interleaved(jnp.asarray(plane), h,
                                                    v, mx, my))
    got = symbols.dc_histogram_interleaved(torch.from_numpy(plane), h, v,
                                           mx, my).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ss,se,al,ri", [(1, 8, 2, 0)])
def test_ac_first_counts_vs_jax(ss, se, al, ri):
    """The sharded AC-first gather (bitpack.AcFirst.hist over a Band of
    the shard's real blocks) equals the JAX ac_first_histogram_t (with
    restart segments, the JAX compile alone takes about 10 s; the
    sharded encoders' byte tests cover them)."""
    bh, bw = 6, 9
    plane = _coefs((bh + 1, bw + 2, 64), 3, density=0.08)
    zz = plane[:bh, :bw].reshape(-1, 64).T
    want = np.asarray(jsym.ac_first_histogram_t(jnp.asarray(zz), ss, se,
                                                ri=ri, Al=al))
    n = bh * bw
    r = ri or n
    band = bitpack.Band(torch.from_numpy(plane), bh, bw, ss, se,
                        -(-n // r) * r)
    got = bitpack.AcFirst(band, al, r).hist().sum(0).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ss,se,al,ri", [(1, 63, 0, 9), (1, 63, 1, 0),
                                         (6, 20, 1, 5)])
def test_ac_refine_counts_vs_jax(ss, se, al, ri):
    """The sharded AC-refinement gather (bitpack.AcRefine.hist) equals
    the JAX ac_refine_histogram_parts_t plus its EOBn bins
    (ac_refine_eob_bins over the flush schedule)."""
    bh, bw = 5, 8
    plane = _coefs((bh, bw + 1, 64), 4, density=0.3, hi=6)
    zz = plane[:, :bw].reshape(-1, 64).T
    hs, e, br, ev = jsym.ac_refine_histogram_parts_t(jnp.asarray(zz), ss,
                                                     se, al)
    want = np.asarray(hs).astype(np.int64) + jbitpack.ac_refine_eob_bins(
        np.asarray(e), np.asarray(br), np.asarray(ev), ri)
    n = bh * bw
    r = ri or n
    band = bitpack.Band(torch.from_numpy(plane), bh, bw, ss, se,
                        -(-n // r) * r)
    got = bitpack.AcRefine(band, al, r).hist().sum(0).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rbh,rbw,h,v", [(5, 7, 2, 2), (4, 6, 1, 1),
                                         (3, 5, 2, 1), (6, 8, 2, 2)])
def test_dummy_blocks_vs_jax(rbh, rbw, h, v):
    bh, bw = -(-rbh // v) * v, -(-rbw // h) * h
    zz = _coefs((bh, bw, 64), 5)
    want = np.asarray(jlayout.add_dummy_blocks(jnp.asarray(zz), rbw, rbh,
                                               h, v))
    got = layout.add_dummy_blocks(torch.from_numpy(zz), rbw, rbh, h,
                                  v).numpy()
    np.testing.assert_array_equal(got, want)
    zt = zz[:rbh, :rbw].reshape(-1, 64).T.copy()
    want = np.asarray(jlayout.add_dummy_blocks_t(jnp.asarray(zt), rbw, rbh,
                                                 bw, bh, h, v))
    got = layout.add_dummy_blocks_t(torch.from_numpy(zt), rbw, rbh, bw, bh,
                                    h, v).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the dry run and the routing
# ---------------------------------------------------------------------------

def test_dryrun_entrypoints():
    fn, args = dryrun.entry(device="cpu")
    out = fn(*args)
    assert tuple(out[0].shape) == (1, 32, 32, 64)
    dryrun.dryrun_multichip(8, device="cpu")


@pytest.fixture
def spy(monkeypatch):
    """Counts the calls of rows.encode_row_sharded_scanopt."""
    calls = []
    real = prows.encode_row_sharded_scanopt

    def counted(*a, **kw):
        calls.append(kw.get("mesh", a[2] if len(a) > 2 else None))
        return real(*a, **kw)
    monkeypatch.setattr(prows, "encode_row_sharded_scanopt", counted)
    monkeypatch.setenv("MJ_BATCH_MAX_MP", "0.001")     # 1,000 pixels
    return calls


def test_route_rows_taken(jax_bytes, spy, monkeypatch):
    """An RGB image over MJ_BATCH_MAX_MP in the rows profile with two
    devices takes the row sharding, every image of its shape, with the
    JAX package's bytes."""
    monkeypatch.setattr(pbatch, "device_count", lambda dev: 2)
    cfg = mjt.EncoderConfig(quality=75, restart_in_rows=1)
    out = mjt.encode_many([ORACLE, ORACLE[::-1].copy()], cfg, device="cpu")
    assert len(spy) == 2 and spy[0].devices == (torch.device("cpu"),) * 2
    assert out[0] == jax_bytes["scanopt"]
    assert out[1] == _single(ORACLE[::-1].copy(), "scanopt", 75, 1)


def test_route_rows_not_taken(jax_bytes, spy, monkeypatch):
    """No route for a config other than the rows profile, nor on one
    device: the CPU's per-image route (MJ_HOST_ENGINE=0) gives the same
    bytes as the sharding."""
    one = pbatch.device_count
    monkeypatch.setattr(pbatch, "device_count", lambda dev: 2)
    out = mjt.encode_many([ORACLE], mjt.EncoderConfig(quality=75),
                          device="cpu")
    assert not spy and out[0][:2] == b"\xff\xd8"
    monkeypatch.setattr(pbatch, "device_count", one)
    monkeypatch.setenv("MJ_HOST_ENGINE", "0")
    assert pbatch.device_count(torch.device("cpu")) == 1
    cfg = mjt.EncoderConfig(quality=75, restart_in_rows=1)
    assert mjt.encode_many([ORACLE], cfg, device="cpu") \
        == [jax_bytes["scanopt"]]
    assert not spy
