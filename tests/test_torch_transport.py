"""The port's coefficient transport (ops/transport.py) and the transfer
codecs' encode routes on the CPU equal the JAX package's: the transport's
tables at 8 and 12 bits, its words and header bit for bit against the
JAX _pack_transport (random, all-zero, a block past CAPR nonzeros, int16
and 12-bit extremes; the default capacity, the retry's 32 and 1), the
fetch (its speculative bucket and the exact second transfer) and the
native decode back to the planes; MJ_TRANSPORT_SCAP and the codec
switches; the encoder's download chain reaching each of its routes on
crafted planes (the transport, its repack at capacity 32, the sparse
pack after both overflow, the dense planes after all three); and
encode_many's bytes
with sparse_download, plane_pack and coef_transport, alone and
together, at 8 and 12 bits, against mozjpeg_tpu.encode_many with the
same flags (one module's JAX compiles serve every flag: about 25 s at
each precision)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mozjpeg_tpu as mj
import mozjpeg_tpu_torch as mjt
from mozjpeg_tpu.codec.pipeline import CompGeom
from mozjpeg_tpu.ops import transport as jtr
from mozjpeg_tpu_torch.codec import encoder as tenc
from mozjpeg_tpu_torch.ops import transport as ttr
from mozjpeg_tpu_torch.utils import xfer
from test_torch_decode import _photo
from test_torch_encode12 import photo12
from test_torch_sparsepack import KINDS, planes


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("precision", [8, 12])
def test_tables_equal_jax(precision):
    for t, j in zip(ttr._tables(precision), jtr._tables(precision)):
        np.testing.assert_array_equal(t.bits, j.bits)
        np.testing.assert_array_equal(t.vals, j.vals)
    for t, j in zip(ttr._dec_tables(precision), jtr._dec_tables(precision)):
        for x, y in zip(t, j):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("scap", [12, 32, 1])
@pytest.mark.parametrize("precision", [8, 12])
@pytest.mark.parametrize("kind", KINDS)
def test_pack_transport_equals_jax(kind, precision, scap):
    a = planes(kind)
    b, n_tot = 2, a.shape[0] // 2
    captot = -(-a.shape[0] * scap // 512) * 512
    capw = 13 * n_tot + 2
    wj, hj = jtr._pack_transport(jnp.asarray(a.T.copy()), b, n_tot, captot,
                                 capw, precision)
    wt, ht = ttr.pack_transport(torch.from_numpy(a.T.copy()), b, n_tot,
                                captot, capw, precision)
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    np.testing.assert_array_equal(wt.numpy().view(np.uint32), np.asarray(wj))


COMPS = [CompGeom(2, 2, 32, 32, 4, 4, 4, 4), CompGeom(1, 1, 16, 16, 2, 2,
                                                      2, 2),
         CompGeom(1, 1, 16, 16, 2, 2, 2, 2)]
N_TOT = sum(g.bh * g.bw for g in COMPS)


def _finals(a: np.ndarray, b: int):
    """(b * N_TOT, 64) blocks in the transport's order -> per component
    (64, b * n_c) planes."""
    a = a.reshape(b, N_TOT, 64)
    out, off = [], 0
    for g in COMPS:
        n = g.bh * g.bw
        out.append(torch.from_numpy(np.ascontiguousarray(
            a[:, off:off + n].transpose(2, 0, 1).reshape(64, -1))))
        off += n
    return out


def _blocks(images) -> np.ndarray:
    return np.concatenate([np.concatenate([p.reshape(-1, 64) for p in im])
                           for im in images])


def _sparse8(seed, k_max, b=2):
    """b images of JPEG-like 8-bit blocks, up to k_max nonzeros each."""
    a = planes("random", b * N_TOT, seed)
    keep = np.random.default_rng(seed).random(a.shape) < k_max / 20
    return np.clip(a * keep, -1023, 1023).astype(np.int16)


@pytest.mark.parametrize("precision", [8, 12])
def test_fetch_and_decode_round_trip(precision):
    """pack_batch -> fetch -> decode_to_planes gives the blocks back and
    the JAX package's fetched words."""
    b = 2
    a = _sparse8(3, 6)
    if precision == 12:
        a[::7, 0] = 16000
        a[1::5, 9] = -4000
    fin = _finals(a, b)
    got = ttr.fetch(ttr.pack_batch(fin, b, precision=precision))
    want = jtr.fetch(jtr.pack_batch(tuple(jnp.asarray(f.numpy())
                                          for f in fin), COMPS, b,
                                    precision=precision))
    assert got is not None and want is not None
    need = int(got[1].max() + 31) // 32
    np.testing.assert_array_equal(got[0][:, :need], want[0][:, :need])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(
        _blocks(ttr.decode_to_planes(*got, b, COMPS, precision)), a)


def test_fetch_speculative_undershoot():
    """An estimate short of the words (a first bucket of TRIM_STEP words
    below them) takes the exact second transfer, as in the JAX package."""
    comps = [CompGeom(1, 1, 256, 256, 32, 32, 32, 32)]
    a = np.zeros((1024, 64), np.int16)
    a[:, 1:21] = np.random.default_rng(6).choice([-100, 100], (1024, 20))
    fin = [torch.from_numpy(a.T.copy())]
    jfin = (jnp.asarray(a.T.copy()),)
    ttr._EST_WORDS[1024] = jtr._EST_WORDS[1024] = 1
    snap = xfer.snapshot()
    got = ttr.fetch(ttr.pack_batch(fin, 1, scap=32))
    want = jtr.fetch(jtr.pack_batch(jfin, comps, 1, scap=32))
    need = int(got[1][0] + 31) // 32
    assert ttr.TRIM_STEP < need == ttr._EST_WORDS[1024] < 13 * 1024 + 2
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    # the header and one bucket, then the words again in two buckets
    # (clipped to the stream's capacity)
    assert xfer.delta(snap)[1] == 4 * (3 + ttr.TRIM_STEP + min(
        13 * 1024 + 2, 2 * ttr.TRIM_STEP))
    np.testing.assert_array_equal(
        _blocks(ttr.decode_to_planes(*got, 1, comps)), a)


def test_scap_from_the_environment(monkeypatch):
    a = _sparse8(5, 16)
    fin = _finals(a, 2)
    for scap in ("12", "32"):
        monkeypatch.setenv("MJ_TRANSPORT_SCAP", scap)
        assert ttr._scap() == jtr._scap() == int(scap)
        _, h, _, _ = ttr.pack_batch(fin, 2)
        _, hj, _, _ = jtr.pack_batch(tuple(jnp.asarray(f.numpy())
                                           for f in fin), COMPS, 2)
        np.testing.assert_array_equal(h.numpy(), np.asarray(hj))


def _chain_input(route: str) -> np.ndarray:
    """Blocks of two images on which the download chain ends at `route`."""
    if route == "transport":                   # few symbols a block
        return _sparse8(7, 4)
    if route == "transport_scap32":            # 12-32 symbols a block
        a = np.zeros((2 * N_TOT, 64), np.int16)
        a[:, 1:21] = np.random.default_rng(8).integers(1, 30,
                                                       (2 * N_TOT, 20))
        return a
    a = np.zeros((2 * N_TOT, 64), np.int16)
    if route == "sparse":
        # image 0 past its stream's words (capw), image 1 empty: the
        # transport overflows at both capacities, the sparse pack's
        # group-wide capacities hold
        a[:N_TOT, 0:61:2] = np.random.default_rng(9).integers(
            100, 128, (N_TOT, 31))                 # (1, 7) symbols: 23 bits
        return a
    a[5] = 9                                   # 64 nonzeros: all overflow
    return a


@pytest.mark.parametrize("route", ["transport", "transport_scap32",
                                   "sparse", "dense"])
def test_download_chain_reaches_each_route(route):
    """encoder._fetch_planes with coef_transport on the blocks of
    _chain_input(route): the blocks come back whichever step delivers,
    and the packs made are counted."""
    a = _chain_input(route)
    fin = _finals(a, 2)
    cfg = tenc.EncoderConfig(coef_transport=True).resolved()
    geom = (4, 4, COMPS)
    tenc.reset_codec_routes()
    codec = tenc._dispatch_download(fin, 2, cfg)
    got = tenc._fetch_planes(geom, fin, 2, codec, 8)
    np.testing.assert_array_equal(_blocks(got), a)
    steps = ["transport", "transport_scap32", "sparse", "dense"]
    made = steps[:steps.index(route) + 1]
    assert tenc.codec_routes == {"plane_pack": 0,
                                 **{s: int(s in made) for s in steps}}


FLAGS = {"sparse": dict(sparse_download=True),
         "planepack": dict(plane_pack=True),
         "transport": dict(coef_transport=True),
         "all": dict(sparse_download=True, plane_pack=True,
                     coef_transport=True)}


def _images(precision: int, kind: str):
    """Pairs of 64x48 images, one shape so that every call shares the JAX
    programs: photos, or a noisy photo and a flat one (the group's
    overflow routes)."""
    if precision == 12:
        return ([photo12(48, 64, 1), photo12(48, 64, 2)] if kind == "photo"
                else [photo12(48, 64, 3), np.full((48, 64, 3), 2048,
                                                  np.uint16)])
    if kind == "photo":
        return [_photo(48, 64, 1), _photo(48, 64, 2)]
    noise = np.random.default_rng(4).integers(0, 256, (48, 64, 3))
    return [noise.astype(np.uint8), np.full((48, 64, 3), 128, np.uint8)]


@pytest.mark.parametrize("kind", ["photo", "noise"])
@pytest.mark.parametrize("precision", [8, 12])
@pytest.mark.parametrize("flags", list(FLAGS))
def test_encode_many_codecs_equal_jax(flags, precision, kind):
    imgs = _images(precision, kind)
    kw = dict(quality=90 if kind == "noise" else 75, precision=precision,
              **FLAGS[flags])
    want = mj.encode_many(imgs, mj.EncoderConfig(**kw))
    tenc.reset_codec_routes()
    got = mjt.encode_many(imgs, mjt.EncoderConfig(**kw), device="cpu")
    assert got == want
    routes = dict(tenc.codec_routes)
    assert routes["plane_pack"] == (precision == 8 and "plane_pack" in
                                    FLAGS[flags])
    if "coef_transport" in FLAGS[flags]:
        assert routes["transport"] == 1
        if kind == "photo" and precision == 8:
            assert routes == dict(routes, transport_scap32=0, sparse=0,
                                  dense=0)
    elif "sparse_download" in FLAGS[flags]:
        assert routes["sparse"] == 1 and routes["transport"] == 0
    else:
        assert routes["dense"] == 1


@pytest.mark.parametrize("env", [None, "auto", "0", "off", "1", "on"])
def test_codec_switches_resolve_as_jax(monkeypatch, env):
    """Each codec's flag, else its environment variable, else off: the
    JAX package's resolution on a backend that is not a TPU."""
    names = {"sparse_download": "MJ_SPARSE_DL", "plane_pack": "MJ_PLANEPACK",
             "coef_transport": "MJ_COEF_TRANSPORT"}
    for var in names.values():
        if env is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, env)
    for kw in ({}, dict(sparse_download=True), dict(plane_pack=False),
               dict(coef_transport=True, sparse_download=False)):
        t = mjt.EncoderConfig(**kw).resolved()
        j = mj.EncoderConfig(**kw).resolved()
        for field, var in names.items():
            want = kw.get(field, env in ("1", "on"))
            assert getattr(t, field) == getattr(j, field) == want
