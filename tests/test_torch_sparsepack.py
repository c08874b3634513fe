"""The port's sparse coefficient transfer (ops/sparsepack.py) on the CPU
equals the JAX package's bit for bit on seeded numpy planes: the encode
download's header, value-byte and escape words (_pack_exact), its
fetch and native expansion; the decode upload's flat layout
(pack_flat_host, expand_flat_dev) and its superblock layout (pack_host,
expand_dev). Inputs: random JPEG-like blocks with escapes and the
+-127/128 byte edges, all zero, one dense block past CAP_BLOCK
nonzeros, and int16 extremes. encode_many with sparse_download against
the JAX package is in test_torch_transport.py, beside the other codecs,
so that the three share one module's JAX compiles."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mozjpeg_tpu.codec.pipeline import CompGeom
from mozjpeg_tpu.ops import sparsepack as jsp
from mozjpeg_tpu_torch.codec import encoder as tenc
from mozjpeg_tpu_torch.ops import sparsepack as tsp


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def planes(kind: str, nt: int = 96, seed: int = 5) -> np.ndarray:
    """(nt, 64) int16 zigzag blocks of the named kind."""
    rng = np.random.default_rng(seed)
    a = np.zeros((nt, 64), np.int16)
    if kind == "zero":
        return a
    for blk in range(nt):
        k = rng.integers(0, 20)
        pos = rng.choice(64, k, replace=False)
        v = np.where(rng.random(k) < 0.85, rng.integers(-127, 128, k),
                     rng.integers(-1024, 1024, k))
        v[v == 0] = 1
        a[blk, pos] = v
    a[7, :4] = [-127, -128, 127, 128]
    if kind == "dense":
        a[3] = rng.integers(1, 100, 64)                # 64 > CAP_BLOCK
    elif kind == "extremes":
        a[5], a[6] = 32767, -32768
        a[8, ::2] = 4095
        a[8, 1::2] = -4095                                 # 12-bit range
    return a


KINDS = ["random", "zero", "dense", "extremes"]


def _u32(words) -> np.ndarray:
    return np.asarray(words).view(np.uint32)


@pytest.mark.parametrize("kind", KINDS)
def test_pack_exact_equals_jax(kind):
    a = planes(kind)
    nt = a.shape[0]
    hj, lj, ej = jsp._pack_exact(jnp.asarray(a.T.copy()), nt)
    ht, lt, et = tsp.pack_exact(torch.from_numpy(a.T.copy()))
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    np.testing.assert_array_equal(_u32(lt.numpy()), _u32(lj))
    np.testing.assert_array_equal(_u32(et.numpy()), _u32(ej))
    assert int(np.asarray(hj)[-1]) == (kind in ("dense", "extremes"))


COMPS = [CompGeom(2, 2, 64, 32, 8, 4, 8, 4), CompGeom(1, 1, 32, 16, 4, 2,
                                                      4, 2),
         CompGeom(1, 1, 32, 16, 4, 2, 4, 2)]


@pytest.mark.parametrize("kind", KINDS)
def test_download_chain_equals_jax(kind):
    """pack_planes_exact -> fetch_exact -> expand_flat_to_planes on three
    images of a 4:2:0 geometry: the same fetched arrays and planes as the
    JAX package's, the input back, or None on overflow in both."""
    b = 3
    n_tot = sum(g.bh * g.bw for g in COMPS)
    a = planes(kind, b * n_tot).reshape(b, n_tot, 64)
    finals, off = [], 0
    for g in COMPS:
        n = g.bh * g.bw
        finals.append(a[:, off:off + n].transpose(2, 0, 1).reshape(64, -1))
        off += n
    pj = jsp.pack_planes_exact(tuple(jnp.asarray(f) for f in finals),
                               COMPS, b)
    pt = tsp.pack_planes_exact([torch.from_numpy(f.copy()) for f in finals],
                               b)
    fj = jsp.fetch_exact(*pj[:3])
    ft = tsp.fetch_exact(*pt[:3])
    assert (fj is None) == (ft is None)
    if fj is None:
        return
    for x, y in zip(ft, fj):
        np.testing.assert_array_equal(x, y)
    got = tsp.expand_flat_to_planes(*ft[:3], pt[2], b, COMPS)
    want = jsp.expand_flat_to_planes(*fj[:3], pj[2], pj[3], b, COMPS)
    for gi, wi, ai in zip(got, want, a):
        np.testing.assert_array_equal(
            np.concatenate([p.reshape(-1, 64) for p in gi]), ai)
        for g, w in zip(gi, wi):
            np.testing.assert_array_equal(g, w)


def test_fetch_trims_to_one_bucket():
    """A nearly empty group downloads one bucket of value words, not its
    capacity."""
    a = np.zeros((16384, 64), np.int16)
    a[0, 5] = 7
    header, words, nt, _ = tsp.pack_planes_exact(
        [torch.from_numpy(a.T.copy())], 1)
    masks, lo, esc, total = tsp.fetch_exact(header, words, nt)
    assert total == 1 and len(esc) == 0
    assert words[0].shape[0] == 2 * tsp.TRIM_WORDS_STEP
    assert len(lo) == 4 * tsp.TRIM_WORDS_STEP and lo[0] == 7


@pytest.mark.parametrize("kind", KINDS)
def test_flat_upload_equals_jax(kind):
    a = planes(kind, 93)
    pj = jsp.pack_flat_host(a)
    pt = tsp.pack_flat_host(a)
    for x, y in zip(pt, pj):
        np.testing.assert_array_equal(x, y)
    masks, lo, esc, nt = pt[:4]
    want = np.asarray(jsp.expand_flat_dev(
        jnp.asarray(masks), jnp.asarray(lo), jnp.asarray(esc), nt, len(lo),
        len(esc)))
    got = tsp.expand_flat_dev(torch.from_numpy(masks), torch.from_numpy(lo),
                              torch.from_numpy(esc), nt).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.T, a)


@pytest.mark.parametrize("kind", KINDS)
def test_superblock_upload_equals_jax(kind):
    """pack_host refuses the dense and extreme blocks (over CAP_BLOCK
    nonzeros) in both packages; elsewhere expand_dev gives the JAX
    planes and the input back."""
    a = planes(kind, 93)
    pj, pt = jsp.pack_host(a), tsp.pack_host(a)
    assert (pj is None) == (pt is None) == (kind in ("dense", "extremes"))
    if pt is None:
        return
    for x, y in zip(pt, pj):
        np.testing.assert_array_equal(x, y)
    masks, vals, nt, cap = pt
    want = np.asarray(jsp.expand_dev(jnp.asarray(masks), jnp.asarray(vals),
                                     nt, cap))
    got = tsp.expand_dev(torch.from_numpy(masks), torch.from_numpy(vals),
                         nt, cap).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, :a.shape[0]].T, a)


def test_sparse_route_of_the_chain():
    """The encoder's download chain with sparse_download: the sparse
    pack delivers the planes, and on a block past CAP_BLOCK the dense
    download does."""
    geom = (2, 2, [CompGeom(1, 1, 16, 16, 2, 2, 2, 2)])
    for kind, route in (("random", "sparse"), ("dense", "dense")):
        a = planes(kind, 8, seed=11)
        flat = torch.from_numpy(a.T.copy())
        tenc.reset_codec_routes()
        codec = tenc._dispatch_download(
            (flat,), 2, tenc.EncoderConfig(sparse_download=True).resolved())
        got = tenc._fetch_planes(geom, (flat,), 2, codec)
        np.testing.assert_array_equal(
            np.concatenate([p[0].reshape(-1, 64) for p in got]), a)
        assert tenc.codec_routes["sparse"] == 1
        assert tenc.codec_routes["dense"] == (route == "dense")
