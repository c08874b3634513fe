"""The port's sample-plane pack (ops/planepack.py) on the CPU equals the
JAX package's bit for bit and the native codec's (planepack.cpp): the
decode download's device pack (pack_stream: words, widths, word count)
and the encode upload's device expand (expand_stream, with base offsets
into a shared buffer), the width nibble words both ways, on seeded
streams of widths 0 to 8 and lengths around the 16-sample subtile; the
encode upload's host pack and device unpack (pipeline_t.pack_ycc_batch,
unpack_ycc_batch) give prep_ycc_batch's buffers; the decode route's
stream (decoder.render_packed_pp) equals the JAX pack of the same
planes."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mozjpeg_tpu.native import lib as jlib, u8p, u32p
from mozjpeg_tpu.ops import planepack as jpp
from mozjpeg_tpu_torch.codec import decoder as tdec
from mozjpeg_tpu_torch.codec import pipeline_t as tpipe
from mozjpeg_tpu_torch.ops import planepack as tpp
from test_torch_decode import _photo


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def stream(kind: str, total: int, seed: int = 3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":                          # width 8
        return rng.integers(0, 256, total).astype(np.uint8)
    if kind == "smooth":                          # small widths
        return (np.cumsum(rng.integers(-2, 3, total)) % 256).astype(np.uint8)
    if kind == "flat":                            # width 0 (all 128)
        return np.full(total, 128, np.uint8)
    # every width: subtile t zigzags its deltas to width t % 9 exactly
    z = []
    for t in range(-(-total // 16)):
        w = t % 9
        zt = rng.integers(0, 1 << w, 16)
        zt[0] = (1 << w) - 1
        z.append(zt)
    z = np.concatenate(z)[:total]
    d = (z >> 1) ^ -(z & 1)
    return ((128 + np.cumsum(d)) % 256).astype(np.uint8)


KINDS = ["random", "smooth", "flat", "widths"]
TOTALS = [1, 15, 16, 17, 4099]


def _native_pack(s: np.ndarray):
    """-> (widths, the word buffer (nst * 4 + 4,), the word count)."""
    nst = -(-len(s) // 16)
    widths = np.empty(nst, np.uint8)
    words = np.zeros(nst * 4 + 4, np.uint32)
    nw = jlib.mj_plane_pack(np.ascontiguousarray(s).ctypes.data_as(u8p),
                            len(s), widths.ctypes.data_as(u8p),
                            words.ctypes.data_as(u32p), 1)
    return widths, words, nw


@pytest.mark.parametrize("total", TOTALS)
@pytest.mark.parametrize("kind", KINDS)
def test_pack_stream_equals_jax_and_native(kind, total):
    s = stream(kind, total)
    nst = -(-total // 16)
    capw = nst * 4 + 4
    wj, wdj, nwj = jpp.pack_stream(jnp.asarray(s), nst, capw)
    wt, wdt, nwt = tpp.pack_stream(torch.from_numpy(s), nst, capw)
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj).astype(np.int64))
    np.testing.assert_array_equal(wdt.numpy(), np.asarray(wdj))
    assert int(nwt) == int(nwj)
    widths, words, nw = _native_pack(s)
    np.testing.assert_array_equal(wdt.numpy(), widths)
    assert int(nwt) == nw
    np.testing.assert_array_equal(wt.numpy(), words)
    if kind == "widths" and total > 144:
        assert set(widths.tolist()) == set(range(9))


@pytest.mark.parametrize("total", TOTALS)
@pytest.mark.parametrize("kind", KINDS)
def test_expand_stream_equals_jax(kind, total):
    s = stream(kind, total)
    widths, words, _ = _native_pack(s)
    want = np.asarray(jpp.expand_stream(jnp.asarray(words),
                                        jnp.asarray(widths.astype(np.int32)),
                                        total))
    got = tpp.expand_stream(torch.from_numpy(words.astype(np.int64)),
                            torch.from_numpy(widths.astype(np.int64)),
                            total).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, s)


def test_batched_expand_with_base_offsets():
    """Two streams' payloads back to back in one buffer, each read from
    its own base offset (the batched upload), as the JAX package reads
    them one at a time."""
    total = 1000
    ss = [stream("smooth", total, 1), stream("random", total, 2)]
    packs = [_native_pack(s) for s in ss]
    flat = np.concatenate([w[:n] for _, w, n in packs]
                          + [np.zeros(7, np.uint32)])
    bases = np.array([0, packs[0][2]], np.int64)
    widths = np.stack([w for w, _, _ in packs]).astype(np.int64)
    got = tpp.expand_stream(torch.from_numpy(flat.astype(np.int64)),
                            torch.from_numpy(widths), total,
                            torch.from_numpy(bases)).numpy()
    for i, s in enumerate(ss):
        want = np.asarray(jpp.expand_stream(
            jnp.asarray(flat), jnp.asarray(widths[i].astype(np.int32)),
            total, int(bases[i])))
        np.testing.assert_array_equal(got[i], want)
        np.testing.assert_array_equal(got[i], s)


@pytest.mark.parametrize("nst", [1, 8, 9, 77])
def test_width_words_equal_jax(nst):
    widths = np.random.default_rng(nst).integers(0, 9, (2, nst))
    host = tpp.widths_to_words_host(widths.astype(np.uint32))
    np.testing.assert_array_equal(
        host, jpp.widths_to_words_host(widths.astype(np.uint32)))
    got = tpp.widths_from_words(torch.from_numpy(host.astype(np.int64)), nst)
    for i in range(2):
        want = np.asarray(jpp._widths_from_words(jnp.asarray(host[i]), nst))
        np.testing.assert_array_equal(got.numpy()[i], want)
    np.testing.assert_array_equal(got.numpy(), widths)
    dev = tpp.widths_to_words(torch.from_numpy(widths[0]))
    np.testing.assert_array_equal(dev.numpy(), host[0])


@pytest.mark.parametrize("samp", [(2, 2), (2, 1), (1, 1)])
def test_packed_upload_gives_the_prepped_buffers(samp):
    """pack_ycc_batch's wire (native mj_plane_pack per image, the
    payloads back to back) unpacks on the device into prep_ycc_batch's
    buffers, unaligned sizes included."""
    imgs = [_photo(29, 37, 3), _photo(29, 37, 4)]
    sp = [samp, (1, 1), (1, 1)]
    geom, bufs = tpipe.prep_ycc_batch(imgs, sp)
    geom2, hdrs, flat, bases, total = tpipe.pack_ycc_batch(imgs, sp)
    assert geom2 == geom and total == bufs.shape[1]
    assert len(flat) % 8192 == 0 and bases[0] == 0
    got = tpipe.unpack_ycc_batch(*(torch.from_numpy(a.view(np.int32))
                                   for a in (hdrs, flat, bases)), total)
    np.testing.assert_array_equal(got.numpy(), bufs)


def test_decode_pack_equals_jax():
    """The packed decode download's stream: the group's sample planes,
    each image's [Y | Cb | Cr] back to back, packed as the JAX package
    packs them."""
    rng = np.random.default_rng(8)
    res = [torch.from_numpy(rng.integers(0, 256, (2,) + shape)
                            .astype(np.uint8))
           for shape in ((16, 24), (8, 12), (8, 12))]
    total = sum(r[0].numel() for r in res) * 2
    nst = -(-total // 16)
    words, ww, nw = tdec.render_packed_pp(res, nst)
    flat = np.concatenate([r[i].numpy().reshape(-1) for i in range(2)
                           for r in res])
    wj, wdj, nwj = jpp.pack_stream(jnp.asarray(flat), nst, nst * 4 + 4)
    np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                  np.asarray(wj))
    assert int(nw) == int(nwj)
    np.testing.assert_array_equal(
        ww.numpy().view(np.uint32),
        jpp.widths_to_words_host(np.asarray(wdj).astype(np.uint32)))
