"""The port's Annex-K table generation (mozjpeg_tpu_torch/ops/tablegen.py)
against the JAX package's (gen_optimal_tables_t, derive_codes_t,
trellis_rate_tables_t) and the native host tablegen, exactly; the
device-tablegen trellis route against the host one; and the port's
float64 lambda against the JAX package's soft-float lambda, which the
port does not carry (ROADMAP.md: left out on purpose).

The plain version runs here; the CUDA kernel (csrc/tablegen.cu) is held
against it on the card (chip_smoke.py phase 13, tests/test_torch_cuda.py).
"""
import os

import numpy as np
import pytest
import torch

import mozjpeg_tpu_torch as mjt
from mozjpeg_tpu.ops import softfloat
from mozjpeg_tpu.ops import tablegen as jtg
from mozjpeg_tpu_torch.codec import trellis as ttr
from mozjpeg_tpu_torch.entropy import encode as entenc
from mozjpeg_tpu_torch.entropy.huffman import derive_codes as host_codes
from mozjpeg_tpu_torch.ops import tablegen as tg
from test_softfloat import _rand_norm_sums
from test_tablegen import _cases


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread while this file runs: the suite runs several
    workers on the host's cores, and the engines' many small ops, each
    a parallel region on every core, then wait on one another's
    threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _all_cases():
    """test_tablegen's cases (ties, sparse, one symbol, skewed counts that
    force length limiting, Fibonacci depth, counts of 2^26) and seeded
    random histograms of every density and of counts up to 2^20 (the
    merged sums stay below BIG = 2^30, as any image's do)."""
    cases = list(_cases())
    rng = np.random.default_rng(11)
    for _ in range(40):
        f = np.zeros(257, np.int32)
        k = int(rng.integers(2, 257))
        f[rng.choice(256, k, replace=False)] = rng.integers(
            1, int(rng.choice([3, 60, 5000, 1 << 20])), k)
        cases.append(f)
    return np.stack(cases).astype(np.int32)


@pytest.fixture(scope="module")
def tables():
    freqs = _all_cases()
    return freqs, tg.gen_optimal_tables(torch.as_tensor(freqs), sizes=True)


def test_gen_optimal_tables_matches_jax(tables):
    freqs, (bits, vals, ok, si) = tables
    jb, jv, jok = (np.asarray(a) for a in jtg.gen_optimal_tables_t(freqs))
    np.testing.assert_array_equal(bits.numpy(), jb)
    np.testing.assert_array_equal(vals.numpy(), jv)
    np.testing.assert_array_equal(ok.numpy(), jok)
    co, si2 = tg.derive_codes(bits, vals)
    jco, jsi = (np.asarray(a) for a in jtg.derive_codes_t(jb, jv))
    np.testing.assert_array_equal(co.numpy(), jco.astype(np.int64))
    np.testing.assert_array_equal(si2.numpy(), jsi)
    np.testing.assert_array_equal(si.numpy(), jsi)


def test_gen_optimal_tables_matches_native(tables):
    freqs, (bits, vals, ok, si) = tables
    co, _ = tg.derive_codes(bits, vals)
    for i, f in enumerate(freqs):
        assert bool(ok[i])
        tbl = entenc.gen_optimal_table(f.astype(np.int64))
        np.testing.assert_array_equal(bits[i, 1:].numpy(), tbl.bits[1:])
        n = int(tbl.bits.sum())
        np.testing.assert_array_equal(vals[i, :n].numpy(), tbl.vals)
        hco, hsi = host_codes(tbl)
        np.testing.assert_array_equal(co[i].numpy(), hco.astype(np.int64))
        np.testing.assert_array_equal(si[i].numpy(), hsi.astype(np.int32))


def test_empty_and_single_histograms_flagged():
    f = np.zeros((2, 257), np.int32)
    f[1, 9] = 5                     # one real symbol: a table of 2 codes
    _, _, ok = tg.gen_optimal_tables(torch.as_tensor(f))
    assert ok.tolist() == [False, True]
    assert np.asarray(jtg.gen_optimal_tables_t(f)[2]).tolist() == \
        [False, True]


def test_trellis_rate_tables_match_jax_and_host():
    rng = np.random.default_rng(3)
    hists = rng.integers(0, 5000, (5, 256)).astype(np.int32)
    hists[1] = 0
    hists[1, 5] = 33                # nearly empty: still primed
    hists[2, ::3] = 0
    got = tg.trellis_rate_tables(torch.as_tensor(hists)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jtg.trellis_rate_tables_t(hists)))
    for i in range(len(hists)):
        np.testing.assert_array_equal(
            got[i], ttr.trellis_tables_from_hist(hists[i], 0, True)[0])


def test_wrapper_checks_and_refuses_other_devices():
    with pytest.raises(ValueError):
        tg.gen_optimal_tables(torch.zeros((2, 256), dtype=torch.int32))
    with pytest.raises(ValueError):
        tg.gen_optimal_tables(torch.zeros((2, 257), dtype=torch.int64))
    with pytest.raises(ValueError, match="no kernel"):
        tg.gen_optimal_tables(torch.zeros((2, 257), dtype=torch.int32,
                                          device="meta"))
    tg.reset_launches()
    tg.gen_optimal_tables(torch.as_tensor(_all_cases()[:3]))
    assert tg.launches == 0         # the CPU takes the plain version


def _photos(n, h=48, w=64):
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[0:h, 0:w]
    return [np.clip(np.stack([127 + 90 * np.sin(xx / (5 + i) + i),
                              127 + 80 * np.cos(yy / 4),
                              255.0 * (xx + yy) / (w + h)], -1)
                    + rng.normal(0, 14, (h, w, 3)), 0, 255).astype(np.uint8)
            for i in range(n)]


@pytest.mark.parametrize("kw", [{}, {"trellis_num_loops": 2},
                                {"grayscale": True},
                                {"trellis_eob_opt": True}])
def test_dev_first_route_gives_the_host_routes_bytes(kw, monkeypatch):
    """The device-tablegen route (the default) and MJ_DEV_FIRST=0 (the
    host route) write the same bytes; the default route downloads no
    histogram and builds its tables in one tablegen call a loop."""
    imgs = _photos(2)
    cfg = mjt.EncoderConfig(**kw)
    from mozjpeg_tpu_torch.codec import pipeline_t
    calls = {"download": 0, "tablegen": 0}
    real_dl, real_tg = pipeline_t.download_hists, tg.trellis_rate_tables

    def dl(*a):
        calls["download"] += 1
        return real_dl(*a)

    def rt(*a):
        calls["tablegen"] += 1
        return real_tg(*a)

    monkeypatch.setattr(pipeline_t, "download_hists", dl)
    monkeypatch.setattr(tg, "trellis_rate_tables", rt)
    dev_route = mjt.encode_many(imgs, cfg, device="cpu")
    assert calls == {"download": 0,
                     "tablegen": max(1, cfg.trellis_num_loops)}
    monkeypatch.setenv("MJ_DEV_FIRST", "0")
    host_route = mjt.encode_many(imgs, cfg, device="cpu")
    assert calls["download"] == 1
    assert dev_route == host_route


@pytest.mark.parametrize("s1,s2", [(14.75, 16.5), (16.5, 13.0), (9.0, 0.0)])
def test_lambda_matches_jax_softfloat(s1, s2):
    """The port computes the lambdas in float64 (trellis.lambda_from_norm_t)
    where the JAX package emulates float64 in integers for the TPU
    (ops/softfloat.py); both are exact on softfloat's adversarial norms."""
    rng = np.random.default_rng(7)
    norm = _rand_norm_sums(100_000, rng)
    lam_t = 2.0 ** rng.uniform(-16, 2, 20_000)
    hunt = ((2.0 ** np.float64(s1) / lam_t - 2.0 ** np.float64(abs(s2)))
            .clip(0) * 63.0).astype(np.float32)
    u = hunt.view(np.uint32)
    norm = np.concatenate([norm, hunt, (u + 1).view(np.float32),
                           (u - 1).view(np.float32)])
    norm = norm[np.isfinite(norm) & (norm >= 0)]
    got = ttr.lambda_from_norm_t(torch.as_tensor(norm), s1, s2).numpy()
    want = np.asarray(softfloat.lambda_from_norm_t(norm, s1, s2))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_port_imports_no_softfloat():
    root = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "mozjpeg_tpu_torch")
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                assert "softfloat" not in open(os.path.join(d, f)).read(), f
