"""The port's Annex-K table generation (mozjpeg_tpu_torch/ops/tablegen.py)
against the JAX package's (gen_optimal_tables_t, derive_codes_t,
trellis_rate_tables_t) and the native host tablegen, exactly; the
device-tablegen trellis route against the host one; and the port's
float64 lambda against the JAX package's soft-float lambda, which the
port does not carry (ROADMAP.md: left out on purpose).

The plain version runs here; the CUDA kernel (csrc/tablegen.cu) is held
against it on the card (chip_smoke.py phase 13, tests/test_torch_cuda.py).
The kernel cannot run without a card, so kernel_model below holds its
order of work here (the per-lane keys and their two least, the two warp
minima a merge, the 32-bit and 64-bit key paths and the switch between
them, the relabel, the counting ranks), against the plain version and
the JAX function; change it with the kernel.
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


def _model_groups():
    """The kernel model's cases by group: seeded random, tie-heavy, the
    key switch's thresholds (tablegen.edge_freqs), sparse, length-limited
    and int32-edge histograms, and the trellis route's primed counts."""
    rng = np.random.default_rng(12)
    edges = tg.edge_freqs()

    def rand(n_tab, lo, hi, top):
        f = np.zeros((n_tab, 257), np.int32)
        for i in range(n_tab):
            k = int(rng.integers(lo, hi))
            f[i, rng.choice(256, k, replace=False)] = rng.integers(1, top, k)
        return f

    def rows(*tabs):
        f = np.zeros((len(tabs), 257), np.int64)
        for i, (sl, v) in enumerate(tabs):
            f[i, sl] = v
        return f.astype(np.int32)

    fib = [1, 1]
    while len(fib) < 30:
        fib.append(min(fib[-1] + fib[-2], 1 << 29))
    hists = rng.integers(0, 3000, (3, 256)).astype(np.int32)
    hists[1, rng.random(256) < 0.7] = 0
    return {
        "random dense": rand(4, 180, 257, 5000),
        "random counts to 2^20": rand(4, 2, 257, 1 << 20),
        "ties of 1 and 2": rand(3, 100, 257, 3),
        "all equal": rows((slice(0, 256), 1), (slice(0, 256), 7),
                          (slice(0, 128), 3)),
        "threshold 2^23 - 1": edges[0:2],
        "threshold 2^23": edges[2:4],
        "threshold 2^23 + 1": edges[4:6],
        "sparse": rows((slice(0, 0), 0), (slice(42, 43), 10),
                       (slice(7, 9), 4), (slice(3, 12, 3), 9),
                       (slice(0, 17), 2)),
        "length-limited": rows((slice(0, 40),
                                [2 ** min(i, 25) for i in range(40)]),
                               (slice(0, 30), fib)),
        "int32 edges": np.concatenate([edges[6:], rows(
            (slice(0, 8), 1 << 26))]),
        "trellis route": tg.trellis_freqs(torch.as_tensor(hists)).numpy(),
    }


MODEL_GROUPS = _model_groups()


@pytest.fixture(scope="module")
def tables():
    """_all_cases() and then the model's groups, through the wrapper (the
    plain version here)."""
    freqs = np.concatenate([_all_cases()] + list(MODEL_GROUPS.values()))
    return freqs, tg.gen_optimal_tables(torch.as_tensor(freqs), sizes=True)


@pytest.fixture(scope="module")
def jax_tables(tables):
    """The JAX gen_optimal_tables_t on the same counts: one compile."""
    return tuple(np.asarray(a) for a in jtg.gen_optimal_tables_t(tables[0]))


def test_gen_optimal_tables_matches_jax(tables, jax_tables):
    freqs, (bits, vals, ok, si) = tables
    jb, jv, jok = jax_tables
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
    for i, f in enumerate(freqs[:len(_all_cases())]):
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


# ---- a model of csrc/tablegen.cu's order of work ----

LANES, SLOTS = 32, 9
DEAD32, DEAD64 = (1 << 32) - 1, (1 << 64) - 1


def _warp_min(b, packed):
    """The warp minimum of the lanes' keys: one __reduce_min_sync on the
    32-bit keys; on the 64-bit keys the counts' minimum, then the least
    511 - symbol among the lanes on that count."""
    if packed:
        return min(b)
    c = [min(k >> 9, DEAD32) for k in b]
    m = min(c)
    return m << 9 | min(k & 511 if ci == m else 511 for k, ci in zip(b, c))


def _top_two(keys):
    return tuple(sorted(keys)[:2])


def kernel_model(freq):
    """One table as the kernel's warp computes it: 32 lanes x 9 slots of
    keys count << 9 | (511 - symbol), 32-bit when the live counts sum
    below tablegen.PACKED_BELOW (each lane's sum capped there before the
    warp's) and 64-bit otherwise; per merge two warp minima, over the
    lanes' least keys and then with c1's lane offering its second least,
    then the two least refreshed only in the lanes that own c1 and c2
    (asserting that every other lane's are still its own two least, so
    that the kernel's lockstep recomputation changes nothing there); the
    relabel of the code sizes by root symbol; counting ranks for the
    values, a round of 32 symbols at a time; the length limiting.
    -> (bits (17,), vals (256,), ok, the key path: "packed" or "wide")."""
    sym = np.arange(LANES)[:, None] + 32 * np.arange(SLOTS)[None, :]
    v = np.where(sym < 256, np.append(freq, 0)[np.minimum(sym, 257)], 0)
    v = np.where(sym == 256, 1, v).astype(np.int64)
    pres = v > 0
    live = pres & (v < tg.BIG)
    lane_sums = np.where(live, v, 0).sum(1)
    packed = int(np.minimum(lane_sums, tg.PACKED_BELOW).sum()) \
        < tg.PACKED_BELOW
    dead = DEAD32 if packed else DEAD64
    key = [[int(v[ln, k]) << 9 | (511 - int(sym[ln, k])) if live[ln, k]
            else dead for k in range(SLOTS)] for ln in range(LANES)]
    grp, cs = sym.copy(), np.zeros_like(sym)
    top = [_top_two(row) for row in key]
    n_live = int(live.sum())
    for _ in range(256):
        if n_live < 2:
            break
        m1 = _warp_min([t[0] for t in top], packed)
        c1 = 511 - (m1 & 511)
        m2 = _warp_min([t[1] if ln == c1 % 32 else t[0]
                        for ln, t in enumerate(top)], packed)
        c2 = 511 - (m2 & 511)
        merged = (m1 >> 9) + (m2 >> 9)
        gone = merged >= tg.BIG
        if packed:
            assert max(m1, m2) < DEAD32 and not gone
        key[c1 % 32][c1 // 32] = dead if gone else merged << 9 | (511 - c1)
        key[c2 % 32][c2 // 32] = dead
        for ln in {c1 % 32, c2 % 32}:
            top[ln] = _top_two(key[ln])
        assert top == [_top_two(row) for row in key]
        member = (grp == c1) | (grp == c2)
        cs += member
        grp[grp == c2] = c1
        n_live -= 1 + int(gone)

    # counting ranks, a round of 32 symbols at a time
    hist = np.zeros(257, np.int64)
    pos = np.zeros_like(sym)
    absent_before = 0
    for k in range(SLOTS):
        p = pres[:, k]
        absent = (sym[:, k] < 257) & ~p
        for ln in range(LANES):
            if p[ln]:
                same = p[:ln] & (cs[:ln, k] == cs[ln, k])
                pos[ln, k] = hist[cs[ln, k]] + same.sum()
            else:
                pos[ln, k] = absent_before + absent[:ln].sum()
        np.add.at(hist, cs[p, k], 1)
        absent_before += int(absent.sum())
    n_present = int(pres.sum())
    ok = n_present >= 2 and not (pres & (cs > 32)).any()
    below = np.cumsum(hist) - hist
    vals = np.full(256, -1, np.int64)
    for ln in range(LANES):
        for k in range(SLOTS):
            s = int(sym[ln, k])
            if s < 257:
                r = below[cs[ln, k]] + pos[ln, k] if pres[ln, k] \
                    else n_present + pos[ln, k]
                if r < 256:
                    vals[r] = 0 if s == 256 else s
    bits = np.zeros(33, np.int64)
    bits[:32] = hist[:32]
    bits[32] = hist[32:].sum()
    bits[0] = 0
    for i in range(32, 16, -1):
        for _ in range(129):
            if bits[i] <= 0:
                break
            j = max([ln for ln in range(i - 1) if bits[ln] > 0], default=0)
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    last = max([ln for ln in range(17) if bits[ln] > 0], default=0)
    bits[last] -= int(ok)
    return bits[:17], vals, ok, "packed" if packed else "wide"


@pytest.mark.parametrize("group", list(MODEL_GROUPS))
def test_kernel_model_matches_plain_and_jax(tables, jax_tables, group):
    """The model of the kernel's order of work, table by table, against
    the plain version and the JAX gen_optimal_tables_t (the rows of this
    group in the shared fixture); the threshold groups take the key path
    their live sums call for."""
    freqs, (bits, vals, ok, _) = tables
    jb, jv, jok = jax_tables
    start = len(_all_cases())
    for name, g in MODEL_GROUPS.items():
        if name == group:
            break
        start += len(g)
    paths = set()
    for i in range(start, start + len(MODEL_GROUPS[group])):
        mb, mv, mok, path = kernel_model(freqs[i])
        paths.add(path)
        for a, b, c in ((mb, bits[i].numpy(), jb[i]),
                        (mv, vals[i].numpy(), jv[i])):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
        assert mok == bool(ok[i]) == bool(jok[i])
    if group.startswith("threshold"):
        assert paths == {"packed" if group.endswith("- 1") else "wide"}
