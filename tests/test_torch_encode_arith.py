"""Arithmetic coding in the port: the row trellis ops exactly equal to
their JAX functions, and encode_many with arithmetic=True and no trellis
(the batched route with the arithmetic entropy stage: sequential,
progressive with the scan search in Python, restarts, gray, CMYK and
FASTEST) byte-identical to mozjpeg_tpu.encode_many on the CPU. The
arithmetic trellis's routes are in test_torch_encode_arith_trellis.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mozjpeg_tpu.codec import trellis as jtr
from mozjpeg_tpu_torch.codec import encoder as tenc
from mozjpeg_tpu_torch.codec import trellis as ttr
from test_torch_encode import _photo, assert_config_encodes

RGB = [_photo(48, 64, 31), _photo(29, 37, 32)]


def _rates(trained_rows: int, seed: int):
    """(dc (64, 2), ac (256, 2)) f32 rates of a coder trained on
    `trained_rows` seeded block rows (0: the fresh coder's state 0)."""
    rng = np.random.default_rng(seed)
    with tenc.ArithTrainer(tenc.EncoderConfig().resolved(), 0) as coder:
        for _ in range(trained_rows):
            blk = np.zeros((40, 64), np.int16)
            blk[:, :12] = rng.integers(-6, 7, (40, 12))
            blk[:, 0] = rng.integers(-60, 60, 40)
            coder.train(blk)
        dc, ac = coder.rates()
        return dc.copy(), ac.copy()


def _row(kind: str, n: int, seed: int):
    """raw (64, n) int32, its rounded quantization (64, n) int16, the
    zigzag table (64,) int32 and lambda (n,) f32. tie: q = 1, raw on
    multiples of 8 and lambda 1/64, so that distortions are integers
    and equal costs are common."""
    rng = np.random.default_rng(seed)
    if kind == "tie":
        qz = np.ones(64, np.int32)
        raw = rng.integers(-6, 7, (64, n)) * 8
        raw[rng.random(raw.shape) < 0.6] = 0
        lam = np.full(n, 1 / 64, np.float32)
    else:
        qz = rng.integers(1, 40, 64).astype(np.int32)
        raw = rng.integers(-2000, 2000, (64, n))
        raw[rng.random(raw.shape) < 0.7] = 0
        lam = (rng.random(n) * 3 + 0.05).astype(np.float32)
    raw = raw.astype(np.int32)
    q8 = (qz << 3)[:, None]
    q = (np.sign(raw) * ((np.abs(raw) + (q8 >> 1)) // q8)).astype(np.int16)
    return raw, q, qz, lam


@pytest.mark.parametrize("kind,n,band,trained", [
    ("seeded", 37, (1, 63), 0),
    ("tie", 50, (1, 63), 3),
    ("seeded", 20, (1, 8), 3),
    ("tie", 33, (9, 63), 5),
    ("seeded", 1, (1, 63), 2),
], ids=["state0", "tie-trained", "band-1-8", "tie-band-9-63", "one-block"])
def test_arith_rows_match_jax(kind, n, band, trained):
    raw, q, qz, lam = _row(kind, n, n + trained)
    dc_rates, ac_rates = _rates(trained, n)
    want = np.asarray(jtr._arith_ac_row(*band, 5)(
        jnp.asarray(raw), jnp.asarray(q), jnp.asarray(qz), jnp.asarray(lam),
        jnp.asarray(ac_rates)))
    got = ttr.arith_ac_row(
        torch.as_tensor(raw), torch.as_tensor(q), torch.as_tensor(qz),
        torch.as_tensor(lam), ac_rates, *band)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)
    if kind == "tie":
        assert (want != q).sum() > 50           # the trellis moved a lot
    q0 = int(qz[0])
    nc = jtr.get_num_dc_candidates(q0)
    lam_dc = (lam * np.float32(1.0 / (q0 * q0))).astype(np.float32)
    jd, jf = jtr._arith_dc_row(jnp.asarray(raw[0]), jnp.int32(-5),
                               jnp.int32(q0), jnp.asarray(dc_rates), nc,
                               jnp.asarray(lam_dc))
    td = ttr.arith_dc_rows(torch.as_tensor(raw[None, 0]),
                           torch.tensor([-5], dtype=torch.int32), q0,
                           dc_rates, nc, torch.as_tensor(lam_dc[None]))[0]
    assert td.dtype == torch.int32
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert int(td[-1]) == int(jf)


@pytest.mark.parametrize("imgs,kw", [
    (RGB, dict(progressive=False)),
    (RGB, dict()),
    ([RGB[0][..., 0].copy()], dict(restart_in_rows=1)),
    ([np.concatenate([RGB[1], _photo(29, 37, 33)[..., :1]], -1)], dict()),
    (RGB[1:], dict(profile=tenc.Profile.FASTEST)),
], ids=["sequential", "progressive-scan-search", "gray-2d-rows1",
        "cmyk-simple-script", "fastest"])
def test_arith_without_trellis_matches_jax(imgs, kw):
    """(Sequential with restart_interval=2 is in
    test_torch_encode_arith_trellis.py, to spread the JAX compiles.)"""
    assert_config_encodes(imgs, quality=75, arithmetic=True,
                          trellis_quant=False, **kw)


@pytest.mark.parametrize("v", [2, 3])
def test_arith_dc_imcu_row_matches_jax_chain(v):
    """The iMCU row's DC rows, run in pairs with the second row beside
    the first once per final candidate, equal the JAX package's rows run
    one after another with the last DC carried (from 0)."""
    raw, _, qz, lam = _row("seeded", 24 * v, 70 + v)
    dc_rates, _ = _rates(4, v)
    q0 = int(qz[0])
    nc = jtr.get_num_dc_candidates(q0)
    lam_dc = (lam * np.float32(1.0 / (q0 * q0))).astype(np.float32)
    rows, lams = raw[0].reshape(v, 24), lam_dc.reshape(v, 24)
    want, last = [], jnp.int32(0)
    for k in range(v):
        out, last = jtr._arith_dc_row(jnp.asarray(rows[k]), last,
                                      jnp.int32(q0), jnp.asarray(dc_rates),
                                      nc, jnp.asarray(lams[k]))
        want.append(np.asarray(out))
    got = ttr.arith_dc_imcu_row(torch.as_tensor(rows), q0, dc_rates, nc,
                                torch.as_tensor(lams))
    np.testing.assert_array_equal(got.numpy(), np.stack(want))
