"""The port's ifast and float IDCTs (ops/dct.py) on the CPU equal the JAX
package's exactly: the multiplier tables, the transforms on seeded
blocks with 8- and 16-bit quant tables, at the int16 extremes (ifast's
int32 products wrap; float's sums leave int32's range, where the
conversion saturates as XLA's does), and whole decodes with
dct_method="ifast" and "float" against mozjpeg_tpu.decode, a corrupt
stream with 16-bit quant tables among them."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mozjpeg_tpu as mj
import mozjpeg_tpu_torch as mjt
from mozjpeg_tpu.ops import dct as jdct
from mozjpeg_tpu_torch.ops import dct as tdct
from test_torch_decode import _corrupt, _photo, _truncate, on_torch_render
from test_torch_decode_ops import _coeffs


def _qtables(rng, wide):
    """(4, 8, 8) quant tables, 8-bit or 16-bit, with 1 and the top value
    planted."""
    top = 65535 if wide else 255
    q = rng.integers(1, top + 1, (4, 8, 8))
    q[0, 0, 0], q[1, 0, 0], q[2] = 1, top, top
    return q.astype(np.uint16)


@pytest.mark.parametrize("wide", [False, True])
def test_multiplier_tables_equal(wide):
    rng = np.random.default_rng(40 + wide)
    for q in _qtables(rng, wide):
        for tf, jf in ((tdct.ifast_multipliers, jdct.ifast_multipliers),
                       (tdct.float_multipliers, jdct.float_multipliers)):
            got, want = tf(q), np.asarray(jf(q))
            assert got.dtype == want.dtype and got.shape == (8, 8)
            np.testing.assert_array_equal(got, want)


def _run(method, coef, tbl):
    tf = {"ifast": tdct.idct_ifast, "float": tdct.idct_float}[method]
    jf = {"ifast": jdct.idct_ifast, "float": jdct.idct_float}[method]
    want = np.asarray(jf(jnp.asarray(coef), jnp.asarray(tbl)))
    got = tf(torch.from_numpy(coef), torch.from_numpy(tbl)).numpy()
    return got, want


@pytest.mark.parametrize("method", ["ifast", "float"])
@pytest.mark.parametrize("extreme,wide", [(False, False), (True, False),
                                          (True, True)])
def test_idct_exact(method, extreme, wide):
    rng = np.random.default_rng(50 + 2 * extreme + wide)
    coef = _coeffs(rng, (4, 6, 8, 8), extreme)
    mult = {"ifast": tdct.ifast_multipliers,
            "float": tdct.float_multipliers}[method]
    tbl = np.stack([mult(q) for q in _qtables(rng, wide)])[:, None]
    got, want = _run(method, coef, tbl)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_float_conversion_saturates_like_xla():
    """The float IDCT's (int) cast outside int32's range: XLA saturates,
    and so does the port, on the CPU as on the card."""
    x = np.array([3e9, -3e9, 2.2e9, -2.2e9, 2147483520.0, -2147483648.0,
                  2147483648.0, 1.5e10, -1.5e10, 0.0, -0.7, 0.7],
                 np.float32)
    want = np.asarray(jnp.asarray(x).astype(jnp.int32))
    got = tdct._f32_to_i32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_float_idct_leaves_int32_range():
    """The extreme blocks of test_idct_exact with 16-bit tables do reach
    the saturating conversion: some of the second pass's outputs leave
    int32's range (the port's two passes, before the cast)."""
    rng = np.random.default_rng(50 + 2 * True + True)
    coef = torch.from_numpy(_coeffs(rng, (4, 6, 8, 8), True))
    q = _qtables(rng, True)
    fm = torch.from_numpy(np.stack([tdct.float_multipliers(t)
                                    for t in q])[:, None])
    x = coef.to(torch.float32) * (fm * 0.125)
    y = torch.stack(tdct._idct_float_1d([x[..., i, :] for i in range(8)]),
                    dim=-2)
    o = torch.stack(tdct._idct_float_1d([y[..., :, i] for i in range(8)],
                                        128.5), dim=-1)
    assert bool((o.abs() >= 2.0 ** 31).any())


@pytest.fixture(scope="module")
def streams():
    img, odd = _photo(48, 64, 41), _photo(29, 37, 42)

    def enc(im, **kw):
        return mjt.encode(im, mjt.EncoderConfig(**kw), device="cpu")

    s = {
        "q75_420": enc(img, quality=75),
        "q85_2x1_odd": enc(odd, quality=85, subsampling=(2, 1)),
        "gray_odd": enc(odd[..., 1], quality=75),
        "arith_420": enc(img, quality=75, arithmetic=True),
        "cmyk_odd": enc(np.concatenate([odd, odd[..., :1]], -1),
                        quality=75),
        # quality 1 without force_baseline: 16-bit quant tables
        "q1_wide_odd": enc(odd, quality=1, force_baseline=False,
                           progressive=False),
    }
    s["truncated_420"] = _truncate(s["q75_420"], 0.6)
    s["corrupt_wide_odd"] = _corrupt(enc(odd, quality=5,
                                         force_baseline=False))
    return s


NAMES = ["q75_420", "q85_2x1_odd", "gray_odd", "arith_420", "cmyk_odd",
         "q1_wide_odd", "truncated_420", "corrupt_wide_odd"]


def test_inputs_cover_the_paths(streams):
    from mozjpeg_tpu_torch.codec import marker as tmarker
    for name in ("q1_wide_odd", "corrupt_wide_odd"):
        jp = tmarker.parse(streams[name])
        assert max(int(t.max()) for t in jp.qtables.values()) > 255
    on_torch_render(mjt.decode, streams["corrupt_wide_odd"], device="cpu")
    from mozjpeg_tpu_torch.codec import decoder as tdec
    assert tdec.last_warnings() > 0


@pytest.mark.parametrize("method", ["ifast", "float"])
@pytest.mark.parametrize("name", NAMES)
def test_decode_dct_method_equals_jax(streams, method, name):
    data = streams[name]
    want = mj.decode(data, dct_method=method)
    got = mjt.decode(data, dct_method=method, device="cpu")
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
