"""The port's host decode engine and packed decode route on the CPU equal
the JAX package's pixels: decode, decode_many (RGB and YUV) and
decode_grayscale with MJ_HOST_ENGINE 1 and 0 and MJ_DEPLOYMENT local
and remote; the packed route (MJ_HOST_ENGINE=0 off a local device) with
MJ_PLANEPACK 0 and 1, also against the JAX package's own packed route;
and the streams outside the host render's matrix (CMYK, 12 bits, active
block smoothing, h1v2 upsampling, the ifast IDCT) fall through as in the
JAX package. On the card, render and decode_many take the host only
with MJ_DEPLOYMENT=remote (the card is patched in; the host route never
touches it).

The streams come from the JAX package's host encoder and the port's CPU
encoder (1x2, 4x1, CMYK), the geometries of test_torch_decode.py."""
import numpy as np
import pytest
import torch

import mozjpeg_tpu as mj
import mozjpeg_tpu_torch as mjt
from mozjpeg_tpu.codec import decoder as jdec
from mozjpeg_tpu.codec import marker as jmarker
from mozjpeg_tpu.utils import attachment as jattach
from mozjpeg_tpu_torch.codec import decoder as tdec
from mozjpeg_tpu_torch.codec import marker as tmarker
from mozjpeg_tpu_torch.utils import attachment as tattach
from test_torch_decode import _photo, _truncate, _with_sof, on_torch_render


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _enc(img, **kw):
    return mj.encode(img, mj.EncoderConfig(**kw))


def _tenc(img, **kw):
    """The port's CPU encoder, for what the JAX host engine does not take
    (1x2 and 4x1 would compile JAX programs, CMYK too)."""
    return mjt.encode(img, mjt.EncoderConfig(**kw), device="cpu")


@pytest.fixture(scope="module")
def streams():
    k_img = np.concatenate([_photo(48, 64, 1), _photo(48, 64, 5)[..., :1]],
                           -1)
    s = {
        "420": _enc(_photo(48, 64, 1), quality=75),
        "420_b": _enc(_photo(48, 64, 2), quality=75),
        "2x1": _enc(_photo(29, 37, 3), quality=85, subsampling=(2, 1)),
        "444": _enc(_photo(31, 17, 4), quality=92, subsampling=(1, 1)),
        "1x2": _tenc(_photo(29, 37, 9), quality=80, subsampling=(1, 2)),
        "4x1": _tenc(_photo(29, 37, 10), quality=80, subsampling=(4, 1)),
        "gray": _enc(_photo(48, 64, 7)[..., 1], quality=75),
        "cmyk": _tenc(k_img, quality=75),
    }
    s["truncated"] = _truncate(s["420"], 2 / 3)
    s["12-bit"] = _with_sof(s["420"], precision=12)
    return s


IN_MATRIX = ["420", "2x1", "444", "4x1", "gray"]
OUTSIDE = ["1x2", "truncated", "cmyk", "12-bit"]


def _equal(got, want):
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
        return
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _spy(monkeypatch, name):
    """Wrap tdec.<name>, recording whether each call returned a value."""
    calls = []
    fn = getattr(tdec, name)

    def spy(*a, **k):
        r = fn(*a, **k)
        calls.append(r is not None)
        return r
    monkeypatch.setattr(tdec, name, spy)
    return calls


def test_is_local(monkeypatch):
    monkeypatch.delenv("MJ_DEPLOYMENT", raising=False)
    assert tattach.is_local("cuda") and not tattach.is_local("cpu")
    for env, want in (("local", True), ("remote", False)):
        monkeypatch.setenv("MJ_DEPLOYMENT", env)
        assert tattach.is_local("cuda") == tattach.is_local("cpu") == want


@pytest.mark.parametrize("deployment", ["local", "remote"])
@pytest.mark.parametrize("host_engine", ["1", "0"])
def test_decode_equals_jax(streams, monkeypatch, host_engine, deployment):
    """On the CPU decode renders on the host first, as the JAX package
    does on every backend, unless MJ_HOST_ENGINE=0; the deployment does
    not matter there."""
    want = {n: mj.decode(streams[n]) for n in IN_MATRIX + OUTSIDE}
    monkeypatch.setenv("MJ_HOST_ENGINE", host_engine)
    monkeypatch.setenv("MJ_DEPLOYMENT", deployment)
    host = _spy(monkeypatch, "_render_host")
    for name in IN_MATRIX + OUTSIDE:
        _equal(mjt.decode(streams[name], device="cpu"), want[name])
    assert host[:len(IN_MATRIX)] == [host_engine == "1"] * len(IN_MATRIX)
    assert not any(host[len(IN_MATRIX):])


def _mixed(s):
    """More than GROUP streams of one key, every other geometry and the
    streams outside the host matrix (the lossless path is not one of the
    routes here)."""
    return ([s["420"], s["420_b"]] * 5
            + [s[n] for n in IN_MATRIX[1:] + OUTSIDE] + [s["420"]])


@pytest.fixture(scope="module")
def jax_many(streams):
    """The JAX package's decode_many on the CPU (its route off a local
    TPU: the host render, the rest merged or one at a time)."""
    return {out: mj.decode_many(_mixed(streams), output=out)
            for out in ("rgb", "yuv")}


# (MJ_HOST_ENGINE, MJ_DEPLOYMENT, MJ_PLANEPACK) -> the route of the
# images in the host matrix
ROUTES = {("1", "remote", "0"): "host", ("1", "local", "0"): "merged",
          ("0", "local", "0"): "merged", ("0", "remote", "0"): "packed",
          ("0", "remote", "1"): "packed"}


@pytest.mark.parametrize("output", ["rgb", "yuv"])
@pytest.mark.parametrize("env", list(ROUTES), ids="-".join)
def test_decode_many_routes_equal_jax(streams, jax_many, monkeypatch, env,
                                      output):
    he, dep, pp = env
    for k, v in zip(("MJ_HOST_ENGINE", "MJ_DEPLOYMENT", "MJ_PLANEPACK"),
                    env):
        monkeypatch.setenv(k, v)
    host = _spy(monkeypatch, "_host_decode_one")
    packed = _spy(monkeypatch, "_decode_chunk_packed")
    pp_fetch = _spy(monkeypatch, "_pp_fetch_planes")
    datas = _mixed(streams)
    got = mjt.decode_many(datas, output=output, device="cpu")
    _equal(got, jax_many[output])
    route = ROUTES[env]
    # host: every stream is tried; the in-matrix ones succeed, and for
    # YUV the 1x2 one too (its raw planes need no upsampling)
    n_host = len(datas) - len(OUTSIDE) + (output == "yuv")
    assert (sum(host), len(host)) == ((n_host, len(datas))
                                      if route == "host" else (0, 0))
    # packed: the 420 key in groups of GROUP, then one chunk a key
    assert len(packed) == ((1 + 1 + len(IN_MATRIX) - 1)
                           if route == "packed" else 0)
    assert len(pp_fetch) == (len(packed) if pp == "1" else 0)


def test_packed_route_equals_jax_packed_route(streams, monkeypatch):
    """MJ_HOST_ENGINE=0 off a local device: the JAX package's own packed
    route (sparse upload, _render_packed, the raw-stack download and
    mj_post_ycc) against the port's, plane-packed or not."""
    monkeypatch.setenv("MJ_HOST_ENGINE", "0")
    monkeypatch.setenv("MJ_PLANEPACK", "0")
    monkeypatch.setattr(jattach, "is_local_tpu", lambda: False)
    datas = [streams["420"], streams["gray"], streams["420_b"]]
    want = mj.decode_many(datas)
    monkeypatch.setenv("MJ_DEPLOYMENT", "remote")
    for pp in ("0", "1"):
        monkeypatch.setenv("MJ_PLANEPACK", pp)
        _equal(mjt.decode_many(datas, device="cpu"), want)


@pytest.mark.parametrize("deployment", ["local", "remote"])
@pytest.mark.parametrize("host_engine", ["1", "0"])
def test_decode_grayscale_equals_jax(streams, monkeypatch, host_engine,
                                     deployment):
    """decode_grayscale renders component 0 on its own in both packages;
    the switches leave it there."""
    names = ["420", "gray", "truncated"]
    want = [jdec.decode_grayscale(streams[n]) for n in names]
    monkeypatch.setenv("MJ_HOST_ENGINE", host_engine)
    monkeypatch.setenv("MJ_DEPLOYMENT", deployment)
    host = _spy(monkeypatch, "_render_host")
    _equal([mjt.decode_grayscale(streams[n], device="cpu") for n in names],
           want)
    assert host == []


def test_out_of_matrix_streams_fall_through_as_in_jax(streams):
    """The host render takes a stream, and the packed route keys it,
    exactly where the JAX package's do: each decision and each output
    equal, for every stream here, block smoothing on and off."""
    for name in IN_MATRIX + OUTSIDE:
        data = streams[name]
        jp_j, jp_t = jmarker.parse(data), tmarker.parse(data)
        pl_j = jdec.decode_coefficients(jp_j, data)
        pl_t = tdec._entropy(jp_t, data)
        for smooth in (True, False):
            for fancy in (True, False):
                key_j = jdec._fast_decode_key(jp_j, pl_j, fancy, smooth)
                key_t = tdec._fast_decode_key(jp_t, pl_t, fancy, smooth)
                assert key_t == key_j, name
                a = jdec._render_host(jp_j, pl_j, None, fancy, smooth)
                b = tdec._render_host(jp_t, pl_t, None, fancy, smooth)
                assert (a is None) == (b is None), name
                if a is not None:
                    _equal(b, a)
            for output in ("rgb", "yuv"):
                a = jdec._host_decode_one(jp_j, pl_j, True, smooth, output)
                b = tdec._host_decode_one(jp_t, pl_t, True, smooth, output)
                assert (a is None) == (b is None), (name, output)
                if a is not None:
                    _equal(b, a)
        assert (name in IN_MATRIX) == (
            tdec._render_host(jp_t, pl_t, None, True, True) is not None)


def test_ifast_never_takes_the_host(streams, monkeypatch):
    host = _spy(monkeypatch, "_render_host")
    data = streams["420"]
    _equal(mjt.decode(data, dct_method="ifast", device="cpu"),
           on_torch_render(mjt.decode, data, dct_method="ifast",
                           device="cpu"))
    assert host == []


def test_the_card_renders_on_the_host_only_when_remote(streams,
                                                       monkeypatch):
    """With a card (patched in), render and decode_many keep the card's
    route unless MJ_DEPLOYMENT=remote asks for the host's; the host
    route never touches the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.delenv("MJ_DEPLOYMENT", raising=False)
    monkeypatch.setenv("MJ_HOST_ENGINE", "1")
    card = []

    def no_card(*a, **k):
        card.append(1)
        raise RuntimeError("the card's render")
    monkeypatch.setattr(tdec, "_render_t", no_card)
    monkeypatch.setattr(tdec, "_render_into", no_card)
    data = streams["420"]
    for call in (lambda: mjt.decode(data, device="cuda"),
                 lambda: mjt.decode_many([data], device="cuda")):
        with pytest.raises(RuntimeError, match="the card's render"):
            call()
    assert len(card) == 2
    monkeypatch.setenv("MJ_DEPLOYMENT", "remote")
    want = mj.decode(data)
    _equal(mjt.decode(data, device="cuda"), want)
    _equal(mjt.decode_many([data, data], device="cuda"), [want, want])
    assert len(card) == 2
