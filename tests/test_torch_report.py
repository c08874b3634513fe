"""Progress and trace reporting (codec/report.py) of the port on the CPU
against the JAX package's: the whole (completed, total, desc) sequence
and the trace lines of encode() (the host engine on both sides, no JAX
compile) and of encode_many of one image (the batched route), the final
count and sorted descriptions of a group of three, the arithmetic
trellis, the Python scan search (MJ_NATIVE_SCANSEARCH=0), the port's
per-image route, and two threads that encode at once with their own
reporters."""
import threading

import numpy as np
import pytest

import mozjpeg_tpu as mj
import mozjpeg_tpu_torch as mjt
from test_torch_decode import _photo


def _run(fn, *args, **kw):
    """(output, progress events, trace lines) of one reported call."""
    events, lines = [], []
    out = fn(*args, progress=lambda c, t, d: events.append((c, t, d)),
             trace=lines.append, **kw)
    return out, events, lines


def _both(fn_name, imgs, **cfg):
    jax_fn, port_fn = getattr(mj, fn_name), getattr(mjt, fn_name)
    arg = imgs if fn_name == "encode_many" else imgs[0]
    a = _run(jax_fn, arg, mj.EncoderConfig(**cfg))
    b = _run(port_fn, arg, mjt.EncoderConfig(**cfg), device="cpu")
    return a, b


@pytest.fixture(scope="module")
def img():
    return _photo(48, 64, 31)


@pytest.mark.parametrize("cfg", [
    pytest.param({"quality": 75}, id="default"),
    pytest.param({"quality": 75, "progressive": False}, id="sequential"),
    pytest.param({"quality": 75, "optimize_scans": False}, id="script"),
    pytest.param({"quality": 90, "trellis_quant": False}, id="notrellis"),
    pytest.param({"quality": 75, "arithmetic": True}, id="arith-trellis"),
    pytest.param({"quality": 75, "arithmetic": True, "progressive": False,
                  "restart_interval": 3}, id="arith-seq")])
def test_encode_reports_like_jax(img, cfg):
    a, b = _both("encode", [img], **cfg)
    assert a[0] == b[0]
    assert a[1] == b[1] and a[2] == b[2]
    # the search's early exits skip candidates: completed may end short
    assert b[1] and all(c <= t for c, t, _ in b[1])
    if cfg.get("progressive", True) and cfg.get("optimize_scans", True):
        assert any(line.startswith("SCAN ") for line in b[2])


def test_gray_encode_reports_like_jax(img):
    a, b = _both("encode", [img[..., 1]], quality=75)
    assert a == b


def test_python_scan_search_reports_like_jax(img, monkeypatch):
    monkeypatch.setenv("MJ_NATIVE_SCANSEARCH", "0")
    a, b = _both("encode", [img], quality=75)
    assert a[0] == b[0] and a[1] == b[1] and a[2] == b[2]
    assert sum(d.startswith("candidate scan") for _, _, d in b[1]) > 20
    # the Python search writes what the native one writes
    monkeypatch.setenv("MJ_NATIVE_SCANSEARCH", "1")
    assert mjt.encode(img, mjt.EncoderConfig(quality=75),
                      device="cpu") == b[0]


def test_encode_many_one_image_reports_like_jax(img):
    a, b = _both("encode_many", [img], quality=75)
    assert a == b
    assert [d for _, _, d in b[1]] == ["scan search (native)", "entropy"]


def test_encode_many_group_final_count_like_jax(img):
    imgs = [img, _photo(48, 64, 32), _photo(48, 64, 33)]
    a, b = _both("encode_many", imgs, quality=75)
    assert a[0] == b[0]
    assert a[1][-1][:2] == b[1][-1][:2] == (6, 6)
    assert sorted(d for _, _, d in a[1]) == sorted(d for _, _, d in b[1])
    assert sorted(a[2]) == sorted(b[2])


def test_per_image_route_reports_main_and_trellis(img, monkeypatch):
    """trellis_q_opt is not batched: the port's per-image route (the host
    engine turned off) reports the passes of the JAX package's per-image
    route, which for one image are its host engine's."""
    a = _run(mj.encode, img, mj.EncoderConfig(quality=75,
                                              trellis_q_opt=True))
    monkeypatch.setenv("MJ_HOST_ENGINE", "0")
    b = _run(mjt.encode_many, [img], mjt.EncoderConfig(
        quality=75, trellis_q_opt=True), device="cpu")
    assert [a[0]] == b[0] and a[1] == b[1] and a[2] == b[2]
    assert [d for _, _, d in b[1]][:2] == ["main", "trellis"]


def test_threads_keep_their_own_reporters(img):
    imgs = [img, _photo(48, 64, 34)]
    alone = [_run(mjt.encode, im, mjt.EncoderConfig(quality=75),
                  device="cpu") for im in imgs]
    got = [None, None]
    barrier = threading.Barrier(2)

    def work(k):
        barrier.wait()
        got[k] = _run(mjt.encode_many, [imgs[k]],
                      mjt.EncoderConfig(quality=75), device="cpu")

    ts = [threading.Thread(target=work, args=(k,)) for k in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
        assert not t.is_alive()
    for k in range(2):
        out, events, lines = got[k]
        assert out == [alone[k][0]]
        assert [e[:2] for e in events] == [(1, 2), (2, 2)]
        assert lines == alone[k][2]


def test_no_reporter_no_calls(img):
    """Without callbacks nothing is installed; the bytes are the same."""
    out, events, _ = _run(mjt.encode, img, mjt.EncoderConfig(quality=75),
                          device="cpu")
    assert events and out == mjt.encode(img, mjt.EncoderConfig(quality=75),
                                        device="cpu")
    assert np.frombuffer(out[:2], np.uint8).tolist() == [0xFF, 0xD8]
