"""The port's spans (codec/stages.py) on the CPU, without a JAX oracle.

- A traced encode_many records its spans as a tree: on the calling
  thread each child lies within its parent and the self times tile the
  call (portbench/core/spans.py's helper), and every image's span on its
  pool thread carries its call's id and the native search's counters.
- Traced and untraced calls give the same bytes; an untraced call
  records nothing and never reads the span clock, while stage(times)
  still sums its synchronised seconds.
- Spans from more threads than cores, switching every microsecond, are
  all kept once, with unique ids, in the block's list and the buffer.
- The native search's candidate counter equals the get_size calls of the
  Python search on the same planes (gray and YCbCr), and the search
  gives the same bytes with and without its counters.
"""
import contextvars
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import mozjpeg_tpu_torch as mjt
from mozjpeg_tpu_torch import native
from mozjpeg_tpu_torch.codec import scanopt, stages
from portbench.core import spans as pspans

SHAPES = {"gray": (48, 64), "ycbcr": (48, 64, 3)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images(kind, n=2, seed=0):
    """Smooth seeded photos with some texture (the scan search's early
    exits then depend on the content)."""
    rng = np.random.default_rng([seed, len(SHAPES[kind])])
    h, w = SHAPES[kind][:2]
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for _ in range(n):
        base = 128 + 60 * np.sin(xx / rng.uniform(3, 9) + yy / 7.0)
        img = base[..., None] + rng.normal(0, 12, SHAPES[kind][:2] + (3,))
        img = np.clip(img, 0, 255).astype(np.uint8)
        out.append(img[..., 0] if kind == "gray" else img)
    return out


@pytest.fixture(scope="module")
def runs():
    """Per kind: the untraced bytes, the traced bytes, the traced spans
    and the arguments of each native search call."""
    out = {}
    for kind in SHAPES:
        imgs = _images(kind)
        plain = mjt.encode_many(imgs, device="cpu")
        searches = []
        real = scanopt.encode_optimize_scans_native

        def record(*a, **kw):
            searches.append((a, kw))
            return real(*a, **kw)
        scanopt.encode_optimize_scans_native = record
        try:
            with stages.tracing() as got:
                traced = mjt.encode_many(imgs, device="cpu")
        finally:
            scanopt.encode_optimize_scans_native = real
        out[kind] = (plain, traced, list(got), searches)
    return out


@pytest.mark.parametrize("kind", list(SHAPES))
def test_tracing_keeps_the_bytes(runs, kind):
    plain, traced, _, _ = runs[kind]
    assert traced == plain and all(o[:2] == b"\xff\xd8" for o in plain)


@pytest.mark.parametrize("kind", list(SHAPES))
def test_spans_nest_and_pool_spans_join_their_call(runs, kind):
    _, _, got, _ = runs[kind]
    calls = [s for s in got if s.name == "enc.call"]
    assert len(calls) == 1
    call = calls[0]
    assert call.parent == 0 and call.attrs == {
        "images": 2, "pixels": 2 * 48 * 64}
    by_id = {s.id: s for s in got}
    names = {s.name for s in got}
    assert {"enc.group", "enc.prep", "enc.upload", "enc.p1",
            "enc.trellis_ac", "enc.download", "enc.download_copy",
            "enc.host_entropy", "enc.entropy_wait"} <= names
    for s in got:
        assert s.call == call.id and s.start_ns <= s.end_ns
        if s is not call:
            assert s.parent in by_id
    for s in got:
        p = by_id.get(s.parent)
        if p is not None and p.thread == s.thread:
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    assert by_id[[s for s in got if s.name == "enc.upload"][0].parent] \
        .name == "enc.prep"
    assert by_id[[s for s in got if s.name == "enc.download_copy"][0]
                 .parent].name == "enc.download"
    imgs = [s for s in got if s.name == "enc.entropy_image"]
    assert sorted(s.attrs["image"] for s in imgs) == [0, 1]
    for s in imgs:
        assert s.thread != call.thread
        assert by_id[s.parent].name == "enc.host_entropy"
        assert s.attrs["queued_ns"] >= 0 and s.attrs["candidates"] > 0
        assert all(s.attrs[k] > 0 for k in native.SEARCH_STATS)


@pytest.mark.parametrize("kind", list(SHAPES))
def test_caller_spans_tile_the_call(runs, kind):
    _, _, got, _ = runs[kind]
    call = [s for s in got if s.name == "enc.call"][0]
    caller = [s for s in got if s.thread == call.thread]
    own = pspans.self_ns(caller)
    assert all(v >= 0 for v in own.values())
    assert sum(own.values()) == call.end_ns - call.start_ns
    w = pspans.Window([call], got, call.attrs["pixels"] / 1e6)
    by_layer = pspans.caller_ns(w)
    assert sum(by_layer.values()) == call.end_ns - call.start_ns
    assert by_layer["upload"] > 0 and by_layer["entropy_wait"] > 0


@pytest.mark.parametrize("kind", list(SHAPES))
def test_candidates_equal_the_python_searchs_get_size_calls(
        runs, kind, monkeypatch):
    _, _, got, searches = runs[kind]
    native_counts = sorted(s.attrs["candidates"] for s in got
                           if s.name == "enc.entropy_image")
    counts = []
    real = scanopt._run_selection

    def counting(layout, script, get_size):
        n = [0]

        def sized(sn, scan):
            n[0] += 1
            return get_size(sn, scan)
        res = real(layout, script, sized)
        counts.append(n[0])
        return res
    monkeypatch.setattr(scanopt, "_run_selection", counting)
    monkeypatch.setenv("MJ_NATIVE_SCANSEARCH", "0")
    out = mjt.encode_many(_images(kind), device="cpu")
    assert out == runs[kind][0]
    assert sorted(counts) == native_counts
    # the search visits fewer than its whole script, by its early exits
    assert all(n < (64 if kind == "ycbcr" else 23) for n in counts)


@pytest.mark.parametrize("nthreads", [1, 4])
def test_native_counters_keep_the_bytes(runs, nthreads):
    a, kw = runs["ycbcr"][3][0]
    a = a[:9] + (nthreads,) + a[10:]
    plain = scanopt.encode_optimize_scans_native(*a, **kw)
    with stages.tracing() as got:
        with stages.call("test.call") as sp:
            counted = scanopt.encode_optimize_scans_native(*a, **kw)
    assert counted == plain
    assert got[0].name == "test.call" and sp.attrs["candidates"] > 0
    serial = [s.attrs["candidates"] for s in runs["ycbcr"][2]
              if s.name == "enc.entropy_image"]
    if nthreads == 1:
        assert sp.attrs["candidates"] in serial
    else:
        # threads also code ahead the candidates the early exits skip
        assert sp.attrs["candidates"] >= min(serial)


def test_untraced_calls_record_nothing_and_read_no_clock(monkeypatch):
    reads = []
    monkeypatch.setattr(stages, "_clock", lambda: reads.append(1) or 0)
    stages.clear_spans()
    imgs = _images("ycbcr", n=1, seed=1)
    mjt.encode_many(imgs, device="cpu")
    assert reads == [] and stages.recent_spans() == []
    assert stages.span("enc.x", bytes=1) is stages.call("enc.y")
    assert stages.current() is None
    times = {}
    for _ in range(2):
        with stages.stage(times, "prep", "cpu") as sp:
            assert not sp
            first = times.get("prep", 0.0)
    assert times["prep"] > first > 0
    assert reads == [] and stages.recent_spans() == []
    with stages.tracing() as got:
        mjt.encode_many(imgs, device="cpu")
    assert reads and got == stages.recent_spans()


def test_spans_from_many_threads_are_all_kept():
    threads, each = 32, 200

    def work(k):
        for _ in range(each):
            with stages.span("test.span", k=k):
                pass
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    stages.clear_spans()
    try:
        with stages.tracing() as got:
            with stages.call("test.call") as root:
                with ThreadPoolExecutor(threads) as pool:
                    futs = [pool.submit(contextvars.copy_context().run,
                                        work, k) for k in range(threads)]
                    for f in futs:
                        f.result(timeout=60)
    finally:
        sys.setswitchinterval(old)
    n = threads * each + 1
    assert len(got) == n and len({s.id for s in got}) == n
    assert all(s.call == root.id for s in got)
    assert sorted(stages.recent_spans()) == sorted(got)
