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
  gives the same bytes with and without its counters; its AC coders
  count the blocks they walk and those with an empty band.
- The native search's shared workers give the Python search's bytes and
  candidate counts for any number of searches in flight on any number of
  workers, with and without restarts, and under three threads calling
  encode_many at once; they code ahead only without restarts, and a lone
  image's idle workers do; a group's images all enter the search at once.
"""
import contextvars
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import mozjpeg_tpu_torch as mjt
from mozjpeg_tpu_torch import native
from mozjpeg_tpu_torch.codec import encoder, pipeline, scanopt, stages
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
        assert all(s.attrs[k] > 0 for k in native.SEARCH_STATS[:5])
        assert 0 <= s.attrs["ahead_unused"] <= s.attrs["ahead"]


@pytest.mark.parametrize("kind", list(SHAPES))
def test_traced_searches_count_the_blocks_they_walk(runs, kind):
    """The AC candidates' gather and emission passes count every block
    they walk, and those whose band is empty, with the bytes unchanged:
    in gray, each coded candidate but the DC one walks the 6x8 blocks
    twice."""
    plain, traced, got, _ = runs[kind]
    assert traced == plain
    imgs = [s.attrs for s in got if s.name == "enc.entropy_image"]
    assert len(imgs) == 2
    for a in imgs:
        assert 0 < a["zero_blocks"] < a["blocks"]
        if kind == "gray":
            coded = a["candidates"] + a["ahead_unused"]
            assert a["blocks"] == 2 * 48 * (coded - 1)


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
    with native.SearchWorkers(nthreads) as workers:
        kw = dict(kw, workers=workers)
        plain = scanopt.encode_optimize_scans_native(*a, **kw)
        with stages.tracing() as got:
            with stages.call("test.call") as sp:
                counted = scanopt.encode_optimize_scans_native(*a, **kw)
    assert counted == plain
    assert got[0].name == "test.call" and sp.attrs["candidates"] > 0
    serial = [s.attrs["candidates"] for s in runs["ycbcr"][2]
              if s.name == "enc.entropy_image"]
    # the selection reads the same candidates whoever codes them
    assert sp.attrs["candidates"] in serial
    if nthreads == 1:
        assert sp.attrs["ahead"] == 0


def _made(kind, n, restart, seed=0, h=48, w=64):
    """n searches' arguments over seeded coefficient planes (a wandering
    DC, AC thinning out with frequency at a rate of the image's own, so
    the early exits differ from image to image), with restart_in_rows=1
    (each scan its own interval) or none."""
    shape = SHAPES[kind][2:]
    cfg = mjt.EncoderConfig(quality=75, restart_in_rows=int(restart))
    ctx = encoder.resolve_group(np.zeros((h, w) + shape, np.uint8), cfg)
    geom = pipeline.geometry(w, h, ctx.samp)
    rng = np.random.default_rng([seed, ctx.ncomps, int(restart)])
    out = []
    for _ in range(n):
        planes = []
        for g in geom[2][:ctx.ncomps]:
            dims = (g.bh_pad, g.bw_pad)
            p = np.zeros(dims + (64,), np.int16)
            p[..., 0] = np.clip(np.cumsum(rng.integers(-40, 41, dims), 1)
                                + rng.integers(-200, 200), -1023, 1023)
            scale = rng.uniform(2, 40) * np.exp(
                -np.arange(1, 64) / rng.uniform(2, 16))
            p[..., 1:] = np.clip(np.rint(rng.laplace(0, scale, dims + (63,))),
                                 -1023, 1023)
            planes.append(p)
        out.append((w, h, geom, planes, ctx.qtables, ctx.cfg, ctx.ncomps,
                    encoder._frame_slots(ctx), 8))
    return out


@pytest.fixture(scope="module")
def made():
    """Per kind and restarts: nine searches' arguments, the Python
    search's bytes of each and its get_size calls."""
    out = {}
    real = scanopt._run_selection
    for kind in SHAPES:
        for restart in (False, True):
            args, counts = _made(kind, 9, restart), []

            def counting(layout, script, get_size):
                n = [0]

                def sized(sn, scan):
                    n[0] += 1
                    return get_size(sn, scan)
                res = real(layout, script, sized)
                counts.append(n[0])
                return res
            scanopt._run_selection = counting
            try:
                want = [scanopt.encode_optimize_scans(*a) for a in args]
            finally:
                scanopt._run_selection = real
            out[kind, restart] = (args, want, counts)
    return out


def _searched(args, workers):
    """Each search on its own thread, all released at once -> (bytes,
    counters) of each."""
    got = [None] * len(args)
    ready = threading.Barrier(len(args), timeout=60)

    def one(i):
        ready.wait()
        with stages.tracing(), stages.call("test.search") as sp:
            data = scanopt.encode_optimize_scans_native(*args[i],
                                                        workers=workers)
        got[i] = (data, dict(sp.attrs))
    with ThreadPoolExecutor(len(args)) as pool:
        for f in [pool.submit(one, i) for i in range(len(args))]:
            f.result(timeout=60)
    return got


SCHEDULES = ([(kind, restart, n, nw) for kind in SHAPES
              for restart in (False, True) for n in (1, 3, 9)
              for nw in (1, 2, 8)]
             + [(kind, False, "encode_many x3", None) for kind in SHAPES])


@pytest.mark.parametrize("kind,restart,images,workers", SCHEDULES)
def test_shared_workers_give_the_python_searchs_bytes(
        made, runs, monkeypatch, kind, restart, images, workers):
    if workers is None:
        # three callers of encode_many share the process's workers
        imgs = _images(kind)
        monkeypatch.setenv("MJ_NATIVE_SCANSEARCH", "0")
        want = mjt.encode_many(imgs, device="cpu")
        monkeypatch.delenv("MJ_NATIVE_SCANSEARCH")
        ready = threading.Barrier(3, timeout=60)

        def call(_):
            ready.wait()
            return mjt.encode_many(imgs, device="cpu")
        with ThreadPoolExecutor(3) as pool:
            got = [f.result(timeout=120)
                   for f in [pool.submit(call, k) for k in range(3)]]
        assert got == [want] * 3 and want == runs[kind][0]
        return
    args, want, counts = made[kind, restart]
    with native.SearchWorkers(workers) as w:
        got = _searched(args[:images], w)
    for (data, st), b, n in zip(got, want, counts):
        assert data == b
        # the candidates the selection read, even where workers idled
        assert st["candidates"] == n
        assert 0 <= st["ahead_unused"] <= st["ahead"]
        if restart or workers == 1:
            assert st["ahead"] == 0


def test_a_lone_image_codes_ahead_on_idle_workers():
    """A restart-free 1024x768 search on four workers: the three the
    selection leaves idle code ahead, and the bytes and the candidates
    read are the one worker's."""
    (a,) = _made("ycbcr", 1, False, seed=5, h=768, w=1024)
    got = {}
    for n in (1, 4):
        with native.SearchWorkers(n) as w:
            got[n] = _searched([a], w)[0]
    assert got[4][0] == got[1][0]
    assert got[4][1]["candidates"] == got[1][1]["candidates"]
    assert got[1][1]["ahead"] == 0 and got[4][1]["ahead"] > 0


def test_a_groups_images_all_enter_the_search_at_once(monkeypatch):
    """Each image's entropy task waits at a barrier of GROUP parties, so
    the call ends only if all of them start before any finishes."""
    entered = threading.Barrier(encoder.GROUP, timeout=30)
    real = encoder.entropy_image

    def held(*a, **kw):
        entered.wait()
        return real(*a, **kw)
    monkeypatch.setattr(encoder, "entropy_image", held)
    imgs = _images("ycbcr", n=encoder.GROUP, seed=2)
    with stages.tracing() as got:
        out = mjt.encode_many(imgs, device="cpu")
    assert all(o[:2] == b"\xff\xd8" for o in out)
    spans = [s for s in got if s.name == "enc.entropy_image"]
    assert len(spans) == encoder.GROUP
    assert max(s.start_ns for s in spans) < min(s.end_ns for s in spans)


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
