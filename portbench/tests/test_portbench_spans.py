"""The span readers (metrics/enc.span.*.py over core/spans.py) on hand-made
spans: the calls outside the window are left out, the caller's layers
tile the calls, and a run without spans reads None; and a traced run on
the CPU reports every one of them."""
from collections import namedtuple
from types import SimpleNamespace

import pytest

from portbench.core import harness, registry, spans, window
from portbench_util import CONFIG, E2E, PER_LAYER, TINY_SUITE

S = namedtuple("S", "name start_ns end_ns id parent call thread attrs")
NAMES = ["enc.span.prep_ms_per_mp", "enc.span.upload_ms_per_mp",
         "enc.span.launch_ms_per_mp", "enc.span.download_ms_per_mp",
         "enc.span.entropy_wait_ms_per_mp",
         "enc.span.unattributed_ms_per_mp",
         "enc.span.entropy_cpu_ms_per_mp", "enc.span.entropy_threads",
         "enc.span.search_candidates", "enc.span.search_gather_ms_per_mp",
         "enc.span.search_emit_ms_per_mp"]


def _call(t0, first_id, candidates, scale=1):
    """One call of 1 MP at t0 (ns): 10,000 ns on thread 10, two images on
    threads 20 and 21."""
    i = first_id
    rows = [  # name, start, end, parent (offset from i), thread, attrs
        ("enc.call", 1000, 11000, None, 10, {"images": 2,
                                              "pixels": 1_000_000}),
        ("enc.group", 1100, 4150, 0, 10, {"images": 2}),
        ("enc.prep", 1200, 2200, 1, 10, {}),
        ("enc.upload", 1700, 2100, 2, 10, {"bytes": 9}),
        ("enc.p1", 2300, 2500, 1, 10, {}),
        ("enc.trellis_ac", 2500, 2800, 1, 10, {}),
        ("enc.download", 3000, 4000, 1, 10, {"bytes": 9}),
        ("enc.download_copy", 3100, 3900, 6, 10, {"bytes": 9}),
        ("enc.host_entropy", 4000, 4100, 1, 10, {}),
        ("enc.entropy_wait", 4200, 10500, 0, 10, {}),
        ("enc.entropy_image", 4050, 8050, 8, 20,
         {"image": 0, "candidates": candidates[0],
          "gather_ns": 1000 * scale, "emit_ns": 2000 * scale}),
        ("enc.entropy_image", 4060, 10060, 8, 21,
         {"image": 1, "candidates": candidates[1],
          "gather_ns": 1500 * scale, "emit_ns": 2500 * scale}),
    ]
    return [S(n, t0 + s, t0 + e, i + k, 0 if p is None else i + p, i, th, a)
            for k, (n, s, e, p, th, a) in enumerate(rows)]


def _run(t0, t1):
    return SimpleNamespace(calls=[window.Call(t0 / 1e9, t1 / 1e9, 1.0, 2)])


EXPECTED = {  # ms/MP from ns on 1 MP a call
    "enc.span.prep_ms_per_mp": 600e-6, "enc.span.upload_ms_per_mp": 400e-6,
    "enc.span.launch_ms_per_mp": 500e-6,
    "enc.span.download_ms_per_mp": 1000e-6,
    "enc.span.entropy_wait_ms_per_mp": 6400e-6,
    "enc.span.unattributed_ms_per_mp": 1100e-6,
    "enc.span.entropy_cpu_ms_per_mp": 10000e-6,
    "enc.span.entropy_threads": 10000 / 6010,
    "enc.span.search_candidates": 35.0,
    "enc.span.search_gather_ms_per_mp": 2500e-6,
    "enc.span.search_emit_ms_per_mp": 4500e-6,
}


@pytest.fixture
def made(monkeypatch):
    """Two calls in a window of 1_001_000..1_031_000 ns, one before it and
    one after it with other numbers."""
    got = (_call(950_000, 100, (90, 90), 50) + _call(1_000_000, 1, (30, 40))
           + _call(1_020_000, 20, (50, 60)) + _call(1_040_000, 200,
                                                    (90, 90), 50))
    monkeypatch.setattr(spans, "program_spans", lambda: got)
    return _run(1_001_000, 1_031_000)


@pytest.mark.parametrize("name", NAMES)
def test_reader_on_made_spans(made, name):
    got = registry._reader(registry.PKG_DIR, name)(made)
    assert got == pytest.approx(EXPECTED[name], rel=1e-9)


def test_caller_layers_add_up_to_the_calls(made):
    w = spans.window(made)
    assert [c.id for c in w.calls] == [1, 20] and w.mp == 2.0
    assert sum(spans.caller_ns(w).values()) == 2 * 10_000


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("kept", [None, []])
def test_no_spans_read_none(monkeypatch, name, kept):
    monkeypatch.setattr(spans, "program_spans", lambda: kept)
    assert registry._reader(registry.PKG_DIR, name)(
        _run(1_001_000, 1_031_000)) is None


def test_calls_outside_the_window_read_none(made):
    later = _run(2_000_000, 2_100_000)
    for name in NAMES:
        assert registry._reader(registry.PKG_DIR, name)(later) is None


def test_traced_cpu_run_reports_every_span_metric():
    cell = registry.build("tiny.encode", 1, CONFIG, "encode",
                          [{"name": n, "unit": "-"} for n in E2E],
                          [{"name": n, "unit": "-"}
                           for n in PER_LAYER + NAMES])
    t = dict(cell.traffic, pool_mp=0.001, warm_calls=1, check_images=3,
             check_workers=0, trellis_blocks=64, trellis_rows=2)
    cell = cell._replace(config=dict(cell.config, suite=TINY_SUITE),
                         traffic=t)
    out = harness.run_cell(cell, 2**33 + 5, 0.5, True, device="cpu")
    assert out["correct"] is True, out["checks"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(NAMES) <= set(m)
    caller = sum(m[n] for n in NAMES[:6])
    assert caller > 0 and m["enc.span.entropy_cpu_ms_per_mp"] > 0
    assert m["enc.span.search_candidates"] > 0
    assert m["enc.span.entropy_threads"] >= 1.0
