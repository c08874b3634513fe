"""The native scan search's readers (metrics/enc.span.search_workers_busy
and enc.span.search_ahead_unused_share) on hand-made spans: the workers'
busy ns over the union of overlapping and of disjoint image spans, the
share of candidates coded ahead and never read, and None where no image
span has the counters (the spans of a program without them)."""
from collections import namedtuple
from types import SimpleNamespace

import pytest

from portbench.core import registry, spans, window

S = namedtuple("S", "name start_ns end_ns id parent call thread attrs")
BUSY = "enc.span.search_workers_busy"
UNUSED = "enc.span.search_ahead_unused_share"


def _call(images):
    """One call of 1 MP over 1,000..11,000 ns on thread 10, with an
    "enc.entropy_image" span per (start, end, attrs) on threads 20 on."""
    got = [S("enc.call", 1000, 11000, 1, 0, 1, 10,
             {"images": len(images), "pixels": 1_000_000}),
           S("enc.host_entropy", 1500, 1600, 2, 1, 1, 10, {})]
    for k, (b, e, attrs) in enumerate(images):
        got.append(S("enc.entropy_image", b, e, 3 + k, 2, 1, 20 + k,
                     dict(attrs, image=k)))
    return got


def _read(monkeypatch, name, images):
    monkeypatch.setattr(spans, "program_spans", lambda: _call(images))
    run = SimpleNamespace(calls=[window.Call(1e-6, 11e-6, 1.0, 1)])
    return registry._reader(registry.PKG_DIR, name)(run)


def _counters(gather, tables, emit, candidates=40, ahead=0, unused=0):
    return {"gather_ns": gather, "tables_ns": tables, "emit_ns": emit,
            "candidates": candidates, "ahead": ahead,
            "ahead_unused": unused, "queued_ns": 5}


@pytest.mark.parametrize("images,union", [
    # overlapping: 2,000..8,000
    ([(2000, 6000, _counters(1000, 10, 2000)),
      (4000, 8000, _counters(3000, 20, 2990))], 6000),
    # disjoint: 2,000 + 3,000
    ([(2000, 4000, _counters(1000, 10, 2000)),
      (6000, 9000, _counters(3000, 20, 2990))], 5000),
    # one inside the other, and a span without the counters left out of
    # the union
    ([(2000, 9000, _counters(1000, 10, 2000)),
      (3000, 5000, _counters(3000, 20, 2990)),
      (9500, 10500, {"queued_ns": 5})], 7000),
])
def test_workers_busy_over_the_union(monkeypatch, images, union):
    assert _read(monkeypatch, BUSY, images) == pytest.approx(
        (1000 + 10 + 2000 + 3000 + 20 + 2990) / union, rel=1e-12)


def test_ahead_unused_share(monkeypatch):
    images = [(2000, 6000, _counters(1, 1, 1, candidates=40, ahead=5,
                                     unused=2)),
              (4000, 8000, _counters(1, 1, 1, candidates=30))]
    assert _read(monkeypatch, UNUSED, images) == pytest.approx(
        100.0 * 2 / (40 + 2 + 30), rel=1e-12)


@pytest.mark.parametrize("name", [BUSY, UNUSED])
@pytest.mark.parametrize("attrs", [
    {"queued_ns": 5},                       # no search counters at all
    {"candidates": 40, "gather_ns": 9, "emit_ns": 9, "queued_ns": 5},
])
def test_none_without_the_counters(monkeypatch, name, attrs):
    """An untraced search's spans, and the parent's spans for the share
    (they carry no ahead_unused) and for the busy workers where a counter
    is missing, read None."""
    assert _read(monkeypatch, name, [(2000, 6000, attrs),
                                     (4000, 8000, attrs)]) is None


@pytest.mark.parametrize("name", [BUSY, UNUSED])
@pytest.mark.parametrize("kept", [None, []])
def test_no_spans_read_none(monkeypatch, name, kept):
    monkeypatch.setattr(spans, "program_spans", lambda: kept)
    run = SimpleNamespace(calls=[window.Call(1e-6, 11e-6, 1.0, 1)])
    assert registry._reader(registry.PKG_DIR, name)(run) is None
