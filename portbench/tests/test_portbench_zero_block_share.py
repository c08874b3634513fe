"""The native scan search's reader of the blocks its AC candidates walk
(metrics/enc.span.search_zero_block_share) on hand-made spans: the share
of walked blocks whose band was empty, summed over the images, and None
where no image span has the counters (the spans of a program whose coders
count no blocks) or where there are no spans."""
from collections import namedtuple
from types import SimpleNamespace

import pytest

from portbench.core import registry, spans, window

S = namedtuple("S", "name start_ns end_ns id parent call thread attrs")
ZERO = "enc.span.search_zero_block_share"


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


def _read(monkeypatch, images):
    monkeypatch.setattr(spans, "program_spans", lambda: _call(images))
    run = SimpleNamespace(calls=[window.Call(1e-6, 11e-6, 1.0, 1)])
    return registry._reader(registry.PKG_DIR, ZERO)(run)


def _counters(blocks, zero_blocks):
    return {"gather_ns": 1, "tables_ns": 1, "emit_ns": 1,
            "candidates": 40, "ahead": 0, "ahead_unused": 0,
            "blocks": blocks, "zero_blocks": zero_blocks, "queued_ns": 5}


@pytest.mark.parametrize("images,share", [
    # summed over the images, not averaged
    ([(2000, 6000, _counters(1000, 600)),
      (4000, 8000, _counters(3000, 300))], 100.0 * 900 / 4000),
    # an image span without the counters leaves the sums
    ([(2000, 6000, _counters(500, 500)),
      (6000, 9000, {"queued_ns": 5})], 100.0),
    # no block with an empty band
    ([(2000, 6000, _counters(700, 0))], 0.0),
])
def test_zero_block_share(monkeypatch, images, share):
    assert _read(monkeypatch, images) == pytest.approx(share, rel=1e-12)


@pytest.mark.parametrize("attrs", [
    {"queued_ns": 5},                       # no search counters at all
    {"candidates": 40, "gather_ns": 9, "emit_ns": 9, "queued_ns": 5},
    # every other counter of the search, as a program without the
    # walked-block counters writes them
    {k: v for k, v in _counters(1, 1).items()
     if k not in ("blocks", "zero_blocks")},
    _counters(0, 0),                        # nothing walked
])
def test_none_without_the_counters(monkeypatch, attrs):
    assert _read(monkeypatch, [(2000, 6000, attrs),
                               (4000, 8000, attrs)]) is None


@pytest.mark.parametrize("kept", [None, []])
def test_no_spans_read_none(monkeypatch, kept):
    monkeypatch.setattr(spans, "program_spans", lambda: kept)
    run = SimpleNamespace(calls=[window.Call(1e-6, 11e-6, 1.0, 1)])
    assert registry._reader(registry.PKG_DIR, ZERO)(run) is None
