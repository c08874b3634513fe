"""The program's spans of the traced window's encode calls, and what the
per-layer readers (metrics/enc.span.*.py) take from them.

The port keeps the spans of its traced calls in a bounded buffer
(mozjpeg_tpu_torch.codec.stages.recent_spans(); the torch profiler that
runs over a traced window traces them). A call is a tree of spans on its
calling thread rooted at "enc.call", with one "enc.entropy_image" span
an image on the pool threads. A span's self time is its duration less
the part of it that its children on its own thread cover, so on the
calling thread the self times of a call's spans add up to the call's
time, and each falls to one layer (CALLER_LAYERS). A program without
the buffer, or a window without traced calls, reads None.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional

from . import trace

CALL = "enc.call"
IMAGE = "enc.entropy_image"
# a call span may start and end this far outside the window's own clock
# readings (its calls' starts and ends in seconds, as floats)
SLACK_NS = 1000
# the calling thread's layers, in the order they tile a call
CALLER_LAYERS = ("prep", "upload", "launch", "download", "entropy_wait",
                 "unattributed")


class Window(NamedTuple):
    calls: list         # the window's "enc.call" spans, oldest first
    spans: list         # every span of those calls
    mp: float           # the calls' megapixels


def program_spans() -> Optional[list]:
    """The port's recent spans, or None where it keeps none."""
    try:
        from mozjpeg_tpu_torch.codec import stages
    except ImportError:
        return None
    read = getattr(stages, "recent_spans", None)
    return None if read is None else read()


def window(run, spans: Optional[list] = None) -> Optional[Window]:
    """The spans of the calls that lie within the run's window, from the
    first call's start to the last call's end (perf_counter), or None."""
    if not run.calls:
        return None
    if spans is None:
        spans = program_spans()
    if not spans:
        return None
    lo = int(run.calls[0].start * 1e9) - SLACK_NS
    hi = int(run.calls[-1].end * 1e9) + SLACK_NS
    calls = sorted((s for s in spans if s.name == CALL and s.parent == 0
                    and lo <= s.start_ns and s.end_ns <= hi),
                   key=lambda s: s.start_ns)
    mp = sum(c.attrs.get("pixels", 0) for c in calls) / 1e6
    if not calls or mp <= 0:
        return None
    ids = {c.id for c in calls}
    return Window(calls, [s for s in spans if s.call in ids], mp)


def self_ns(spans: list) -> Dict[int, int]:
    """Each span's self time: its duration less the union of its
    children's spans on its own thread, by span id."""
    by_id = {s.id: s for s in spans}
    kids = defaultdict(list)
    for s in spans:
        p = by_id.get(s.parent)
        if p is not None and p.thread == s.thread:
            kids[p.id].append((s.start_ns, s.end_ns))
    return {s.id: s.end_ns - s.start_ns - sum(
        e - b for b, e in trace.merged(trace.clip(kids[s.id], s.start_ns,
                                                  s.end_ns)))
            for s in spans}


def caller_layer(name: str) -> str:
    """The layer of a span on the calling thread."""
    if name in ("enc.prep", "enc.upload"):
        return name[4:]
    if name == "enc.p1" or name.startswith("enc.trellis_"):
        return "launch"           # p1 and the trellis, launched
    if name in ("enc.download", "enc.download_copy"):
        return "download"
    if name in ("enc.host_entropy", "enc.entropy_wait"):
        return "entropy_wait"     # submitting the images and awaiting them
    return "unattributed"         # the call and group spans' own time


def caller_ns(w: Window) -> Dict[str, int]:
    """The calling thread's self time by layer over the window's calls:
    together the calls' time."""
    own = self_ns(w.spans)
    thread = {c.id: c.thread for c in w.calls}
    out = dict.fromkeys(CALLER_LAYERS, 0)
    for s in w.spans:
        if s.thread == thread[s.call]:
            out[caller_layer(s.name)] += own[s.id]
    return out


def images(w: Window) -> List:
    return [s for s in w.spans if s.name == IMAGE]


def ms_per_mp(w: Window, ns: float) -> float:
    return ns / 1e6 / w.mp


def caller_ms_per_mp(run, layer: str) -> Optional[float]:
    w = window(run)
    return None if w is None else ms_per_mp(w, caller_ns(w)[layer])


def attr_ms_per_mp(run, attr: str) -> Optional[float]:
    """ms per megapixel of an ns attribute summed over the window's image
    spans, or None where no image span has it."""
    w = window(run)
    if w is None:
        return None
    got = [s.attrs[attr] for s in images(w) if attr in s.attrs]
    return ms_per_mp(w, sum(got)) if got else None
