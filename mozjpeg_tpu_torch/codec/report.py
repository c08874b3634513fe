"""Progress reporting and message tracing.

Port of mozjpeg_tpu/codec/report.py (pure Python, copied): the analog of
mozjpeg's two observability channels, the `jpeg_progress_mgr` callback
updated per pass (jcmaster.c:711-714, cdjpeg.c:29-59 progress_monitor)
and the error manager's trace stream (the "SCAN c: Ss Se Ah Al" lines of
jcmaster.c:747-754).

The encoder is a phase pipeline, not a scanline loop, so progress counts
passes: the main pass, the trellis pass, each output scan, each candidate
scan of the Python scan search, one pass for the native scan search and
one for each image's entropy stage in a batched group. The total grows as
the phases find their pass counts (monotone, where the reference computes
a static total).

The hooks live in a ContextVar set by the `reporting` context manager, so
concurrent encodes on different threads do not see each other's reports.
A ContextVar does not follow a task into a pool thread by itself: the
encoder submits its pool tasks through contextvars.copy_context().run.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Optional


class Reporter:
    """Collects the progress and trace callbacks of one encode call."""

    __slots__ = ("progress", "trace_fn", "trace_level", "completed", "total")

    def __init__(self, progress: Optional[Callable] = None,
                 trace: Optional[Callable] = None, trace_level: int = 0):
        self.progress = progress
        self.trace_fn = trace
        self.trace_level = trace_level if trace is not None else 0
        self.completed = 0
        self.total = 0


_current: contextvars.ContextVar[Optional[Reporter]] = \
    contextvars.ContextVar("mozjpeg_tpu_torch_reporter", default=None)


@contextlib.contextmanager
def reporting(progress: Optional[Callable] = None,
              trace: Optional[Callable] = None, trace_level: int = 1):
    """Install the progress and trace hooks for the enclosed encode.

    progress(completed_passes, total_passes, desc) is called after each
    pass; trace(message) receives the reference's trace lines when
    trace_level > 0.
    """
    if progress is None and trace is None:
        yield None
        return
    rep = Reporter(progress, trace, trace_level)
    tok = _current.set(rep)
    try:
        yield rep
    finally:
        _current.reset(tok)


def add_passes(n: int) -> None:
    rep = _current.get()
    if rep is not None:
        rep.total += n


def pass_done(desc: str = "") -> None:
    rep = _current.get()
    if rep is not None:
        rep.completed += 1
        if rep.total < rep.completed:
            rep.total = rep.completed
        if rep.progress is not None:
            rep.progress(rep.completed, rep.total, desc)


def trace(level: int, msg: str) -> None:
    """Emit a trace message at the given level (the TRACEMS analog)."""
    rep = _current.get()
    if rep is not None and rep.trace_fn is not None \
            and rep.trace_level >= level:
        rep.trace_fn(msg)


def trace_scan(comps, Ss: int, Se: int, Ah: int, Al: int) -> None:
    """The reference's scan trace line (jcmaster.c:747-754):
    'SCAN c[,c...]: Ss Se Ah Al'."""
    trace(1, "SCAN %s: %d %d %d %d"
          % (",".join(str(c) for c in comps), Ss, Se, Ah, Al))
