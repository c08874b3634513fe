"""Stage times and spans of an encode.

stage(times, name, device) synchronises the device before and after its
body and adds the seconds to times[name]; with times=None it does
nothing of the kind, so the normal path pays no synchronisation.

Spans say where one traced encode_many call spent its host time. The
call opens the root span "enc.call"; each stage inside it records
"enc.<stage>" and span(name, **attrs) the boundaries that have no stage.
A call is traced inside `with tracing() as spans:` (the block's spans
are appended to `spans` as each ends) and while the torch profiler runs
on the calling thread; every other call records nothing. A span holds
its name, start and end on time.perf_counter_ns(), its id, its
parent's id, its call's id, the thread it ran on and a few integer
attributes. The open span travels in a ContextVar, so a task that the
call hands to a pool through contextvars.copy_context().run joins the
call by itself. On the calling thread under the profiler each span also
opens a torch.profiler.record_function of its name, which puts it on
the device trace's clock. The spans of traced calls are kept in a
bounded process-wide buffer (recent_spans()). With tracing off a span
costs one ContextVar lookup: no clock read, no allocation, no lock.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch

BUFFER_SPANS = 1 << 16      # the newest spans recent_spans() keeps


class Span(NamedTuple):
    """One ended span."""
    name: str
    start_ns: int               # time.perf_counter_ns()
    end_ns: int
    id: int
    parent: int                 # 0 for a call's root span
    call: int                   # the id of its call's root span
    thread: int                 # threading.get_ident() of its thread
    attrs: Dict[str, int]


_clock = time.perf_counter_ns
_ids = itertools.count(1)
_recent: collections.deque = collections.deque(maxlen=BUFFER_SPANS)
_recent_lock = threading.Lock()
_current: contextvars.ContextVar[Optional["_Open"]] = \
    contextvars.ContextVar("mozjpeg_tpu_torch_span", default=None)
_sink: contextvars.ContextVar[Optional[list]] = \
    contextvars.ContextVar("mozjpeg_tpu_torch_tracing", default=None)


class _Off:
    """The span of an untraced call: enters, sets and ends as nothing,
    and is false."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def set(self, **attrs):
        pass

    def now(self) -> Optional[int]:
        return None


_OFF = _Off()


class _Open:
    """A span of a traced call, recorded when it ends."""
    __slots__ = ("name", "id", "parent", "call", "attrs", "sink", "caller",
                 "profiled", "start", "thread", "_token", "_range")

    def __init__(self, name: str, parent: Optional["_Open"], attrs,
                 sink=None, profiled: bool = False):
        self.name, self.attrs = name, attrs
        self.id = next(_ids)
        if parent is None:
            self.parent, self.call = 0, self.id
            self.sink, self.profiled = sink, profiled
            self.caller = threading.get_ident()
        else:
            self.parent, self.call = parent.id, parent.call
            self.sink, self.profiled = parent.sink, parent.profiled
            self.caller = parent.caller

    def __bool__(self):
        return True

    def set(self, **attrs):
        """Add integer attributes to the span."""
        self.attrs.update(attrs)

    def add(self, **counts):
        """Add to integer attributes of the span (from 0 where absent)."""
        for k, v in counts.items():
            self.attrs[k] = self.attrs.get(k, 0) + v

    def now(self) -> int:
        """The span clock's time, to stamp an event inside the span."""
        return _clock()

    def __enter__(self):
        self.thread = threading.get_ident()
        self._range = None
        if self.profiled and self.thread == self.caller:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._token = _current.set(self)
        self.start = _clock()
        return self

    def __exit__(self, *exc):
        end = _clock()
        _current.reset(self._token)
        if self._range is not None:
            self._range.__exit__(*exc)
        done = Span(self.name, self.start, end, self.id, self.parent,
                    self.call, self.thread, self.attrs)
        with _recent_lock:
            _recent.append(done)
        if self.sink is not None:
            self.sink.append(done)
        return False


def _profiler_on() -> bool:
    return torch._C._autograd._profiler_enabled()


def call(name: str, **attrs):
    """The root span of one operator call: recorded inside tracing() or
    while the torch profiler runs on this thread (a call inside another
    traced call is a span of that call), else the null span."""
    cur = _current.get()
    if cur is not None:
        return _Open(name, cur, attrs)
    sink = _sink.get()
    profiled = _profiler_on()
    if sink is None and not profiled:
        return _OFF
    return _Open(name, None, attrs, sink, profiled)


def span(name: str, **attrs):
    """A span inside the current traced call, else the null span."""
    cur = _current.get()
    if cur is None:
        return _OFF
    return _Open(name, cur, attrs)


def current():
    """The innermost open span of a traced call, else None."""
    return _current.get()


@contextlib.contextmanager
def tracing():
    """Trace the calls made inside the block, with the tasks they hand to
    their pools: yields the list that each of their spans is appended to
    as it ends."""
    spans: List[Span] = []
    tok = _sink.set(spans)
    try:
        yield spans
    finally:
        _sink.reset(tok)


def recent_spans() -> List[Span]:
    """The newest BUFFER_SPANS spans of traced calls, oldest first."""
    with _recent_lock:
        return list(_recent)


def clear_spans():
    with _recent_lock:
        _recent.clear()


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def stage(times, name: str, device):
    """The stage `name` of a traced call records the span "enc.<name>"
    (without synchronising); with `times` (dict) the stage synchronises
    the device before and after its body and adds its seconds to
    times[name]. Enters as the span (the null span when untraced)."""
    cur = _current.get()
    sp = _OFF if cur is None else _Open("enc." + name, cur, {})
    if times is None:
        return sp
    return _timed(times, name, device, sp)


@contextlib.contextmanager
def _timed(times, name: str, device, sp):
    with sp:
        _sync(device)
        t0 = time.perf_counter()
        try:
            yield sp
        finally:
            _sync(device)
            times[name] = times.get(name, 0.0) + time.perf_counter() - t0
