"""The measured window: back-to-back calls, a closed loop of one client.

The window opens when the first call starts. Calls follow one another
until one ends at or after `seconds` past the opening; that call, in
flight when the time ran out, is the last. A rate counts whole calls:
the megapixels of every call in the window over the wall time from the
first call's start to the last call's end.
"""
from __future__ import annotations

import time
from typing import Callable, List, NamedTuple


class Call(NamedTuple):
    start: float
    end: float
    mp: float         # megapixels (width x height) the call handled
    images: int


def run(call: Callable[[int], float], seconds: float,
        clock: Callable[[], float] = time.perf_counter) -> List[Call]:
    """call(k) makes the k-th call and returns (megapixels, images)."""
    calls: List[Call] = []
    deadline = None
    k = 0
    while True:
        t0 = clock()
        if deadline is None:
            deadline = t0 + seconds
        mp, n = call(k)
        t1 = clock()
        calls.append(Call(t0, t1, mp, n))
        k += 1
        if t1 >= deadline:
            return calls


def span_s(calls: List[Call]) -> float:
    return calls[-1].end - calls[0].start


def rate_mps(calls: List[Call]) -> float:
    """Megapixels per second over the whole window."""
    return sum(c.mp for c in calls) / span_s(calls)
