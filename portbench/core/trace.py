"""What a torch.profiler window says: the device's busy time, each
kernel's time, and the idle gaps with what the host was doing in them.

Device operations are the kernels, copies and sets on the card; the
spans of record_function ranges on the card's timeline (the port's
"p1:..." ranges, the harness's own) are not. The window runs from the
start of the first call span to the end of the last.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

CALL_SPAN = "portbench.call"
RANGE_PREFIXES = ("p1:", "portbench.")
TOP = 10


class Ev(NamedTuple):
    name: str
    start: int        # ns
    end: int
    device: bool


class Reading(NamedTuple):
    busy_s: float
    window_s: float
    kernels: Dict[str, List[float]]      # name -> [launches, seconds]
    device_ops: List[list]               # [[name, seconds]], longest first
    idle_gaps: List[list]                # [[host label, seconds]]


def events(prof) -> List[Ev]:
    """The profile's events as Ev, from kineto's raw results (much faster
    than prof.events() on long windows)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        on_dev = e.device_type() == cuda
        if on_dev and (getattr(e, "is_user_annotation", lambda: False)()
                       or name.startswith(RANGE_PREFIXES)):
            continue
        out.append(Ev(name, start, end, on_dev))
    return out


def merged(spans: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The union of [start, end) spans as sorted disjoint spans."""
    out: List[Tuple[int, int]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def clip(spans, lo: int, hi: int):
    return [(max(s, lo), min(e, hi)) for s, e in spans
            if e > lo and s < hi]


def idle(busy: List[Tuple[int, int]], lo: int,
         hi: int) -> List[Tuple[int, int]]:
    """The gaps of [lo, hi) that the disjoint sorted spans leave."""
    out, cur = [], lo
    for s, e in busy:
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if cur < hi:
        out.append((cur, hi))
    return out


def _label(host: List[Ev], t: int) -> str:
    """The innermost host event running at time t, else the call span."""
    best: Optional[Ev] = None
    for e in host:
        if e.start <= t < e.end and e.name != CALL_SPAN and (
                best is None or e.end - e.start < best.end - best.start):
            best = e
    return best.name if best is not None else CALL_SPAN


def read(evs: List[Ev]) -> Optional[Reading]:
    """The reading of a window's events, or None without a call span."""
    calls = [e for e in evs if not e.device and e.name == CALL_SPAN]
    if not calls:
        return None
    lo = min(e.start for e in calls)
    hi = max(e.end for e in calls)
    dev = [e for e in evs if e.device]
    busy = merged(clip([(e.start, e.end) for e in dev], lo, hi))
    kernels: Dict[str, List[float]] = {}
    for e in dev:
        k = kernels.setdefault(e.name, [0, 0.0])
        k[0] += 1
        k[1] += (e.end - e.start) / 1e9
    ops = sorted(([n[:200], k[1]] for n, k in kernels.items()),
                 key=lambda x: -x[1])[:TOP]
    host = [e for e in evs if not e.device]
    gaps = sorted(idle(busy, lo, hi), key=lambda g: g[0] - g[1])[:TOP]
    labelled = [[_label(host, (s + e) // 2)[:200], (e - s) / 1e9]
                for s, e in gaps]
    return Reading(sum(e - s for s, e in busy) / 1e9, (hi - lo) / 1e9,
                   kernels, ops, labelled)


def kernel_seconds(kernels: Dict[str, List[float]], needle: str,
                   exclude: Tuple[str, ...] = ()) -> float:
    """Device seconds of the kernels whose name holds `needle`."""
    return sum(k[1] for n, k in kernels.items()
               if needle in n and not any(x in n for x in exclude))
