"""Per-stage wall times for an instrumented encode.

stage(times, name, device) synchronises the device before and after its
body and adds the seconds to times[name]; with times=None it does
nothing, so the normal path pays no synchronisation.
"""
from __future__ import annotations

import contextlib
import time

import torch


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def stage(times, name: str, device):
    if times is None:
        yield
        return
    _sync(device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sync(device)
        times[name] = times.get(name, 0.0) + time.perf_counter() - t0
