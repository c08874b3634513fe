"""One run of one cell: set-up, the measured window, the readings, the
check against the reference, and the result line.

    python3 portbench/run.py --workload photo12mp-q75.encode --seed 7 \
        --seconds 30 --trace 0

--trace 0 reports the cell's end-to-end metrics, --trace 1 runs the same
window under torch.profiler and reports its per-layer metrics. The
control (run_cell's `control`, the program's ifast DCT in the timed
path's place) is read by tests/readings.py, never by these runs.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional

from . import modcheck, registry, trace, window


class RunData:
    """What the metric readers read (metrics/<name>.py: read(run))."""

    def __init__(self, op: str):
        self.op = op
        self.setup_s: float = 0.0
        self.calls: List[window.Call] = []
        self.stages: Dict[str, float] = {}      # stage -> seconds
        self.stage_mp: float = 0.0
        self.host_spans: Dict[str, float] = {}  # span -> seconds
        self.trace: Optional[trace.Reading] = None
        self.kernel_bytes: Dict[str, float] = {}  # kernel -> window bytes

    def rate_mps(self) -> float:
        return window.rate_mps(self.calls)

    def stage_ms_per_mp(self, *names: str) -> Optional[float]:
        got = [self.stages[n] for n in names if n in self.stages]
        if not got or self.stage_mp <= 0:
            return None
        return 1e3 * sum(got) / self.stage_mp


def _device_info(device, n: int) -> dict:
    import torch
    if str(device).startswith("cuda"):
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": n,
                "memory_peak_bytes": int(max(
                    torch.cuda.max_memory_allocated(i) for i in range(n)))}
    return {"platform": "cpu", "kind": "cpu", "count": n,
            "memory_peak_bytes": 0}


def _traced_window(op, seconds: float, cuda: bool, run: RunData):
    """The window under torch.profiler: its calls, and what the profile
    says of the card and its kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])

    def call(k):
        with record_function(trace.CALL_SPAN):
            return op.call(k)
    with profile(activities=acts) as prof:
        run.calls = window.run(call, seconds)
        if cuda:
            torch.cuda.synchronize()
    t = time.perf_counter()
    run.trace = trace.read(trace.events(prof))
    print("portbench: trace read in %.1f s" % (time.perf_counter() - t),
          file=sys.stderr)
    run.kernel_bytes = {k: v * len(run.calls)
                        for k, v in op.kernel_bytes().items()}


def _log_calls(calls: List[window.Call]):
    d = sorted(c.end - c.start for c in calls)
    print("portbench: %d calls in %.3f s; first %.4f s, last %.4f s; "
          "quartiles %.4f %.4f %.4f s"
          % (len(d), window.span_s(calls), calls[0].end - calls[0].start,
             calls[-1].end - calls[-1].start, d[len(d) // 4],
             d[len(d) // 2], d[3 * len(d) // 4]), file=sys.stderr)
    print("portbench: call ms " + " ".join(
        "%.0f" % (1e3 * (c.end - c.start)) for c in calls), file=sys.stderr)


def run_cell(cell: registry.Cell, seed: int, seconds: float, traced: bool,
             device="cuda", t0: Optional[float] = None, control=False,
             program=None) -> dict:
    """One run of `cell` -> the result line's object. `program` is the
    package under test (mozjpeg_tpu_torch unless given)."""
    if t0 is None:
        t0 = time.perf_counter()
    if program is None:
        import mozjpeg_tpu_torch as program
    kind = cell.traffic["op"]
    op = registry.op_class(kind, cell.pkg_dir)(
        cell.config, cell.traffic, program, device, control)
    op.setup(seed)
    run = RunData(kind)
    run.setup_s = time.perf_counter() - t0
    if traced:
        _traced_window(op, seconds, str(device).startswith("cuda"), run)
    else:
        run.calls = window.run(op.call, seconds)
    dev_info = _device_info(device, cell.chips)
    if traced:
        t = time.perf_counter()
        run.stages, run.stage_mp, run.host_spans = op.stage_pass()
        print("portbench: stage pass in %.1f s" % (time.perf_counter() - t),
              file=sys.stderr)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = m.read(run)
        if v is not None:
            metrics[m.name] = {"value": v, "unit": m.unit}
    _log_calls(run.calls)
    t = time.perf_counter()
    checks = op.check(seed)
    print("portbench: reference check in %.1f s (%s)"
          % (time.perf_counter() - t, op.notes), file=sys.stderr)
    limits = op.LIMITS
    out = {"correct": all(checks[k] <= limits[k] for k in limits),
           "attempted": op.attempted, "failed": op.failed,
           "metrics": metrics, "device": dev_info}
    if run.trace is not None:
        out["device"]["busy_s"] = run.trace.busy_s
        out["device"]["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.device_ops,
                            "idle_gaps": run.trace.idle_gaps}
    out["checks"] = {k: {"value": checks[k], "limit": limits[k]}
                     for k in limits}
    return out


def parse_args(argv):
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t0: float) -> int:
    args = parse_args(argv)
    try:
        cell = registry.load(args.workload)
    except KeyError:
        print("portbench: no workload %r in BENCHMARK.json" % args.workload,
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print("portbench: the cell needs %d CUDA device(s); found %s"
              % (cell.chips, torch.cuda.device_count()
                 if torch.cuda.is_available() else "none"), file=sys.stderr)
        return 3
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   "cuda", t0)
    bad = modcheck.forbidden_loaded()
    if bad:
        print("portbench: forbidden modules loaded: %s" % ", ".join(bad),
              file=sys.stderr)
        return 4
    for k, v in out["checks"].items():
        print("check %s %s limit %s" % (k, v["value"], v["limit"]),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
