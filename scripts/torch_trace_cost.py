"""What the port's spans cost when they are on: windows of a benchmark cell
with codec/stages.py's tracing() around every call against windows
without, on the same seeds, in one process.

    python3 scripts/torch_trace_cost.py --workload photo12mp-q75.encode \
        --seconds 51 --out trace_cost.json SEED...

Each seed's pool is set up once (portbench's operation for the cell,
its warm-up calls included); then one window without tracing and one
with it run back to back, the first seed untraced first, the next traced
first, and so on. Prints each window's MP/s and the calling thread's
split of the traced windows (portbench/core/spans.py), then each side's
median and quartiles (statistics.quantiles) and the card's name and
power limit; --out keeps every window's numbers and the spans of the
first traced window. No reference check runs. Needs a CUDA card unless
--device cpu (a rehearsal at the size the cell gives).
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench.core import registry, spans, window  # noqa: E402


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return "nvidia-smi failed (%s)" % e


def quartiles(xs):
    q = statistics.quantiles(xs, n=4) if len(xs) > 1 else [xs[0]] * 3
    return {"median": statistics.median(xs), "q1": q[0], "q3": q[2],
            "spread": (q[2] - q[0]) / statistics.median(xs)}


def main(argv):
    p = argparse.ArgumentParser(prog="torch_trace_cost.py")
    p.add_argument("--workload", default="photo12mp-q75.encode")
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    p.add_argument("seeds", type=int, nargs="+")
    a = p.parse_args(argv)
    import mozjpeg_tpu_torch as mjt
    from mozjpeg_tpu_torch.codec import stages
    cell = registry.load(a.workload)
    rows, kept = [], None
    for j, seed in enumerate(a.seeds):
        op = registry.op_class(cell.traffic["op"], cell.pkg_dir)(
            cell.config, cell.traffic, mjt, a.device)
        t = time.perf_counter()
        op.setup(seed)
        setup_s = time.perf_counter() - t
        for traced in ((False, True) if j % 2 == 0 else (True, False)):
            op.answers = []
            if traced:
                stages.clear_spans()
                with stages.tracing() as got:
                    calls = window.run(op.call, a.seconds)
            else:
                calls = window.run(op.call, a.seconds)
            row = {"seed": seed, "traced": traced, "setup_s": setup_s,
                   "calls": len(calls), "mps": window.rate_mps(calls)}
            if traced:
                w = spans.window(SimpleNamespace(calls=calls), got)
                row["caller_ms_per_mp"] = {
                    k: v / 1e6 / w.mp for k, v in spans.caller_ns(w).items()}
                # each harness call against its own enc.call span
                cover = []
                for c, sp in zip(calls, w.calls):
                    inside = (c.start * 1e9 - spans.SLACK_NS <= sp.start_ns
                              and sp.end_ns <= c.end * 1e9 + spans.SLACK_NS)
                    cover.append((sp.end_ns - sp.start_ns) / 1e9
                                 / (c.end - c.start) if inside else 0.0)
                row["call_cover_min"] = min(cover)
                row["calls_with_span"] = len(w.calls)
                imgs = spans.images(w)
                row["entropy_image_ms"] = sorted(
                    (s.end_ns - s.start_ns) / 1e6 for s in imgs)
                row["queued_ms"] = sorted(s.attrs.get("queued_ns", 0) / 1e6
                                          for s in imgs)
                row["candidates"] = sorted(s.attrs.get("candidates", 0)
                                           for s in imgs)
                row["search_ms_per_mp"] = {
                    k: sum(s.attrs.get(k, 0) for s in imgs) / 1e6 / w.mp
                    for k in ("gather_ns", "tables_ns", "emit_ns",
                              "stitch_ns")}
                if kept is None:
                    kept = [s._asdict() for s in got]
            rows.append(row)
            print("seed %d %s: %d calls, %.3f MP/s%s" % (
                seed, "traced" if traced else "untraced", row["calls"],
                row["mps"], "; %d call spans, cover >= %.5f; caller ms/MP "
                "%s; search ms/MP %s" % (
                    row["calls_with_span"], row["call_cover_min"],
                    json.dumps({k: round(v, 4) for k, v in
                                row["caller_ms_per_mp"].items()}),
                    json.dumps({k: round(v, 4) for k, v in
                                row["search_ms_per_mp"].items()}))
                if traced else ""), flush=True)
    sides = {name: quartiles([r["mps"] for r in rows if r["traced"] == on])
             for name, on in (("untraced", False), ("traced", True))}
    pairs = [(r["mps"], s["mps"]) for r in rows for s in rows
             if r["seed"] == s["seed"] and not r["traced"] and s["traced"]]
    cost = [1 - t / u for u, t in pairs]
    out = {"card": card() if a.device == "cuda" else "cpu",
           "seconds": a.seconds, "sides": sides,
           "cost_share_per_seed": cost,
           "cost_share_median": statistics.median(cost), "rows": rows}
    print(json.dumps({k: v for k, v in out.items() if k != "rows"}),
          flush=True)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(dict(out, spans=kept), f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
