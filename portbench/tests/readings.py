"""Readings of the numbers `correct` compares, for setting their limits:
sound runs of a cell on many seeds, the control, and the faults of
test_portbench_correct.Faulty planted in the program, in one process.

    python3 portbench/tests/readings.py --workload photo12mp-q75.encode \
        --seconds 5 --seeds 1 2 3 --faults none control no_trellis

Prints one JSON line a run: fault, seed, the checks, calls and seconds.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(os.path.dirname(HERE)), HERE]

from portbench.core import harness, registry  # noqa: E402
from test_portbench_correct import Faulty  # noqa: E402


def main(argv):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--faults", nargs="+", default=["none"])
    p.add_argument("--check-images", type=int, default=0,
                   help="answers checked in full (0: the traffic's)")
    a = p.parse_args(argv)
    cell = registry.load(a.workload)
    if a.check_images:
        cell = cell._replace(traffic=dict(cell.traffic,
                                          check_images=a.check_images))
    for fault in a.faults:
        for seed in a.seeds:
            f = None if fault == "none" else fault
            t = time.perf_counter()
            out = harness.run_cell(cell, seed, a.seconds, False, "cuda",
                                   control=f == "control",
                                   program=Faulty(f))
            print(json.dumps({
                "fault": fault, "seed": seed, "correct": out["correct"],
                "checks": {k: v["value"] for k, v in out["checks"].items()},
                "attempted": out["attempted"], "failed": out["failed"],
                "seconds": round(time.perf_counter() - t, 1)}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
