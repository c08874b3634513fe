"""ms per megapixel of the statistics passes of the scans coded one by
one (the sequential route's scan, each gathering its symbol counts for
its optimal tables) in the traced window, summed over the pool threads:
the "scan_gather_ns" counter of the port's "enc.entropy_image" spans,
from the program's spans (core/spans.py)."""
from portbench.core import spans


def read(run):
    return spans.attr_ms_per_mp(run, "scan_gather_ns")
