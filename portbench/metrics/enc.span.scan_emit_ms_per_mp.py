"""ms per megapixel of the emission of the scans coded one by one (the
sequential route's scan, coded with its tables) in the traced window,
summed over the pool threads: the "scan_emit_ns" counter of the port's
"enc.entropy_image" spans, from the program's spans (core/spans.py)."""
from portbench.core import spans


def read(run):
    return spans.attr_ms_per_mp(run, "scan_emit_ns")
