"""ms per megapixel of the native scan search's gather passes (each
candidate's symbol counts) in the traced window, summed over the pool
threads: the "gather_ns" counter of the port's "enc.entropy_image"
spans, from the program's spans (core/spans.py)."""
from portbench.core import spans


def read(run):
    return spans.attr_ms_per_mp(run, "gather_ns")
