"""ms per megapixel of the native scan search's emission passes (each
candidate coded with its optimal tables, with its DHT and SOS) in the
traced window, summed over the pool threads: the "emit_ns" counter of
the port's "enc.entropy_image" spans, from the program's spans
(core/spans.py)."""
from portbench.core import spans


def read(run):
    return spans.attr_ms_per_mp(run, "emit_ns")
