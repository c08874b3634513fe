"""ms per megapixel of the calling thread in the p1 and trellis stages of
the traced window (the spans "enc.p1" and "enc.trellis_*"): launching
their kernels, with what waits for the device on the way, from the
program's spans (core/spans.py)."""
from portbench.core import spans


def read(run):
    return spans.caller_ms_per_mp(run, "launch")
