"""ms per megapixel of host prep on the calling thread in the traced
window: the self time of the port's "enc.prep" spans (their upload
child left out), from the program's spans (core/spans.py)."""
from portbench.core import spans


def read(run):
    return spans.caller_ms_per_mp(run, "prep")
