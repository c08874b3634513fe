"""ms per megapixel of host entropy on the pool threads in the traced
window: the sum of the port's "enc.entropy_image" spans, one an image
(the scan search and the markers), from the program's spans
(core/spans.py)."""
from portbench.core import spans


def read(run):
    w = spans.window(run)
    if w is None:
        return None
    got = spans.images(w)
    if not got:
        return None
    return spans.ms_per_mp(w, sum(s.end_ns - s.start_ns for s in got))
