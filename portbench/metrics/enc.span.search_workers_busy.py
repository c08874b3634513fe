"""Native search workers busy on average while any image's search is in
flight, in the traced window: the gather, table and emission ns of the
port's "enc.entropy_image" spans (the native search's counters, each
summed over every candidate coded, on whichever thread coded it) over
the length of those spans' union, from the program's spans
(core/spans.py). None where no image span has the counters."""
from portbench.core import spans, trace

BUSY = ("gather_ns", "tables_ns", "emit_ns")


def read(run):
    w = spans.window(run)
    if w is None:
        return None
    got = [s for s in spans.images(w) if all(k in s.attrs for k in BUSY)]
    union = sum(e - b for b, e in trace.merged(
        [(s.start_ns, s.end_ns) for s in got]))
    if union <= 0:
        return None
    return sum(s.attrs[k] for s in got for k in BUSY) / union
