"""Pool threads busy with host entropy on average while any is, in the
traced window: the summed time of the port's "enc.entropy_image" spans
over the length of their union, from the program's spans
(core/spans.py)."""
from portbench.core import spans, trace


def read(run):
    w = spans.window(run)
    if w is None:
        return None
    got = [(s.start_ns, s.end_ns) for s in spans.images(w)]
    union = sum(e - b for b, e in trace.merged(got))
    if union <= 0:
        return None
    return sum(e - b for b, e in got) / union
