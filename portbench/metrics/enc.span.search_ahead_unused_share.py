"""Share of the native scan search's coded candidates that were coded
ahead of the selection and never read, over the traced window's images:
ahead_unused / (candidates + ahead_unused), in %, from the counters of
the port's "enc.entropy_image" spans (core/spans.py). None where no
image span has the counters (a program that codes no candidate ahead
of its selection)."""
from portbench.core import spans


def read(run):
    w = spans.window(run)
    if w is None:
        return None
    got = [s.attrs for s in spans.images(w)
           if "ahead_unused" in s.attrs and "candidates" in s.attrs]
    coded = sum(a["candidates"] + a["ahead_unused"] for a in got)
    if coded <= 0:
        return None
    return 100.0 * sum(a["ahead_unused"] for a in got) / coded
