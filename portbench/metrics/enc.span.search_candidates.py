"""Candidate scans the native scan search coded an image, over the images
of the traced window's first call (the window's call count varies from
run to run; its first call's photos do not, so a seed repeats the
count): the "candidates" counter of the port's "enc.entropy_image"
spans, from the program's spans (core/spans.py)."""
from portbench.core import spans


def read(run):
    w = spans.window(run)
    if w is None:
        return None
    first = w.calls[0].id
    got = [s.attrs["candidates"] for s in spans.images(w)
           if s.call == first and "candidates" in s.attrs]
    return sum(got) / len(got) if got else None
