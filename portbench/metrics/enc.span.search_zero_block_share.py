"""Share of the blocks that the native scan search's AC candidates walked
(gather and emission passes, each counted) whose band was all zero after
the point transform, so that the coder's bitmap skipped them whole, over
the traced window's images: 100 * zero_blocks / blocks, in %, from the
counters of the port's "enc.entropy_image" spans (core/spans.py). None
where no image span has the counters (a program whose coders count no
blocks)."""
from portbench.core import spans


def read(run):
    w = spans.window(run)
    if w is None:
        return None
    got = [s.attrs for s in spans.images(w)
           if "blocks" in s.attrs and "zero_blocks" in s.attrs]
    blocks = sum(a["blocks"] for a in got)
    if blocks <= 0:
        return None
    return 100.0 * sum(a["zero_blocks"] for a in got) / blocks
