"""ms per megapixel of the pixel upload in the traced window: the
port's "enc.upload" spans (the .to(device) of the prepared buffers),
from the program's spans (core/spans.py)."""
from portbench.core import spans


def read(run):
    return spans.caller_ms_per_mp(run, "upload")
