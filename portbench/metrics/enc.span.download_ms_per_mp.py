"""ms per megapixel of the coefficient download stage in the traced
window: the port's "enc.download" spans with their blocking copy
("enc.download_copy", which also waits for the device's queue), from
the program's spans (core/spans.py)."""
from portbench.core import spans


def read(run):
    return spans.caller_ms_per_mp(run, "download")
