"""ms per megapixel of the calling thread's host entropy in the traced
window: submitting the images to the pool ("enc.host_entropy") and
waiting for their bytes ("enc.entropy_wait"), from the program's spans
(core/spans.py)."""
from portbench.core import spans


def read(run):
    return spans.caller_ms_per_mp(run, "entropy_wait")
