"""ms per megapixel of the traced window's calls that no layer's span
covers on the calling thread: the self time of "enc.call" and
"enc.group" (and of any other span), from the program's spans
(core/spans.py). With the other five caller metrics it adds up to the
calls' time."""
from portbench.core import spans


def read(run):
    return spans.caller_ms_per_mp(run, "unattributed")
