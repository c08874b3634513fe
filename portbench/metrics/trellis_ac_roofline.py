"""trellis_ac_kernel<10, 1023>'s device time against its bytes bound
(portbench/core/geometry.py), in %, over the traced window's calls;
nothing where it did not run."""
from portbench.core import geometry, trace


def read(run):
    if run.trace is None or "trellis_ac" not in run.kernel_bytes:
        return None
    s = trace.kernel_seconds(run.trace.kernels, "trellis_ac_kernel",
                             ("16383",))
    return geometry.roofline_pct(run.kernel_bytes["trellis_ac"], s)
