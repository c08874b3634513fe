"""trellis_ac_kernel<14, 16383>'s (12-bit coefficients) device time
against its bytes bound (portbench/core/geometry12.py), in %, over the
traced window's calls; nothing where it did not run."""
from portbench.core import geometry, trace


def read(run):
    if run.trace is None or "trellis_ac14" not in run.kernel_bytes:
        return None
    s = trace.kernel_seconds(run.trace.kernels,
                             "trellis_ac_kernel<14, 16383>", ())
    return geometry.roofline_pct(run.kernel_bytes["trellis_ac14"], s)
