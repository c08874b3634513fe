"""p1_blocks_kernel<int32_t>'s (12-bit samples) device time against its
bytes bound (portbench/core/geometry12.py), in %, over the traced
window's calls; nothing where it did not run."""
from portbench.core import geometry, trace


def read(run):
    if run.trace is None or "p1_blocks12" not in run.kernel_bytes:
        return None
    s = trace.kernel_seconds(run.trace.kernels, "p1_blocks_kernel<int>", ())
    return geometry.roofline_pct(run.kernel_bytes["p1_blocks12"], s)
