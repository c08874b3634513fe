"""Benchmark of mozjpeg_tpu_torch on one CUDA device; see core/harness.py.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>
"""
import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every kernel cache stays at a fixed place inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(ROOT, ".portbench_cache", sub)
sys.path.insert(0, ROOT)

from portbench.core import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
