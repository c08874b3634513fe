"""Helpers of the harness tests: small cells that run on the CPU."""
import os

from portbench.core import registry

TINY_SUITE = [{"width": 64, "height": 48, "count": 2},
              {"width": 48, "height": 64, "count": 1}]
CONFIG = os.path.join(registry.PKG_DIR, "configs", "photo12mp-q75.json")
E2E = ["encode_mps", "setup_s"]
PER_LAYER = ["enc.prep_ms_per_mp", "enc.p1_ms_per_mp",
             "enc.trellis_ms_per_mp", "enc.download_ms_per_mp",
             "enc.host_entropy_ms_per_mp", "p1_blocks_roofline",
             "trellis_ac_roofline", "enc.device_idle"]


def tiny(**traffic) -> registry.Cell:
    """An encode cell over a suite of three small images and a small
    pool, reporting every metric, checked in this process."""
    cell = registry.build("tiny.encode", 1, CONFIG, "encode",
                          [{"name": n, "unit": "-"} for n in E2E],
                          [{"name": n, "unit": "-"} for n in PER_LAYER])
    t = dict(cell.traffic, pool_mp=0.001, warm_calls=1, check_images=3,
             check_workers=0, trellis_blocks=64, trellis_rows=2)
    t.update(traffic)
    return cell._replace(config=dict(cell.config, suite=TINY_SUITE),
                         traffic=t)
