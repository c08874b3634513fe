"""Frame geometry: per-component block grids of an interleaved frame.

Port of mozjpeg_tpu/codec/pipeline.py (CompGeom, geometry).
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple


class CompGeom(NamedTuple):
    """Per-component geometry (all Python ints)."""
    h: int                  # sampling factors
    v: int
    w: int                  # real sample dims
    hgt: int
    bw: int                 # real block dims (ceil samples / 8)
    bh: int
    bw_pad: int             # MCU-padded block dims (interleaved layout)
    bh_pad: int


def geometry(width: int, height: int, samp: List[Tuple[int, int]]
             ) -> Tuple[int, int, List[CompGeom]]:
    """-> (mcus_x, mcus_y, [CompGeom]) for an interleaved frame."""
    max_h = max(h for h, _ in samp)
    max_v = max(v for _, v in samp)
    mcus_x = -(-width // (8 * max_h))
    mcus_y = -(-height // (8 * max_v))
    comps = []
    for h, v in samp:
        cw = -(-width * h // max_h)
        ch = -(-height * v // max_v)
        bw = -(-cw // 8)
        bh = -(-ch // 8)
        comps.append(CompGeom(h, v, cw, ch, bw, bh, mcus_x * h, mcus_y * v))
    return mcus_x, mcus_y, comps
