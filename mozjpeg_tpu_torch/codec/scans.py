"""Progressive scan scripts: the jpegrescan search candidate list.

Port of mozjpeg_tpu/codec/scans.py (ScanInfo, search_progression), the
64-scan YCbCr / 23-scan gray list of mozjpeg jcparam.c:734-852. The
native scan search builds the same list itself; the port reads it for
the per-candidate restart intervals.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

FREQUENCY_SPLITS = (2, 8, 5, 12, 18)
AL_MAX_LUMA = 3
AL_MAX_CHROMA = 2


@dataclasses.dataclass(frozen=True)
class ScanInfo:
    comps: Tuple[int, ...]  # component indices
    Ss: int
    Se: int
    Ah: int
    Al: int


def _scan(ci, Ss, Se, Ah, Al):
    return ScanInfo((ci,), Ss, Se, Ah, Al)


def search_progression(ncomps: int, dc_scan_opt_mode: int = 0
                       ) -> List[ScanInfo]:
    """jpegrescan candidate list; select_scans indexes into it."""
    s: List[ScanInfo] = []
    if dc_scan_opt_mode == 0:
        s.append(ScanInfo(tuple(range(ncomps)), 0, 0, 0, 0))
    else:
        s.append(ScanInfo((0,), 0, 0, 0, 0))
    s += [_scan(0, 1, 8, 0, 0), _scan(0, 9, 63, 0, 0)]
    for Al in range(AL_MAX_LUMA):
        s += [_scan(0, 1, 63, Al + 1, Al),
              _scan(0, 1, 8, 0, Al + 1),
              _scan(0, 9, 63, 0, Al + 1)]
    s.append(_scan(0, 1, 63, 0, 0))
    for f in FREQUENCY_SPLITS:
        s += [_scan(0, 1, f, 0, 0), _scan(0, f + 1, 63, 0, 0)]

    if ncomps == 3:
        s.append(ScanInfo((1, 2), 0, 0, 0, 0))
        s += [_scan(1, 0, 0, 0, 0), _scan(2, 0, 0, 0, 0)]
        s += [_scan(1, 1, 8, 0, 0), _scan(1, 9, 63, 0, 0),
              _scan(2, 1, 8, 0, 0), _scan(2, 9, 63, 0, 0)]
        for Al in range(AL_MAX_CHROMA):
            s += [_scan(1, 1, 63, Al + 1, Al),
                  _scan(2, 1, 63, Al + 1, Al),
                  _scan(1, 1, 8, 0, Al + 1), _scan(1, 9, 63, 0, Al + 1),
                  _scan(2, 1, 8, 0, Al + 1), _scan(2, 9, 63, 0, Al + 1)]
        s += [_scan(1, 1, 63, 0, 0), _scan(2, 1, 63, 0, 0)]
        for f in FREQUENCY_SPLITS:
            s += [_scan(1, 1, f, 0, 0), _scan(1, f + 1, 63, 0, 0),
                  _scan(2, 1, f, 0, 0), _scan(2, f + 1, 63, 0, 0)]
    return s
