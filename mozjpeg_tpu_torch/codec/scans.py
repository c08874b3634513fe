"""Scan scripts.

Port of mozjpeg_tpu/codec/scans.py: mozjpeg's 9-scan JCP_MAX_COMPRESSION
default script, libjpeg-turbo's 10-scan legacy script, the one-scan
sequential script, and the jpegrescan search candidate list (64 scans
YCbCr / 23 gray, mozjpeg jcparam.c:655-978). The native scan search
builds the candidate list itself; the port reads it for the per-candidate
restart intervals, and the arithmetic scan search runs it.
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


def simple_progression_max(ncomps: int, dc_scan_opt_mode: int = 0,
                           ycbcr: bool = True) -> List[ScanInfo]:
    """mozjpeg's JCP_MAX_COMPRESSION default script (jcparam.c:917-958).
    Non-YCbCr colorspaces take the all-purpose branch even at 3
    components (jcparam.c:884,929)."""
    s: List[ScanInfo] = []
    if ncomps == 3 and ycbcr:
        if dc_scan_opt_mode == 0:
            s.append(ScanInfo((0, 1, 2), 0, 0, 0, 0))
        elif dc_scan_opt_mode == 1:
            s += [_scan(0, 0, 0, 0, 0), _scan(1, 0, 0, 0, 0),
                  _scan(2, 0, 0, 0, 0)]
        else:
            s += [_scan(0, 0, 0, 0, 0), ScanInfo((1, 2), 0, 0, 0, 0)]
        s += [_scan(0, 1, 8, 0, 2), _scan(1, 1, 8, 0, 0),
              _scan(2, 1, 8, 0, 0), _scan(0, 9, 63, 0, 2),
              _scan(0, 1, 63, 2, 1), _scan(0, 1, 63, 1, 0),
              _scan(1, 9, 63, 0, 0), _scan(2, 9, 63, 0, 0)]
    else:
        s.append(ScanInfo(tuple(range(ncomps)), 0, 0, 0, 0))
        for Ss, Se, Ah, Al in ((1, 8, 0, 2), (9, 63, 0, 2), (1, 63, 2, 1),
                               (1, 63, 1, 0)):
            s += [_scan(ci, Ss, Se, Ah, Al) for ci in range(ncomps)]
    return s


def simple_progression_legacy(ncomps: int,
                              ycbcr: bool = True) -> List[ScanInfo]:
    """libjpeg-turbo's classic 10-scan script (jcparam.c:959-978)."""
    allc = tuple(range(ncomps))
    if ncomps == 3 and ycbcr:
        return [ScanInfo(allc, 0, 0, 0, 1), _scan(0, 1, 5, 0, 2),
                _scan(2, 1, 63, 0, 1), _scan(1, 1, 63, 0, 1),
                _scan(0, 6, 63, 0, 2), _scan(0, 1, 63, 2, 1),
                ScanInfo(allc, 0, 0, 1, 0), _scan(2, 1, 63, 1, 0),
                _scan(1, 1, 63, 1, 0), _scan(0, 1, 63, 1, 0)]
    s = [ScanInfo(allc, 0, 0, 0, 1)]
    for Ss, Se, Ah, Al in ((1, 5, 0, 2), (6, 63, 0, 2), (1, 63, 2, 1)):
        s += [_scan(ci, Ss, Se, Ah, Al) for ci in range(ncomps)]
    s.append(ScanInfo(allc, 0, 0, 1, 0))
    s += [_scan(ci, 1, 63, 1, 0) for ci in range(ncomps)]
    return s


def baseline_script(ncomps: int) -> List[ScanInfo]:
    """One interleaved full-spectrum scan (sequential mode)."""
    return [ScanInfo(tuple(range(ncomps)), 0, 63, 0, 0)]


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
