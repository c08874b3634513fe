"""cjpeg switch-file parsing (-scans, -qtables, -qslots, -sample,
quality lists) — behavior of mozjpeg rdswitch.c.

Files are free-format ASCII: integers separated by whitespace or
punctuation, '#' comments to end of line. A copy of
mozjpeg_tpu/cli/rdswitch.py.
"""
from __future__ import annotations

import re
from typing import List, Tuple


def _strip_comments(text: str) -> str:
    return re.sub(r"#[^\n]*", " ", text)


def read_scan_script(text: str) -> List[Tuple]:
    """-scans file -> [(comps tuple, Ss, Se, Ah, Al), ...].

    Entries split on ';'; each is 1-4 component indexes, optionally
    ':' + 4 progressive parameters; sequential entries get Ss=0 Se=63
    Ah=Al=0 (rdswitch.c:174-260 read_scan_script)."""
    out = []
    for entry in _strip_comments(text).split(";"):
        if not entry.strip():
            continue
        if ":" in entry:
            left, right = entry.split(":", 1)
            params = [int(v) for v in re.findall(r"-?\d+", right)]
            if len(params) != 4:
                raise ValueError("scan entry needs 4 progressive params: %r"
                                 % entry)
        else:
            left, params = entry, [0, 63, 0, 0]
        comps = tuple(int(v) for v in re.findall(r"-?\d+", left))
        if not 1 <= len(comps) <= 4:
            raise ValueError("scan entry needs 1..4 components: %r" % entry)
        out.append((comps, params[0], params[1], params[2], params[3]))
    if not out:
        raise ValueError("empty scan script")
    return out


def read_quant_tables(text: str) -> List[List[int]]:
    """-qtables file -> up to 4 tables of 64 values, implicitly numbered
    (rdswitch.c:84-137)."""
    vals = [int(v) for v in re.findall(r"\d+", _strip_comments(text))]
    if not vals or len(vals) % 64 != 0 or len(vals) > 4 * 64:
        raise ValueError("quant table file must hold 1..4 x 64 values")
    return [vals[i:i + 64] for i in range(0, len(vals), 64)]


def parse_int_list(arg: str) -> List[int]:
    """N[,N,...] lists (-qslots)."""
    return [int(v) for v in arg.split(",")]


def parse_quality(arg: str):
    """-quality N[,N,...]; single value stays scalar."""
    parts = [float(v) for v in arg.split(",")]
    return parts[0] if len(parts) == 1 else parts


def parse_sample(arg: str) -> List[Tuple[int, int]]:
    """-sample HxV[,HxV,...] per-component sampling factors."""
    out = []
    for p in arg.split(","):
        h, v = p.split("x")
        h, v = int(h), int(v)
        if not (1 <= h <= 4 and 1 <= v <= 4):
            raise ValueError("JPEG sampling factors must be 1..4")
        out.append((h, v))
    return out
