"""wrjpgcom: insert a textual COM marker into a JPEG file.

A copy of mozjpeg_tpu/cli/wrjpgcom.py (host-only, byte tools).
Mirrors mozjpeg wrjpgcom.c: copies markers up to SOFn (dropping
existing COM markers with -replace), writes the new COM immediately
before SOFn, then copies the remainder of the file verbatim.
"""
from __future__ import annotations

import argparse
import sys

MAX_COM_LENGTH = 65000


def insert_comment(data: bytes, comment: bytes, replace: bool) -> bytes:
    if len(comment) > MAX_COM_LENGTH:
        raise SystemExit("Comment text may not exceed %d bytes"
                         % MAX_COM_LENGTH)
    n = len(data)
    if n < 2 or data[0] != 0xFF or data[1] != 0xD8:
        raise SystemExit("Expected SOI marker first")
    out = bytearray(b"\xff\xd8")
    pos = 2
    while True:
        # next_marker
        start = pos
        while pos < n and data[pos] != 0xFF:
            pos += 1
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            raise SystemExit("Premature EOF in JPEG file")
        m = data[pos]
        pos += 1
        if (0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC)) or m == 0xD9:
            # SOFn (or EOI for tables-only): insert the comment here
            com = bytearray(b"\xff\xfe")
            ln = len(comment) + 2
            com += bytes([ln >> 8, ln & 0xFF]) + comment
            out += com
            out += b"\xff" + bytes([m])
            out += data[pos:]
            return bytes(out)
        if m == 0xDA:
            raise SystemExit("SOS without prior SOFn")
        if 0xD0 <= m <= 0xD7 or m == 0x01:
            out += b"\xff" + bytes([m])
            continue
        if pos + 2 > n:
            raise SystemExit("Premature EOF in JPEG file")
        ln = (data[pos] << 8) | data[pos + 1]
        seg = data[pos:pos + ln]
        pos += ln
        if m == 0xFE and replace:
            continue                      # discard existing comment
        out += b"\xff" + bytes([m]) + seg
    # unreachable


def main(argv=None):
    p = argparse.ArgumentParser(prog="wrjpgcom")
    p.add_argument("-replace", action="store_true")
    p.add_argument("-comment", type=str, default=None)
    p.add_argument("-cfile", type=str, default=None)
    p.add_argument("-outfile", type=str, default=None)
    p.add_argument("input", nargs="?", default=None)
    a = p.parse_args(argv)
    if a.comment is not None and a.cfile is not None:
        raise SystemExit("only one of -comment and -cfile")
    if a.comment is not None:
        comment = a.comment.encode("latin-1")
    elif a.cfile is not None:
        comment = open(a.cfile, "rb").read()
    else:
        if a.input is None:
            raise SystemExit("need -comment/-cfile or an input file "
                             "(comment read from stdin)")
        comment = sys.stdin.buffer.read()
    data = (open(a.input, "rb").read() if a.input
            else sys.stdin.buffer.read())
    out = insert_comment(data, comment, a.replace)
    if a.outfile:
        open(a.outfile, "wb").write(out)
    else:
        sys.stdout.buffer.write(out)


if __name__ == "__main__":
    main()
