"""rdjpgcom: display textual comments in a JPEG file.

A copy of mozjpeg_tpu/cli/rdjpgcom.py (host-only, byte tools).
Mirrors mozjpeg rdjpgcom.c: prints COM payloads (and APP12 with
-verbose) with nonprintables escaped as \\nnn, plus image dimensions and
process with -verbose.
"""
from __future__ import annotations

import argparse
import sys

_PROCESS = {
    0xC0: "Baseline", 0xC1: "Extended sequential", 0xC2: "Progressive",
    0xC3: "Lossless", 0xC5: "Differential sequential",
    0xC6: "Differential progressive", 0xC7: "Differential lossless",
    0xC9: "Extended sequential, arithmetic coding",
    0xCA: "Progressive, arithmetic coding",
    0xCB: "Lossless, arithmetic coding",
    0xCD: "Differential sequential, arithmetic coding",
    0xCE: "Differential progressive, arithmetic coding",
    0xCF: "Differential lossless, arithmetic coding",
}
_SOF = set(_PROCESS)


def _print_com(payload: bytes, raw: bool, out):
    """process_COM semantics (rdjpgcom.c:210-253)."""
    lastch = 0
    for ch in payload:
        if raw:
            out.buffer.write(bytes([ch])) if hasattr(out, "buffer") \
                else out.write(chr(ch))
        elif ch == 0x0D:
            out.write("\n")
        elif ch == 0x0A:
            if lastch != 0x0D:
                out.write("\n")
        elif ch == 0x5C:
            out.write("\\\\")
        elif 0x20 <= ch < 0x7F:          # isprint() in the C locale
            out.write(chr(ch))
        else:
            out.write("\\%03o" % ch)
        lastch = ch
    out.write("\n")


def scan(data: bytes, verbose: bool, raw: bool, out=None):
    out = out or sys.stdout
    n = len(data)
    if n < 2 or data[0] != 0xFF or data[1] != 0xD8:
        raise SystemExit("Expected SOI marker first")
    pos = 2
    while pos < n:
        # next_marker: skip non-FF garbage then FF fill
        while pos < n and data[pos] != 0xFF:
            pos += 1
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            break
        m = data[pos]
        pos += 1
        if m == 0xD9 or m == 0xDA:          # EOI / SOS: done
            break
        if 0xD0 <= m <= 0xD7 or m == 0x01:  # standalone
            continue
        if pos + 2 > n:
            break
        ln = (data[pos] << 8) | data[pos + 1]
        payload = data[pos + 2:pos + ln]
        pos += ln
        if m == 0xFE:
            _print_com(payload, raw, out)
        elif m == 0xEC and verbose:
            out.write("APP12 contains:\n")
            _print_com(payload, raw, out)
        elif m in _SOF and verbose:
            h = (payload[1] << 8) | payload[2]
            w = (payload[3] << 8) | payload[4]
            out.write("JPEG image is %uw * %uh, %d color components, "
                      "%d bits per sample\n" % (w, h, payload[5],
                                                payload[0]))
            out.write("JPEG process: %s\n" % _PROCESS[m])


def main(argv=None):
    p = argparse.ArgumentParser(prog="rdjpgcom")
    p.add_argument("-verbose", action="store_true")
    p.add_argument("-raw", action="store_true")
    p.add_argument("input", nargs="?", default=None)
    a = p.parse_args(argv)
    data = (open(a.input, "rb").read() if a.input
            else sys.stdin.buffer.read())
    scan(data, a.verbose, a.raw)


if __name__ == "__main__":
    main()
