"""PPM/PGM read/write (P5/P6, 8-bit and 16-bit); a copy of
mozjpeg_tpu/utils/ppm.py."""
from __future__ import annotations

import numpy as np


def read(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    # header tokens, skipping comments
    tokens = []
    i = 0
    while len(tokens) < 4 and i < len(data):
        if data[i:i + 1].isspace():
            i += 1
        elif data[i:i + 1] == b"#":
            while i < len(data) and data[i] not in (10, 13):
                i += 1
        else:
            j = i
            while j < len(data) and not data[j:j + 1].isspace():
                j += 1
            tokens.append(data[i:j])
            i = j
    magic = tokens[0]
    w, h, maxval = int(tokens[1]), int(tokens[2]), int(tokens[3])
    i += 1  # single whitespace after maxval
    ch = 3 if magic == b"P6" else 1
    if maxval > 255:
        # 16-bit samples pass through raw: rdppm.c rescales to the
        # COMPILED data precision's MAXJSAMPLE (4095 for 12-bit cjpeg,
        # 65535 for 16-bit), which a precision-agnostic reader cannot
        # know; callers that need it rescale against their precision
        img = np.frombuffer(data[i:i + w * h * ch * 2], dtype=">u2")
        img = img.astype(np.uint16)
    else:
        img = np.frombuffer(data[i:i + w * h * ch], dtype=np.uint8)
        if maxval != 255:
            # rdppm.c:844-848 rescale to MAXJSAMPLE
            img = ((img.astype(np.uint32) * 255 + maxval // 2)
                   // maxval).astype(np.uint8)
    img = img.reshape(h, w, ch) if ch == 3 else img.reshape(h, w)
    return img


def write(path: str, img: np.ndarray, maxval: int = None):
    if img.ndim == 2:
        magic, ch = b"P5", 1
    else:
        magic, ch = b"P6", 3
    if maxval is None:
        maxval = 65535 if img.dtype == np.uint16 else 255
    with open(path, "wb") as f:
        f.write(magic + b"\n%d %d\n%d\n" % (img.shape[1], img.shape[0],
                                            maxval))
        if maxval > 255:
            f.write(img.astype(">u2").tobytes())
        else:
            f.write(img.astype(np.uint8).tobytes())
