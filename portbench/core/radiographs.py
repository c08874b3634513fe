"""Seeded radiograph-like 12-bit grayscale images, made on the device.

A flat-panel chest view in detector counts (0..4095, more counts where
more of the beam gets through):

  - the collimator blades shield a frame around the exposed field: low
    scatter counts, with sharp edges at the blades;
  - inside the field the raw beam, where nothing lies in its way,
    saturates the detector: exactly 4095 (its level before the clip lies
    far above 4095, so its noise never brings it below), which drives
    the 12-bit overshoot deringing wherever it meets the body or a
    blade;
  - the body is an ellipse whose counts fall smoothly with the path
    length through it, with two brighter lung fields, rib-like bands
    across them and a darker spine;
  - a lead marker, a small rectangle of low counts in a corner of the
    raw beam, gives sharp edges inside the saturated region;
  - quantum noise: Gaussian with a standard deviation of
    sqrt(NOISE_GAIN x counts), in counts of 12 bits, then the clip to
    0..4095.

Every size is fixed (the frame's shares); the seed moves the field, the
body, the marker and the ribs and sets the levels, so the work is the
same from seed to seed. The scalars come from a CPU generator, the noise
from a generator on the device, both seeded with the run's seed, so one
seed gives one set of images on a given device and its type.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .images import _int, _uniform, generators

MAXV = 4095
RAW_BEAM = 4700.0           # counts of the raw beam before the clip
NOISE_GAIN = 0.25           # noise variance per count
FIELD = 0.92                # exposed field's side, a share of the frame's
BODY = (0.40, 0.43)         # body's semi-axes (x, y), shares of the frame
LUNG = (0.14, 0.29)         # each lung's semi-axes, shares of the frame
MARKER = (0.032, 0.022)     # lead marker's (width, height), frame shares
RIBS = 10                   # rib bands over a lung's height


def _ellipse_depth(xx, yy, cx, cy, ax, ay):
    """sqrt(1 - r^2) inside the ellipse (the path length through it, as a
    share of its largest), 0 outside."""
    r2 = ((xx - cx) / ax) ** 2 + ((yy - cy) / ay) ** 2
    return torch.sqrt(torch.clamp(1.0 - r2, min=0.0))


def radiograph(h: int, w: int, params: torch.Generator,
               noise: torch.Generator, device) -> torch.Tensor:
    """One (h, w) int32 image in 0..4095 on `device`."""
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    fw, fh = int(FIELD * w), int(FIELD * h)
    fx0 = _int(params, 0, max(1, w - fw + 1))
    fy0 = _int(params, 0, max(1, h - fh + 1))
    jx, jy = _uniform(params, -0.02, 0.02, 2)
    cx, cy = fx0 + fw / 2 + jx * w, fy0 + fh / 2 + jy * h
    ax, ay = BODY[0] * w, BODY[1] * h
    body_level, lung_gain, scatter = (
        _uniform(params, 1200, 1900) + _uniform(params, 0.7, 1.1)
        + _uniform(params, 80, 260))
    # counts through the body: the raw beam attenuated by the path length
    depth = _ellipse_depth(xx, yy, cx, cy, ax, ay)
    mu = float(np.log(RAW_BEAM / body_level))
    img = RAW_BEAM * torch.exp(-mu * depth)
    # two lung fields let more through; ribs and the spine less
    lx, ly = LUNG[0] * w, LUNG[1] * h
    ribs_phase, tilt = _uniform(params, 0, 2 * np.pi) + _uniform(
        params, 0.6, 1.4)
    for side in (-1, 1):
        lcx = cx + side * 0.19 * w
        lcy = cy - 0.04 * h
        lung = _ellipse_depth(xx, yy, lcx, lcy, lx, ly)
        # rib bands: curved stripes across the lung, sharpened cosines
        arc = (yy - lcy) / ly + 0.35 * tilt * ((xx - lcx) / lx) ** 2
        band = torch.cos(np.pi * RIBS * arc + ribs_phase).clamp(min=0) ** 4
        img = img + lung_gain * body_level * lung * (1.0 - 0.35 * band)
    spine = torch.exp(-((xx - cx) / (0.035 * w)) ** 2) * (depth > 0)
    img = img * (1.0 - 0.3 * spine)
    # the lead marker in the raw beam, in one of the field's top corners
    mw, mh = max(8, int(MARKER[0] * w)), max(8, int(MARKER[1] * h))
    right = _int(params, 0, 2)
    mx0 = (fx0 + fw - 2 * mw - _int(params, 0, max(1, mw // 2)) if right
           else fx0 + mw + _int(params, 0, max(1, mw // 2)))
    my0 = fy0 + mh + _int(params, 0, max(1, mh // 2))
    img[my0:my0 + mh, mx0:mx0 + mw] = scatter * 1.5
    # collimation: scatter outside the field, sharp at the blades
    outside = torch.ones((h, w), dtype=torch.bool, device=device)
    outside[fy0:fy0 + fh, fx0:fx0 + fw] = False
    img = torch.where(outside, torch.full_like(img, scatter), img)
    sigma = torch.sqrt(NOISE_GAIN * img.clamp(min=0))
    img = img + sigma * torch.randn((h, w), generator=noise, device=device,
                                    dtype=torch.float32)
    return img.round_().clamp_(0, MAXV).to(torch.int32)


def suites(shapes: Sequence[Tuple[int, int]], n: int, seed: int,
           device) -> List[List[np.ndarray]]:
    """n suites of (height, width) uint16 images, made on `device` and
    copied to host arrays once each."""
    params, noise = generators(seed, device)
    return [[radiograph(h, w, params, noise, device).cpu().numpy()
             .astype(np.uint16) for h, w in shapes] for _ in range(n)]
