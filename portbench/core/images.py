"""Seeded photo-like test images, made on the device.

The recipe is chip_smoke.photo's: two sinusoidal colour gradients and a
diagonal ramp, flat rectangles with hard edges, a clipped white highlight
(which drives mozjpeg's overshoot deringing) and Gaussian sensor noise
of sigma 6. Two departures keep the work the same from seed to seed:
the six rectangles have fixed sizes (only their places and colours come
from the seed), and the noise is drawn on the device in one call. The
scalars come from a CPU generator, the noise from a generator on the
device, both seeded with the run's seed, so one seed gives one set of
images on a given device and its type.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

# heights and widths of the six flat rectangles, as shares of (h // 3,
# w // 3): the means of chip_smoke.photo's uniform draws, spread evenly
RECT_SHARES = ((0.95, 0.55), (0.80, 0.35), (0.65, 0.85), (0.50, 0.15),
               (0.35, 0.70), (0.20, 0.45))
NOISE_SIGMA = 6.0


def _uniform(gen: torch.Generator, lo: float, hi: float, n: int = 1):
    return (lo + (hi - lo) * torch.rand(n, generator=gen,
                                        dtype=torch.float64)).tolist()


def _int(gen: torch.Generator, lo: int, hi: int) -> int:
    return int(torch.randint(lo, hi, (1,), generator=gen).item())


def photo(h: int, w: int, params: torch.Generator, noise: torch.Generator,
          device) -> torch.Tensor:
    """One (h, w, 3) uint8 image on `device`."""
    fx, fy, px, py = _uniform(params, 0.5, 3.0, 2) + _uniform(params, 0, 6, 2)
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    img = torch.empty((h, w, 3), device=device, dtype=torch.float32)
    img[..., 0] = 127 + 100 * torch.sin(fx * np.pi * xx / w + px)
    img[..., 1] = 127 + 100 * torch.cos(fy * np.pi * yy / h + py)
    img[..., 2] = 255 * (xx + yy) / (w + h)
    for sh, sw in RECT_SHARES:
        rh, rw = max(8, int(sh * (h // 3))), max(8, int(sw * (w // 3)))
        y0, x0 = _int(params, 0, max(1, h - 8)), _int(params, 0, max(1, w - 8))
        img[y0:y0 + rh, x0:x0 + rw] = torch.tensor(
            _uniform(params, 0, 255, 3), device=device, dtype=torch.float32)
    y0, x0 = _int(params, 0, max(1, h // 2)), _int(params, 0, max(1, w // 2))
    img[y0:y0 + h // 5, x0:x0 + w // 6] = 255.0          # clipped highlight
    img += NOISE_SIGMA * torch.randn((h, w, 3), generator=noise,
                                     device=device, dtype=torch.float32)
    return img.clamp_(0, 255).to(torch.uint8)


def generators(seed: int, device) -> Tuple[torch.Generator, torch.Generator]:
    """(scalar generator on the CPU, noise generator on `device`)."""
    params = torch.Generator(device="cpu")
    params.manual_seed(seed)
    noise = torch.Generator(device=device)
    noise.manual_seed(seed)
    return params, noise


def suites(shapes: Sequence[Tuple[int, int]], n: int, seed: int,
           device) -> List[List[np.ndarray]]:
    """n suites of images of the given (height, width) shapes, made on
    `device` and copied to host arrays once each."""
    params, noise = generators(seed, device)
    return [[photo(h, w, params, noise, device).cpu().numpy()
             for h, w in shapes] for _ in range(n)]
