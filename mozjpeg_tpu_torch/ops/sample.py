"""Chroma upsampling for decode, exact integer semantics, batched over
planes.

Port of mozjpeg_tpu/ops/sample.py (upsample_h2v1_fancy,
upsample_h2v2_fancy, upsample_h1v2_fancy, upsample_replicate): the
triangle filters of mozjpeg jdsample.c and plain replication. Planes are
(..., H, W) uint8; the arithmetic is int32.

Exactness: each filter interleaves its even and odd outputs with
stack(..., -1).reshape and only then overwrites the first and last
output columns, the order of the JAX functions; planes 1 pixel wide or
high take the same edge rules (the concatenations degenerate to copies).
"""
from __future__ import annotations

import torch


def upsample_h2v1_fancy(plane: torch.Tensor) -> torch.Tensor:
    """Triangle-filter 2x horizontal upsample (jdsample.c:276-306).

    out[2i]   = (3*in[i] + in[i-1] + 1) >> 2   (first col: in[0])
    out[2i+1] = (3*in[i] + in[i+1] + 2) >> 2   (last col:  in[-1])
    """
    x = plane.to(torch.int32)
    left = torch.cat([x[..., :, :1], x[..., :, :-1]], dim=-1)
    right = torch.cat([x[..., :, 1:], x[..., :, -1:]], dim=-1)
    even = (x * 3 + left + 1) >> 2
    odd = (x * 3 + right + 2) >> 2
    out = torch.stack([even, odd], dim=-1).reshape(
        *x.shape[:-1], x.shape[-1] * 2)
    out[..., :, 0] = x[..., :, 0]
    out[..., :, -1] = x[..., :, -1]
    return out.to(plane.dtype)


def upsample_h2v2_fancy(plane: torch.Tensor) -> torch.Tensor:
    """Triangle-filter 2x2 upsample (jdsample.c h2v2_fancy_upsample).

    colsum = 3*near_row + far_row (far = the row above for even output
    rows, below for odd), then horizontally
      out[2j]   = (3*cs[j] + cs[j-1] + 8) >> 4  (first col: (cs*4+8)>>4)
      out[2j+1] = (3*cs[j] + cs[j+1] + 7) >> 4  (last col:  (cs*4+7)>>4)
    """
    x = plane.to(torch.int32)
    above = torch.cat([x[..., :1, :], x[..., :-1, :]], dim=-2)
    below = torch.cat([x[..., 1:, :], x[..., -1:, :]], dim=-2)
    h, w = x.shape[-2], x.shape[-1]
    cs = torch.stack([x * 3 + above, x * 3 + below], dim=-2).reshape(
        *x.shape[:-2], h * 2, w)
    left = torch.cat([cs[..., :, :1], cs[..., :, :-1]], dim=-1)
    right = torch.cat([cs[..., :, 1:], cs[..., :, -1:]], dim=-1)
    out_even = (cs * 3 + left + 8) >> 4
    out_odd = (cs * 3 + right + 7) >> 4
    out = torch.stack([out_even, out_odd], dim=-1).reshape(
        *cs.shape[:-1], w * 2)
    out[..., :, 0] = (cs[..., :, 0] * 4 + 8) >> 4
    out[..., :, -1] = (cs[..., :, -1] * 4 + 7) >> 4
    return out.to(plane.dtype)


def upsample_h1v2_fancy(plane: torch.Tensor) -> torch.Tensor:
    """Vertical 1:2 triangle-filter upsample (jdsample.c:316-348):
    out[2r] = (3*in[r] + in[r-1] + 1) >> 2, out[2r+1] = (3*in[r] +
    in[r+1] + 2) >> 2; edges replicate. The JAX function slices its
    first axis, which is the row axis for the 2-D planes it is given;
    here the row axis is -2 for any batch."""
    x = plane.to(torch.int32)
    up = torch.cat([x[..., :1, :], x[..., :-1, :]], dim=-2)
    dn = torch.cat([x[..., 1:, :], x[..., -1:, :]], dim=-2)
    e = (x * 3 + up + 1) >> 2
    o = (x * 3 + dn + 2) >> 2
    h, w = x.shape[-2], x.shape[-1]
    out = torch.stack([e, o], dim=-2).reshape(*x.shape[:-2], 2 * h, w)
    return out.to(plane.dtype)


def upsample_replicate(plane: torch.Tensor, h: int, v: int) -> torch.Tensor:
    """Plain pixel replication (jdsample.c h2v2_upsample / int_upsample)."""
    out = plane.repeat_interleave(v, dim=-2)
    return out.repeat_interleave(h, dim=-1)
