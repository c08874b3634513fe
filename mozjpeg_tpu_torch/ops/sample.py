"""Chroma down- and upsampling and input smoothing, exact integer
semantics, batched over planes.

Port of mozjpeg_tpu/ops/sample.py. Encode: the downsamplers of mozjpeg
jcsample.c (h2v2 with the 1,2,1,2 bias, h2v1 with 0,1,0,1, int_downsample
for every other integral ratio) and its smoothing filters
(fullsize_smooth_downsample, h2v2_smooth_downsample). Decode: the
triangle filters of jdsample.c and plain replication. Planes are
(..., H, W) uint8, or int32 for samples wider than 8 bits; the arithmetic
is int32, and every output keeps its input's type.

Exactness: each upsampling filter interleaves its even and odd outputs
with stack(..., -1).reshape and only then overwrites the first and last
output columns, the order of the JAX functions; planes 1 pixel wide or
high take the same edge rules (the concatenations degenerate to copies).
The smoothing filters replicate the plane's edge samples, as the JAX
functions' pad(mode="edge") does for one plane; here only the last two
axes are padded, so a batch smooths like the vmapped JAX function.
"""
from __future__ import annotations

import torch


def _bias(w: int, even: int, odd: int, dev) -> torch.Tensor:
    """The alternating per-column bias even, odd, even, ... (int32)."""
    return torch.where(torch.arange(w, device=dev) % 2 == 0, even, odd) \
        .to(torch.int32)


def downsample_h2v2(plane: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., H/2, W/2), H and W even (pre-padded):
    (p00 + p01 + p10 + p11 + bias) >> 2, bias 1,2,1,2 along x."""
    x = plane.to(torch.int32)
    s = (x[..., 0::2, 0::2] + x[..., 0::2, 1::2]
         + x[..., 1::2, 0::2] + x[..., 1::2, 1::2])
    return ((s + _bias(s.shape[-1], 1, 2, s.device)) >> 2).to(plane.dtype)


def downsample_h2v1(plane: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., H, W/2); bias 0,1,0,1 along x
    (jcsample.c:247-250)."""
    x = plane.to(torch.int32)
    s = x[..., :, 0::2] + x[..., :, 1::2]
    return ((s + _bias(s.shape[-1], 0, 1, s.device)) >> 1).to(plane.dtype)


def downsample_h1v2(plane: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., H/2, W). jcsample.c has no 1x2 kernel: this
    ratio is int_downsample's, with the constant +numpix/2 bias
    (jcsample.c:152-199), not h2v1's alternating one."""
    x = plane.to(torch.int32)
    return ((x[..., 0::2, :] + x[..., 1::2, :] + 1) >> 1).to(plane.dtype)


def downsample_int(plane: torch.Tensor, hexp: int, vexp: int
                   ) -> torch.Tensor:
    """Integral-factor downsample (jcsample.c:152-199 int_downsample):
    the plain average with +numpix/2 rounding."""
    x = plane.to(torch.int32)
    h, w = x.shape[-2], x.shape[-1]
    numpix = hexp * vexp
    s = x.reshape(*x.shape[:-2], h // vexp, vexp, w // hexp, hexp) \
        .sum((-3, -1), dtype=torch.int32)
    return ((s + numpix // 2) // numpix).to(plane.dtype)


def _edge_pad1(x: torch.Tensor) -> torch.Tensor:
    """Replicate one sample around the last two axes."""
    h, w = x.shape[-2], x.shape[-1]
    dev = x.device
    ri = torch.arange(-1, h + 1, device=dev).clamp(0, h - 1)
    ci = torch.arange(-1, w + 1, device=dev).clamp(0, w - 1)
    return x.index_select(-2, ri).index_select(-1, ci)


def smooth_fullsize(plane: torch.Tensor, sf: int) -> torch.Tensor:
    """Input smoothing of a full-rate component (jcsample.c:395-455
    fullsize_smooth_downsample): (member*(65536 - 512 sf) + neighbours*64
    sf + 32768) >> 16, edges replicated."""
    x = _edge_pad1(plane.to(torch.int32))
    member = x[..., 1:-1, 1:-1]
    neigh = (x[..., :-2, :-2] + x[..., :-2, 1:-1] + x[..., :-2, 2:]
             + x[..., 1:-1, :-2] + x[..., 1:-1, 2:]
             + x[..., 2:, :-2] + x[..., 2:, 1:-1] + x[..., 2:, 2:])
    out = (member * (65536 - sf * 512) + neigh * (sf * 64) + 32768) >> 16
    return out.to(plane.dtype)


def downsample_h2v2_smooth(plane: torch.Tensor, sf: int) -> torch.Tensor:
    """Smoothing 2x2 downsample (jcsample.c:307-392): member*(16384 -
    80 sf) + (2*edge-adjacent + corner)*16 sf, +32768 >> 16."""
    h, w = plane.shape[-2], plane.shape[-1]
    x = _edge_pad1(plane.to(torch.int32))

    def s(dr, dc):
        return x[..., 1 + dr:1 + dr + h, 1 + dc:1 + dc + w][..., 0::2, 0::2]

    member = s(0, 0) + s(0, 1) + s(1, 0) + s(1, 1)
    edge = (s(-1, 0) + s(-1, 1) + s(2, 0) + s(2, 1)
            + s(0, -1) + s(1, -1) + s(0, 2) + s(1, 2))
    corner = s(-1, -1) + s(-1, 2) + s(2, -1) + s(2, 2)
    out = (member * (16384 - sf * 80) + (2 * edge + corner) * (sf * 16)
           + 32768) >> 16
    return out.to(plane.dtype)


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
