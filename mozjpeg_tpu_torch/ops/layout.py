"""Blockification and zigzag reordering in coefficient-major layout.

Port of mozjpeg_tpu/ops/layout.py (pad_plane, blockify_t, to_zigzag_t,
from_zigzag_t, add_dummy_blocks, add_dummy_blocks_t): blocks live as
(8, 8, N) / (64, N) tensors with the block index last, N in raster block
order (image-major for a batch). The decoder's from_zigzag and
unblockify, and the encoder's planes with their iMCU dummy blocks, keep
the block-major layout, (..., bh, bw, 64) and (..., bh, bw, S, S).
"""
from __future__ import annotations

import numpy as np
import torch

from ..consts import JPEG_ZIGZAG, JPEG_ZIGZAG_INV

_INDEX_CACHE = {}


def _index(order: np.ndarray, device) -> torch.Tensor:
    key = (order.tobytes(), str(device))
    t = _INDEX_CACHE.get(key)
    if t is None:
        t = torch.as_tensor(order.astype(np.int64), device=device)
        _INDEX_CACHE[key] = t
    return t


def pad_plane(plane: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Edge-replicate (..., H, W) up to (..., ph, pw): columns first, then
    rows (mozjpeg jcsample.c expand_right_edge and the prep controller's
    row duplication)."""
    h, w = plane.shape[-2], plane.shape[-1]
    if pw > w:
        plane = torch.cat([plane, plane[..., :, -1:].expand(
            *plane.shape[:-1], pw - w)], -1)
    if ph > h:
        plane = torch.cat([plane, plane[..., -1:, :].expand(
            *plane.shape[:-2], ph - h, plane.shape[-1])], -2)
    return plane


def blockify_t(plane: torch.Tensor) -> torch.Tensor:
    """(H, W) -> (8, 8, N), N = (H//8)*(W//8) raster blocks; a leading
    batch axis (B, H, W) gives N = B*(H//8)*(W//8), image-major."""
    h, w = plane.shape[-2:]
    x = plane.reshape(-1, h // 8, 8, w // 8, 8)
    return x.permute(2, 4, 0, 1, 3).reshape(8, 8, -1)


def to_zigzag_t(blocks: torch.Tensor) -> torch.Tensor:
    """(8, 8, N) natural -> (64, N) zigzag."""
    flat = blocks.reshape(64, -1)
    return flat.index_select(0, _index(JPEG_ZIGZAG, flat.device))


def from_zigzag_t(zz: torch.Tensor) -> torch.Tensor:
    """(64, N) zigzag -> (8, 8, N) natural."""
    inv = _index(JPEG_ZIGZAG_INV, zz.device)
    return zz.index_select(0, inv).reshape(8, 8, -1)


def from_zigzag(zz: torch.Tensor) -> torch.Tensor:
    """(..., 64) zigzag -> (..., 8, 8) natural (block-major layout)."""
    inv = _index(JPEG_ZIGZAG_INV, zz.device)
    return zz.index_select(-1, inv).reshape(*zz.shape[:-1], 8, 8)


def unblockify(blocks: torch.Tensor) -> torch.Tensor:
    """(..., bh, bw, S, S) -> (..., bh*S, bw*S): blocks of any IDCT size
    back into a plane."""
    *lead, bh, bw, sh, sw = blocks.shape
    return blocks.movedim(-2, -3).reshape(*lead, bh * sh, bw * sw)


def add_dummy_blocks(zz: torch.Tensor, real_bw: int, real_bh: int,
                     h_samp: int, v_samp: int) -> torch.Tensor:
    """(..., bh, bw, 64) zigzag planes whose blocks past (real_bh,
    real_bw) hold anything -> the same shape with those blocks the iMCU
    dummy blocks of compress_first_pass (jccoefct.c:300-347): a dummy
    column copies the DC of its row's last real block, a dummy row per
    MCU column the DC of the row above's last in-MCU block, AC zero."""
    bh, bw = zz.shape[-3], zz.shape[-2]
    if real_bw == bw and real_bh == bh:
        return zz
    out = torch.zeros_like(zz)
    out[..., :real_bh, :real_bw, :] = zz[..., :real_bh, :real_bw, :]
    if real_bw < bw:
        out[..., :real_bh, real_bw:, 0] = zz[..., :real_bh,
                                             real_bw - 1:real_bw, 0]
    if real_bh < bh:
        # every dummy row repeats the first: the copy chain through
        # identical rows is a fixed point
        src = out[..., real_bh - 1, :, 0].reshape(
            *zz.shape[:-3], bw // h_samp, h_samp)[..., -1]
        out[..., real_bh:, :, 0] = \
            src.repeat_interleave(h_samp, -1).unsqueeze(-2)
    return out


def add_dummy_blocks_t(zz: torch.Tensor, real_bw: int, real_bh: int,
                       bw: int, bh: int, h_samp: int, v_samp: int
                       ) -> torch.Tensor:
    """(64, real_bh*real_bw) zigzag coefficients of one plane -> (64,
    bh*bw) with the iMCU dummy blocks of add_dummy_blocks."""
    z = zz.reshape(64, real_bh, real_bw).permute(1, 2, 0)
    z = torch.nn.functional.pad(z, (0, 0, 0, bw - real_bw, 0, bh - real_bh))
    return add_dummy_blocks(z, real_bw, real_bh, h_samp, v_samp) \
        .permute(2, 0, 1).reshape(64, bh * bw)
