"""Device half of the sample-plane pack (native planepack.cpp format).

Port of mozjpeg_tpu/ops/planepack.py. A lossless 1-D left-predicted
delta code of uint8 sample streams with an exact bit width (0..8) per
subtile of T = 16 samples, about 0.6-1.0 byte a sample on natural
images instead of 1:

  encode: the host packs its prepped YCbCr planes (mj_plane_pack), the
          device expands them here before p1 (pipeline_t.p1_batch_packed);
  decode: the device packs its rendered planes here (pack_stream), the
          host expands them (mj_plane_expand).

Wire format: per subtile, 16 zigzagged mod-256 deltas (the first sample
predicted from 128) at its width, MSB-first in WPS[width] u32 words,
subtiles back to back; widths nibble-packed eight to a u32 word, the
first in the top nibble (widths_to_words_host). Words are int64 holding
32 bits on the device (ops/bitpack.py). Each field moves by index
(gather and scatter-add of disjoint bits, which is an or); the mod-256
prefix sum that undoes the prediction is an integer cumsum masked to 8
bits, exact on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from .bitpack import M32

T = 16
WPS = (0, 1, 1, 2, 2, 3, 3, 4, 4)          # u32 words per subtile by width


def widths_to_words_host(widths: np.ndarray) -> np.ndarray:
    """Nibble-pack per-subtile widths into u32 words (subtile 8j + k in
    bits [28 - 4k, 32 - 4k) of word j)."""
    nst = widths.shape[-1]
    nw = -(-nst // 8)
    w = np.zeros(widths.shape[:-1] + (nw * 8,), np.uint32)
    w[..., :nst] = widths
    w = w.reshape(widths.shape[:-1] + (nw, 8))
    out = np.zeros(widths.shape[:-1] + (nw,), np.uint32)
    for k in range(8):
        out |= w[..., k] << np.uint32(28 - 4 * k)
    return out


def widths_from_words(wwords: torch.Tensor, nst: int) -> torch.Tensor:
    """(..., nw) int64 width words -> (..., nst) int64 widths (the
    inverse of widths_to_words_host)."""
    sh = torch.arange(28, -1, -4, device=wwords.device)
    cols = (wwords[..., None] >> sh) & 15
    return cols.reshape(wwords.shape[:-1] + (-1,))[..., :nst]


def widths_to_words(widths: torch.Tensor) -> torch.Tensor:
    """(nst,) int64 widths -> (nw,) int64 width words, on the device."""
    nst = widths.shape[0]
    nw = -(-nst // 8)
    w = torch.zeros(nw * 8, dtype=torch.int64, device=widths.device)
    w[:nst] = widths
    sh = torch.arange(28, -1, -4, device=widths.device)
    return (w.reshape(nw, 8) << sh).sum(1)


def _wps(widths: torch.Tensor) -> torch.Tensor:
    return torch.tensor(WPS, device=widths.device)[widths]


def _field_pos(widths: torch.Tensor):
    """Per subtile and sample: the word (0..3) its field starts in, its
    bit shift there, and the width as (..., T) int64."""
    w = widths[..., None].expand(widths.shape + (T,))
    bo = torch.arange(T, device=widths.device) * w
    return bo >> 5, bo & 31, w


def expand_stream(words: torch.Tensor, widths: torch.Tensor, total: int,
                  base=None) -> torch.Tensor:
    """(capw,) int64 payload words + (..., nst) widths -> (..., total)
    uint8 samples. base: each stream's word offset in a shared flat
    buffer (the batched upload concatenates the images' payloads), a
    tensor of the leading shape."""
    capw = words.shape[0]
    wps = _wps(widths)
    off = torch.cumsum(wps, -1) - wps
    if base is not None:
        off = off + base[..., None]
    # the subtile's words and one past them (a field may span two)
    idx = (off[..., None] + torch.arange(5, device=words.device)) \
        .clamp(0, capw - 1)
    tw = words[idx]                                      # (..., nst, 5)
    i0, sh, w = _field_pos(widths)
    hi = torch.gather(tw, -1, i0)
    lo = torch.gather(tw, -1, i0 + 1)
    mask = (1 << w) - 1
    one = (hi >> (32 - sh - w).clamp_min(0)) & mask
    w2 = (sh + w - 32).clamp_min(0)
    two = ((hi << w2) | (lo >> (32 - w2))) & mask
    z = torch.where(sh + w <= 32, one, two)
    d8 = ((z >> 1) ^ -(z & 1)) & 255                      # unzigzag
    d8 = d8.reshape(widths.shape[:-1] + (-1,))[..., :total]
    return ((128 + torch.cumsum(d8, -1)) & 255).to(torch.uint8)


def pack_stream(samples: torch.Tensor, nst: int, capw: int):
    """(total,) uint8 samples -> (words (capw,) int64, widths (nst,)
    int64, nwords 0-d int64); bit-identical to native mj_plane_pack."""
    dev = samples.device
    total = samples.shape[0]
    s = samples.to(torch.int64)
    prev = torch.cat([torch.full((1,), 128, dtype=torch.int64, device=dev),
                      s[:-1]])
    ds = (((s - prev) & 255) + 128 & 255) - 128
    z = ((ds << 1) ^ (ds >> 63)) & 255                    # zigzag
    zt = torch.cat([z, torch.zeros(nst * T - total, dtype=torch.int64,
                                   device=dev)]).reshape(nst, T)
    mx = zt.amax(1)
    widths = torch.where(mx > 0, torch.frexp(mx.to(torch.float32))
                         .exponent.to(torch.int64), 0)
    wps = _wps(widths)
    off = torch.cumsum(wps, 0) - wps
    nwords = off[-1] + wps[-1]
    i0, sh, w = _field_pos(widths)
    w2 = (sh + w - 32).clamp_min(0)
    c0 = torch.where(sh + w <= 32, zt << (32 - sh - w).clamp_min(0),
                     zt >> w2)
    c1 = torch.where(w2 > 0, (zt << (32 - w2)) & M32, 0)
    tile = torch.zeros((nst, 5), dtype=torch.int64, device=dev)
    tile.scatter_add_(1, i0, c0)
    tile.scatter_add_(1, i0 + 1, c1)
    slot = torch.arange(4, device=dev)
    live = slot < wps[:, None]
    didx = torch.where(live, off[:, None] + slot, capw)
    words = torch.zeros(capw + 1, dtype=torch.int64, device=dev)
    words.scatter_(0, didx.reshape(-1).clamp_max(capw),
                   torch.where(live, tile[:, :4], 0).reshape(-1))
    return words[:capw], widths, nwords
