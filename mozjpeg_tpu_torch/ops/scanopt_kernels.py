"""The candidate-scan pieces of the device scan search: DC histograms
and exact finished sizes.

Port of mozjpeg_tpu/ops/scanopt_kernels.py, with jcphuff.c's semantics:
EOB runs across blocks, the 0x7FFF forced flush, and AC refinement's
correction bits with the MAX_CORR_BITS flush. The JAX package
symbolises each candidate at a runtime band and Al inside one program
(lax.map over the candidates). Eager PyTorch instead takes the
candidates one at a time, each band a static slice, with every image of
the group as one restart segment of a single call, and each candidate a
chunk of blocks at a time (ops/bitpack.py), so that memory holds a
chunk of one candidate's symbols, not a hundred candidates':

  - AC first: bitpack.AcFirst (hist, the gather-mode counts, and pack);
  - AC refine: bitpack.AcRefine (the per-block summaries, the flush
    schedule from the native mj_ac_refine_schedule on the host, a
    serial O(blocks) loop that the JAX package runs as a lax.scan; hist
    and pack);
  - DC first: ops/symbols.dc_hist and bitpack._pack_dc_first;
  - stuffed_size: the byte length of each finished segment.
"""
from __future__ import annotations

import torch


def stuffed_size(words: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """(S, nwords) packed words (32 bits each), (S,) bit counts -> (S,)
    int64 bytes of each finished segment: ceil(bits / 8) after the
    1-padding, plus one stuffed 0x00 for every 0xFF
    (bitpack.finish_segments), counted without leaving the device."""
    nwords = words.shape[1]
    nbytes = (bits + 7) >> 3
    w = torch.arange(nwords, device=words.device)[None, :]
    ff = torch.zeros_like(bits)
    for k in range(4):
        byte = (words >> (24 - 8 * k)) & 0xFF
        ff += ((byte == 0xFF) & (4 * w + k < nbytes[:, None])).sum(1)
    # the 1-padding can turn the last byte into 0xFF
    last = (nbytes - 1).clamp_min(0)
    byte = (words.gather(1, (last >> 2)[:, None])[:, 0]
            >> (24 - 8 * (last & 3))) & 0xFF
    pad = (1 << ((-bits) % 8)) - 1
    ff += ((nbytes > 0) & (byte != 0xFF) & ((byte | pad) == 0xFF)).long()
    return nbytes + ff
