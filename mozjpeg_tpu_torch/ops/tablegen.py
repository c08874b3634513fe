"""Optimal Huffman tables (JPEG Annex K.2) for many histograms at once:
the hand-written CUDA kernel and its plain PyTorch version.

Port of mozjpeg_tpu/ops/tablegen.py (gen_optimal_tables_t, derive_codes_t,
trellis_rate_tables_t), itself mozjpeg's jpeg_gen_optimal_table
(jchuff.c:947-1106) as array programs: the later symbol wins a frequency
tie (the reference's ascending <= scan), pseudo-symbol 256 reserves the
all-ones code, lengths are limited to 16 bits, and the values are ordered
by (code size before the limiting, ascending symbol), leaving a hole
where the pseudo-symbol lands.

The JAX package runs it as XLA (a while_loop of up to 256 merge steps,
then 16 x 129 length-limiting steps), which in eager PyTorch would be
some 20,000 launches a call. On the card gen_optimal_tables() launches
csrc/tablegen.cu instead: one warp per histogram, all tables of a call in
one launch (three components x B images on the trellis route, a scan
search's whole batch of candidate tables). It is built with nvcc at first
use into mozjpeg_tpu_torch/_build/ and called through ctypes on
PyTorch's current stream; tensors on the CPU take the plain version,
anything else raises. derive_codes stays plain PyTorch on both devices
(a handful of whole-tensor ops).
"""
from __future__ import annotations

import ctypes
import os
import threading
import time

import numpy as np
import torch

from ..native import build as _build
from .trellis_ac import nvcc_command

BIG = 1 << 30           # absent and merged entries (above any real count)
NSYM = 257              # 256 symbols and the pseudo-symbol

SOURCE = os.path.join(_build.PKG_DIR, "csrc", "tablegen.cu")
LIB_NAME = "libtablegen.so"

_LIB = None
_LOCK = threading.Lock()
launches = 0            # kernel launches since reset_launches()


def reset_launches():
    global launches
    launches = 0


def build():
    """Compile the kernel (if stale). Returns (seconds spent, the ptxas
    report lines of the build that made the library)."""
    t0 = time.perf_counter()
    out = _build.ensure_built(LIB_NAME, [SOURCE], nvcc_command)
    report = [ln.strip() for ln in out.splitlines()
              if "ptxas" in ln or "spill" in ln]
    return time.perf_counter() - t0, report


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            build()
            so = ctypes.CDLL(os.path.join(_build.BUILD_DIR, LIB_NAME))
            vp = ctypes.c_void_p
            so.mj_tablegen.restype = ctypes.c_int
            so.mj_tablegen.argtypes = [vp, ctypes.c_int, vp, vp, vp, vp, vp]
            _LIB = so
    return _LIB


def gen_optimal_tables(freqs: torch.Tensor, sizes: bool = False):
    """freqs (T, 257) int32 symbol counts (freqs[:, 256] is taken as 1)
    -> (bits (T, 17) int32, vals (T, 256) int32, ok (T,) bool), and with
    `sizes` also each table's code lengths by symbol, (T, 256) int32 (the
    ehufsi of derive_codes). ok is False where fewer than 2 symbols are
    present or a code would pass 32 bits. On a CUDA tensor one launch of
    the kernel (adding one to `launches`), on the CPU the plain version."""
    if (freqs.dim() != 2 or freqs.shape[1] != NSYM
            or freqs.dtype != torch.int32 or not freqs.is_contiguous()):
        raise ValueError("gen_optimal_tables: expected contiguous int32 "
                         "(T, 257), got %s %s" % (freqs.dtype,
                                                  tuple(freqs.shape)))
    if freqs.device.type == "cpu":
        bits, vals, ok = gen_optimal_tables_plain(freqs)
        return (bits, vals, ok) + ((derive_codes(bits, vals)[1],)
                                   if sizes else ())
    if freqs.device.type != "cuda":
        raise ValueError("gen_optimal_tables: no kernel for device %s"
                         % freqs.device)
    global launches
    lib = _lib()
    t, dev = freqs.shape[0], freqs.device
    bits = torch.empty((t, 17), dtype=torch.int32, device=dev)
    vals = torch.empty((t, 256), dtype=torch.int32, device=dev)
    ok = torch.empty((t,), dtype=torch.bool, device=dev)
    si = (torch.empty((t, 256), dtype=torch.int32, device=dev)
          if sizes else None)
    if t:
        # the launch goes to the current device: the tensors' card's
        with torch.cuda.device(dev):
            rc = lib.mj_tablegen(
                freqs.data_ptr(), t, bits.data_ptr(), vals.data_ptr(),
                ok.data_ptr(), si.data_ptr() if sizes else None,
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError("tablegen kernel launch failed: CUDA error %d"
                               % rc)
        launches += 1
    return (bits, vals, ok) + ((si,) if sizes else ())


def gen_optimal_tables_plain(freqs: torch.Tensor):
    """The kernel's function as whole-tensor PyTorch ops over the T
    tables, each merge and length-limiting step masked per table as in
    the JAX vmap of its loops. Same arguments and (bits, vals, ok).

    Each entry's key is count * 512 + (511 - symbol), so that the two
    smallest keys (one topk) are the two least counts with the LATER
    symbol first among equals, the reference's tie order; a merged root
    keeps its first symbol's index, so a root's group is its symbol and
    the code sizes are the merge tree's depths, counted back from the
    last merge."""
    f = freqs.to(torch.int64)
    t, dev = f.shape[0], f.device
    idx = torch.arange(NSYM, device=dev)
    present = (f > 0) | (idx == 256)
    dead = BIG * 512
    key = torch.where(present, torch.where(idx == 256, 1, f), BIG) * 512 \
        + (511 - idx)
    merges = []
    for _ in range(min(256, int(present.sum(1).amax()) - 1) if t else 0):
        live = (key < dead).sum(1) >= 2
        k2 = torch.topk(key, 2, 1, largest=False).values
        c = 511 - (k2 & 511)                          # (T, 2): c1, c2
        merged = ((k2[:, 0] >> 9) + (k2[:, 1] >> 9)) * 512 + (511 - c[:, 0])
        new = torch.stack([merged, dead + (511 - c[:, 1])], 1)
        key = key.scatter(1, c, torch.where(live[:, None], new, k2))
        merges.append((c, live))
    codesize = torch.zeros((t, NSYM), dtype=torch.int64, device=dev)
    for c, live in reversed(merges):
        d = codesize.gather(1, c[:, :1]) + 1
        codesize.scatter_(1, c, torch.where(live[:, None], d.expand(-1, 2),
                                            codesize.gather(1, c)))

    n = present.sum(1)
    ok = (n >= 2) & (torch.where(present, codesize, 0) <= 32).all(1)
    bits = torch.zeros((t, 33), dtype=torch.int64, device=dev)
    bits.scatter_add_(1, torch.where(present, codesize.clamp(0, 32), 0),
                      present.long())
    bits[:, 0] = 0
    # values: ascending (code size, symbol) over the present symbols, then
    # the absent ones in symbol order (a stable sort of the JAX keys); the
    # pseudo-symbol's slot is left as 0
    order = torch.where(present, codesize * 512 + idx, (1 << 24) + idx)
    ranked = torch.argsort(order, 1)[:, :256]
    vals = torch.where(ranked == 256, 0, ranked).to(torch.int32)

    # length limiting (jchuff.c:1053-1069): each step moves a pair of the
    # longest codes up, one level at a time from 32 down to 17
    lvl = torch.arange(33, device=dev)
    for i in range(32, 16, -1):
        for _ in range(129):
            do = bits[:, i] > 0
            if not bool(do.any()):
                break
            j = torch.where((lvl <= i - 2) & (bits > 0), lvl, -1) \
                .amax(1).clamp_min(0)
            upd = torch.zeros_like(bits)
            upd[:, i] -= 2
            upd[:, i - 1] += 1
            upd.scatter_add_(1, (j + 1)[:, None], torch.full_like(
                upd[:, :1], 2))
            upd.scatter_add_(1, j[:, None], torch.full_like(upd[:, :1], -1))
            bits = bits + torch.where(do[:, None], upd, 0)
    # the pseudo-symbol's count leaves the largest length <= 16 in use
    last = torch.where((lvl <= 16) & (bits > 0), lvl, 0).amax(1)
    bits[torch.arange(t, device=dev), last] -= ok.long()
    return bits[:, :17].to(torch.int32), vals, ok


def derive_codes(bits: torch.Tensor, vals: torch.Tensor):
    """Canonical codes (jpeg_make_c_derived_tbl): bits (T, 17) int32,
    vals (T, 256) int32 -> (ehufco (T, 256) int64, ehufsi (T, 256)
    int32), by symbol (derive_codes_t; the codes are uint32 there and
    below 2^17 here, so int64 holds them exactly)."""
    t, dev = bits.shape[0], bits.device
    nb = bits[:, 1:17].to(torch.int64)
    cs = torch.cumsum(nb, 1)
    start = cs - nb
    p = torch.arange(256, device=dev).expand(t, 256).contiguous()
    # the length of rank p: one more than the lengths whose cumulative
    # counts are <= p (counts are non-negative, so cs is sorted)
    len_p = torch.searchsorted(cs, p, right=True) + 1         # (T, 256)
    bases = torch.empty_like(nb)
    base = torch.zeros(t, dtype=torch.int64, device=dev)
    for ln in range(16):
        bases[:, ln] = base
        base = (base + nb[:, ln]) << 1
    li = (len_p - 1).clamp(0, 15)
    code_p = bases.gather(1, li) + (p - start.gather(1, li))
    valid = p < cs[:, -1:]
    sym = vals.clamp(0, 255).long()
    co = torch.zeros((t, 256), dtype=torch.int64, device=dev)
    co.scatter_add_(1, sym, torch.where(valid, code_p, 0))
    si = torch.zeros((t, 256), dtype=torch.int64, device=dev)
    si.scatter_add_(1, sym, torch.where(valid, len_p, 0))
    return co, si.to(torch.int32)


PACKED_BELOW = 1 << 23  # the kernel's 32-bit keys hold live sums below this


def edge_freqs() -> np.ndarray:
    """(T, 257) int32 counts at the kernel's edges, for the tests and the
    smoke alike: live sums (the pseudo-symbol's 1 included) of
    PACKED_BELOW - 1, PACKED_BELOW and PACKED_BELOW + 1, each once with
    110 tied least counts and two large ones and once with 256 tied
    counts (the remainder on symbol 255); all 257 counts equal; a sum of
    BIG - 1; a merge that reaches BIG; a count of BIG or more (present,
    never merged) beside small ones."""
    cases = []
    for total in (PACKED_BELOW - 1, PACKED_BELOW, PACKED_BELOW + 1):
        f = np.zeros(NSYM, np.int64)
        f[:110] = 3
        rest = total - 1 - int(f.sum())
        f[200], f[201] = rest // 2, rest - rest // 2
        cases.append(f)
        f = np.zeros(NSYM, np.int64)
        f[:256] = (total - 1) // 256
        f[255] += total - 1 - int(f.sum())
        cases.append(f)
    f = np.zeros(NSYM, np.int64)
    f[:256] = 1
    cases.append(f)
    f = np.zeros(NSYM, np.int64)
    f[:4] = (1 << 28) - 1
    f[4] = 2
    cases.append(f)
    f = np.zeros(NSYM, np.int64)
    f[:3] = (1 << 29) + 5
    f[9] = 4
    cases.append(f)
    f = np.zeros(NSYM, np.int64)
    f[7], f[8], f[9] = BIG + 5, 5, 5
    cases.append(f)
    return np.stack(cases).astype(np.int32)


def _trellis_prime() -> np.ndarray:
    """+1 for every (run, size < 12) symbol, size 0 included: the rate
    smoothing of the trellis's statistics (trellis_tables_from_hist)."""
    p = np.zeros(NSYM, np.int32)
    for run in range(16):
        p[16 * run:16 * run + 12] += 1
    return p


TRELLIS_PRIME = _trellis_prime()


def trellis_freqs(achists: torch.Tensor) -> torch.Tensor:
    """achists (T, 256) AC-first histograms -> the primed (T, 257) int32
    counts of their trellis rate tables."""
    f = torch.as_tensor(TRELLIS_PRIME, device=achists.device) \
        .repeat(achists.shape[0], 1)
    f[:, :256] += achists.to(torch.int32)
    return f


def trellis_rate_tables(achists: torch.Tensor) -> torch.Tensor:
    """achists (T, 256) AC-first histograms -> (T, 256) int32 code
    lengths for the trellis (the device twin of trellis_tables_from_hist
    with optimize_coding): primed, then one gen_optimal_tables call."""
    return gen_optimal_tables(trellis_freqs(achists), sizes=True)[3]
