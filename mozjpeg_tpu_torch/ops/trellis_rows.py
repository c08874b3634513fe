"""The trellis program's two row scans: the DC trellis and the EOB-run DP,
each as a hand-written CUDA kernel and its plain PyTorch version.

Ports of XLA code of mozjpeg_tpu/codec/trellis.py, where both are
jax.lax.scan loops over block columns: trellis_dc_rows (with the per-phase
loop of make_trellis_all_t around it) and _eob_block_dp. In eager PyTorch
such a scan is a Python loop of a few launches per column, about 1,700 a
group for the DC trellis; on the card the two wrappers instead launch
csrc/trellis_rows.cu once per component (trellis_dc) and once per
component and band (eob_dp). The library is built with nvcc at first use
into mozjpeg_tpu_torch/_build/ and called through ctypes on PyTorch's
current stream. Tensors on the CPU take the plain versions; anything else
raises.

  - trellis_dc: the DC trellis of every block row of a component, lastDC
    chained through the v block rows of each iMCU row (starting at 0),
    with the vertical-gradient term of trellis_delta_dc_weight against the
    row above in the same iMCU row. Plain version: trellis_dc_plain, the
    per-phase loop over trellis_dc_rows (the JAX package's split PER
    IMAGE: with bh % v != 0 a flat stride-v slice would mix phases across
    image boundaries).
  - eob_dp: trellis_eob_opt's DP over whole blocks of every block row,
    from the AC kernel's `ei` strip and each image's EOBn code lengths.
    Plain version: eob_dp_plain over eob_block_dp.

For measurement only (counted nowhere): trellis_dc_clocks, the DC
kernel's instantiation that counts each chain's SM cycles by step, and
empty_launch, a kernel that does nothing (the launch floor).
"""
from __future__ import annotations

import ctypes
import os
import threading
import time

import numpy as np
import torch

from ..native import build as _build
from .symbols import nbits
from .trellis_ac import BIGF, nvcc_command

DC_CAND_MAX = 9     # DC_TRELLIS_MAX_CANDIDATES
DC_SI_N = 17        # DC code lengths the trellis reads (categories 0..16)

SOURCE = os.path.join(_build.PKG_DIR, "csrc", "trellis_rows.cu")
LIB_NAME = "libtrellis_rows.so"

_LIB = None
_LOCK = threading.Lock()


def build():
    """Compile the kernels (if stale). Returns (seconds spent, the ptxas
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
            vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            so.mj_trellis_dc.restype = ci
            so.mj_trellis_dc.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, cf,
                                         vp, ci, ci, cf, ci, vp]
            so.mj_trellis_dc_clocks.restype = ci
            so.mj_trellis_dc_clocks.argtypes = [vp, vp, vp, ci, ci, ci, ci,
                                                ci, cf, vp, ci, ci, cf, ci,
                                                vp, vp]
            so.mj_empty.restype = ci
            so.mj_empty.argtypes = [vp]
            so.mj_eob_dp.restype = ci
            so.mj_eob_dp.argtypes = [vp, vp, vp, ctypes.c_longlong, ci, ci,
                                     vp]
            _LIB = so
    return _LIB


def _want(name, t, shape, dtype, dev):
    if (tuple(t.shape) != tuple(shape) or t.dtype != dtype
            or t.device != dev or not t.is_contiguous()):
        raise ValueError("%s: expected contiguous %s %s on %s, got %s %s on "
                         "%s" % (name, dtype, tuple(shape), dev, t.dtype,
                                 tuple(t.shape), t.device))


def reset_launches():
    """Set both kernels' launch counts to 0."""
    trellis_dc.launches = 0
    eob_dp.launches = 0


# ---------------------------------------------------------------------------
# DC trellis
# ---------------------------------------------------------------------------

def trellis_dc(raw_dc, lam, q0: int, ltbl0: float, dc_si, nc: int, v: int,
               delta_w: float = 0.0, maxq: int = 1023):
    """The DC trellis of one component of a batch.

    raw_dc (B, bh, bw) int32, the raw DC (x8) of every block (row 0 of
    the component's raw plane); lam (B, bh, bw) f32 per-block lambda;
    q0 the DC quant value and ltbl0 its host-IEEE 1/(q0*q0), so that each
    block's lam_dc is the f32 product lam * ltbl0; dc_si the DC code
    lengths (numpy, at least 17); nc <= 9 candidates; v block rows per
    iMCU row; delta_w the vertical-gradient weight; maxq the candidates'
    clamp -> (B, bh, bw) int32 chosen DC. On a CUDA tensor one launch
    (adding one to trellis_dc.launches), on the CPU the plain version."""
    dev = raw_dc.device
    if raw_dc.dim() != 3:
        raise ValueError("trellis_dc: raw_dc must be (B, bh, bw), got %s"
                         % (tuple(raw_dc.shape),))
    _want("trellis_dc", raw_dc, raw_dc.shape, torch.int32, dev)
    _want("trellis_dc", lam, raw_dc.shape, torch.float32, dev)
    si = np.asarray(dc_si, np.int32).reshape(-1)
    if si.size < DC_SI_N or not 1 <= nc <= DC_CAND_MAX or v < 1 or q0 < 1:
        raise ValueError("trellis_dc: needs 17 code lengths, 1 <= nc <= 9, "
                         "v >= 1 and q0 >= 1 (got %d, %d, %d, %d)"
                         % (si.size, nc, v, q0))
    if dev.type == "cpu":
        return trellis_dc_plain(raw_dc, lam, q0, ltbl0, si, nc, v, delta_w,
                                maxq)
    if dev.type != "cuda":
        raise ValueError("trellis_dc: no kernel for device %s" % dev)
    lib = _lib()
    b, bh, bw = raw_dc.shape
    out = torch.empty((b, bh, bw), dtype=torch.int32, device=dev)
    tab = (ctypes.c_int * DC_SI_N)(*si[:DC_SI_N].tolist())
    with torch.cuda.device(dev):
        rc = lib.mj_trellis_dc(
            raw_dc.data_ptr(), lam.data_ptr(), out.data_ptr(), b, bh, bw, v,
            q0, ltbl0, ctypes.cast(tab, ctypes.c_void_p), nc,
            int(delta_w > 0.0), delta_w, maxq,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("trellis_dc kernel launch failed: CUDA error %d"
                           % rc)
    trellis_dc.launches += 1
    return out


def trellis_dc_clocks(raw_dc, lam, q0: int, ltbl0: float, dc_si, nc: int,
                      v: int, delta_w: float = 0.0, maxq: int = 1023):
    """trellis_dc's launch on a CUDA tensor through the kernel's
    instantiation that counts each chain's SM cycles by step, for the
    measurement of where its time goes (not counted in
    trellis_dc.launches) -> (the same output, (chains, 4) int64 cycles:
    the per-row pass, the chain, the walk back, the output)."""
    dev = raw_dc.device
    if dev.type != "cuda":
        raise ValueError("trellis_dc_clocks: needs a CUDA tensor")
    _want("trellis_dc_clocks", raw_dc, raw_dc.shape, torch.int32, dev)
    _want("trellis_dc_clocks", lam, raw_dc.shape, torch.float32, dev)
    si = np.asarray(dc_si, np.int32).reshape(-1)
    lib = _lib()
    b, bh, bw = raw_dc.shape
    out = torch.empty((b, bh, bw), dtype=torch.int32, device=dev)
    clocks = torch.zeros((b * -(-bh // v), 4), dtype=torch.int64,
                         device=dev)
    tab = (ctypes.c_int * DC_SI_N)(*si[:DC_SI_N].tolist())
    with torch.cuda.device(dev):
        rc = lib.mj_trellis_dc_clocks(
            raw_dc.data_ptr(), lam.data_ptr(), out.data_ptr(), b, bh, bw, v,
            q0, ltbl0, ctypes.cast(tab, ctypes.c_void_p), nc,
            int(delta_w > 0.0), delta_w, maxq, clocks.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("trellis_dc_clocks launch failed: CUDA error %d"
                           % rc)
    return out, clocks


def empty_launch(dev):
    """One launch of a kernel that does nothing on dev's current stream
    (through ctypes, as the wrappers launch): the launch floor."""
    with torch.cuda.device(dev):
        rc = _lib().mj_empty(torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("empty kernel launch failed: CUDA error %d" % rc)


def trellis_dc_plain(raw_dc, lam, q0: int, ltbl0: float, dc_si, nc: int,
                     v: int, delta_w: float = 0.0, maxq: int = 1023):
    """trellis_dc's function as PyTorch ops: the per-phase loop of the
    JAX package's make_trellis_all_t over trellis_dc_rows. Phase p holds
    the rows i*v + p of every image; it starts from phase p-1's last DC
    (0 for p = 0) and, with delta_w, has phase p-1 as the row above."""
    dev = raw_dc.device
    batch, bh, bw = raw_dc.shape
    si = torch.as_tensor(np.asarray(dc_si, np.int32), device=dev)
    lam_dc = lam * ltbl0
    dc_all = torch.empty((batch, bh, bw), dtype=torch.int32, device=dev)
    prev = None
    for p in range(v):
        rr = raw_dc[:, p::v]
        nph = rr.shape[1]
        init = (torch.zeros(batch * nph, dtype=torch.int32, device=dev)
                if p == 0 else prev[:, :nph].reshape(-1))
        ar = ad = None
        if delta_w > 0.0 and p > 0:
            ar = raw_dc[:, p - 1::v][:, :nph].reshape(-1, bw)
            ad = dc_all[:, p - 1::v][:, :nph].reshape(-1, bw)
        dc, fin = trellis_dc_rows(
            rr.reshape(-1, bw), init, q0, si,
            lam_dc[:, p::v].reshape(-1, bw), nc, delta_w, ar, ad, maxq)
        dc_all[:, p::v] = dc.reshape(batch, nph, bw)
        prev = fin.reshape(batch, nph)
    return dc_all


def trellis_dc_rows(raw_dc, last_dc0, q0: int, dc_si, lam_dc, nc: int,
                    delta_w: float = 0.0, above_raw=None, above_dc=None,
                    maxq: int = 1023):
    """DC trellis over a batch of independent block rows.

    raw_dc (R, L) int32 unquantized DC (x8); last_dc0 (R,) int32 initial
    predictor per row; dc_si (256,) int32; lam_dc (R, L) f32 (lambda *
    1/q0^2) -> ((R, L) int32 chosen quantized DC, (R,) int32 last DC).
    Candidates clamp to +-maxq (kmax_maxq). With delta_w > 0 and the row
    above (above_raw, its raw DC, and above_dc, its chosen DC), the
    distortion blends in the vertical gradient error
    (jcdctmgr.c:1069-1084). The squares stay int32 and wrap at 12 bits as
    the JAX program's do. The DP runs one step per block column; ties go
    to the first index."""
    dev = raw_dc.device
    R, L = raw_dc.shape
    q8 = q0 * 8
    sign = torch.where(raw_dc < 0, -1, 1).to(torch.int32)
    x = raw_dc.abs()
    qval = (x + q8 // 2) // q8
    ks = torch.arange(nc, dtype=torch.int32, device=dev)
    cand_mag = torch.clamp(qval[..., None] - nc // 2 + ks, -maxq, maxq)
    delta = cand_mag * q8 - x[..., None]
    dist = (delta * delta).to(torch.float32) * lam_dc[..., None]
    cand = cand_mag * sign[..., None]                  # (R, L, nc) signed
    if delta_w > 0.0 and above_raw is not None:
        vd = ((above_raw - raw_dc)[..., None]
              - (above_dc[..., None] * q8 - cand * q8))
        vdist = (vd * vd).to(torch.float32) * lam_dc[..., None]
        w = torch.tensor(delta_w, dtype=torch.float32, device=dev)
        dist = dist + w * (vdist - dist)

    def trans_cost(d):
        # nbits(|d|) + dc code length of that category, exact in f32
        b = nbits(d.abs())
        return (b + dc_si[b.to(torch.int64)]).to(torch.float32)

    acc = trans_cost(cand[:, 0, :] - last_dc0[:, None]) + dist[:, 0, :]
    # every later step's transition + distortion terms at once:
    # step[r, t, l, k] for previous candidate l -> candidate k
    step = (trans_cost(cand[:, 1:, None, :] - cand[:, :-1, :, None])
            + dist[:, 1:, None, :])
    bts = torch.zeros((L, R, nc), dtype=torch.int64, device=dev)
    for t in range(1, L):
        cost = step[:, t - 1] + acc[:, :, None]        # (R, l_prev, k)
        bt = cost.argmin(1)
        bts[t] = bt
        acc = torch.gather(cost, 1, bt[:, None])[:, 0]
    cur = acc.argmin(1)
    curs = torch.empty((R, L), dtype=torch.int64, device=dev)
    for t in range(L - 1, -1, -1):
        curs[:, t] = cur
        if t:
            cur = torch.gather(bts[t], 1, cur[:, None])[:, 0]
    out = torch.gather(cand, 2, curs[..., None])[..., 0]
    return out, out[:, -1]


# ---------------------------------------------------------------------------
# EOB-run DP
# ---------------------------------------------------------------------------

def eob_dp(ei, ac_si, bh: int, bw: int):
    """trellis_eob_opt's DP of one component and band.

    ei (8, N) f32, the AC kernel's strip (rows czero, skip, has_eob), read
    in place; ac_si (B, 256) int32 each image's AC code lengths (the
    EOBn lengths at 16 * k); N = B * bh * bw -> (N // bw, bw) bool, the
    blocks that keep their coefficients. On a CUDA tensor one launch
    (adding one to eob_dp.launches), on the CPU the plain version."""
    dev = ei.device
    n = ei.shape[1] if ei.dim() == 2 else -1
    _want("eob_dp", ei, (8, n), torch.float32, dev)
    b = ac_si.shape[0] if ac_si.dim() == 2 else -1
    _want("eob_dp", ac_si, (b, 256), torch.int32, dev)
    if n != b * bh * bw or bw >= 32768:
        raise ValueError("eob_dp: N=%d is not B=%d x %d x %d (bw < 32768)"
                         % (n, b, bh, bw))
    if dev.type == "cpu":
        return eob_dp_plain(ei, ac_si, bh, bw)
    if dev.type != "cuda":
        raise ValueError("eob_dp: no kernel for device %s" % dev)
    lib = _lib()
    kept = torch.empty((n // bw, bw), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        rc = lib.mj_eob_dp(ei.data_ptr(), ac_si.data_ptr(), kept.data_ptr(),
                           n, bw, bh, torch.cuda.current_stream(dev)
                           .cuda_stream)
    if rc != 0:
        raise RuntimeError("eob_dp kernel launch failed: CUDA error %d" % rc)
    eob_dp.launches += 1
    return kept


def eob_dp_plain(ei, ac_si, bh: int, bw: int):
    """eob_dp's function as PyTorch ops: eob_block_dp over the strip's
    rows, with each row's image's EOBn lengths."""
    eob_si = ac_si[:, ::16].to(torch.float32).repeat_interleave(bh, 0)
    return eob_block_dp(ei[0].reshape(-1, bw), ei[1].reshape(-1, bw),
                        ei[2].to(torch.int64).reshape(-1, bw), eob_si)


def eob_block_dp(czero, skip, has_eob, eob_si):
    """trellis_eob_opt's block-level EOB-run DP over R block rows of L
    blocks (jcdctmgr.c:1224-1297), from the AC kernel's `ei` strip:
    czero (R, L) f32 all-zero cost, skip (R, L) f32 best cost without the
    block's EOB, has_eob (R, L) int 0/1/2 (2: the block is all zero in the
    band); eob_si (R, 16) f32, the EOBn code lengths ac_si[16 * k] of each
    row's image -> (R, L) bool, the blocks that keep their coefficients.
    Float adds run in C's order, the first minimum wins, and an EOB run of
    n blocks costs ac_si[16 * nbits(n)] + nbits(n). One step per block
    column, then the walk back along the row."""
    dev = czero.device
    R, L = czero.shape
    big = torch.tensor(BIGF, dtype=torch.float32, device=dev)
    iidx = torch.arange(L + 1, device=dev)

    def eobrun_cost(run):
        nb = nbits(run.clamp_min(0)).to(torch.int64)   # run < 32768
        return nb.to(torch.float32) + torch.gather(eob_si, 1, nb)

    has_eob = has_eob.to(torch.int64)
    blk_nz = has_eob != 2
    azbc = torch.zeros((R, L + 1), dtype=torch.float32, device=dev)
    abc = torch.zeros_like(azbc)
    req = torch.zeros((R, L + 1), dtype=torch.int64, device=dev)
    brs = torch.zeros((R, L), dtype=torch.int64, device=dev)
    for b in range(L):
        azbc_b = azbc[:, b]
        azbc[:, b + 1] = azbc_b + czero[:, b]
        run = (b - iidx)[None] + req
        # C order: cost = skip; += azbc[bi]; -= azbc[i]; += abc[i]; += rate
        cost = (((skip[:, b, None] + azbc_b[:, None]) - azbc) + abc) \
            + eobrun_cost(run)
        valid = (iidx <= b)[None] & (req != 2) & blk_nz[:, b, None]
        cost = torch.where(valid, cost, big)
        arg = cost.argmin(1)
        best = torch.gather(cost, 1, arg[:, None])[:, 0]
        abc[:, b + 1] = torch.where(blk_nz[:, b], best, big)
        brs[:, b] = torch.where(blk_nz[:, b], arg, 0)
        req[:, b + 1] = has_eob[:, b]
    # the final EOB run to the end of the row (jcdctmgr.c:1258-1276)
    run = (L - iidx)[None] + req
    fcost = (azbc[:, L, None] - azbc) + eobrun_cost(run)
    fcost = torch.where(req != 2, fcost, big)
    last = fcost.argmin(1) - 1
    kept = torch.empty((R, L), dtype=torch.bool, device=dev)
    for b in range(L - 1, -1, -1):
        k = last == b
        kept[:, b] = k
        last = torch.where(k, brs[:, b] - 1, last)
    return kept


def dc_example_inputs(kind: str, b: int, bh: int, bw: int, q0: int,
                      precision: int = 8, seed: int = 0):
    """Seeded numpy (raw_dc (b, bh, bw) int32, lam (b, bh, bw) f32,
    dc_si (256,) int32) for the DC trellis, for tests and the smoke run.
    tie: raw on the rounding midpoints of q8 = 8 and their neighbours,
    lambda 1 and equal code lengths, so that with q0 = 1 (1/q0^2 = 1)
    every cost is an integer and ties are common; alltie: one raw value
    for every block, lambda 0 and code lengths si[k] = 16 - k, so that
    every transition costs 16 and all candidates tie at every step;
    seeded: raw spread past
    the candidates' clamp for q0 <= 2 (1023, and 16383 at precision 12),
    and at 12 bits to 260,000 for larger q0, where with a 16-bit quant
    value the squares and cand * q8 products wrap int32."""
    rng = np.random.default_rng(seed)
    shape = (b, bh, bw)
    si = np.zeros(256, np.int32)
    if kind == "tie":
        raw = rng.integers(-30, 31, shape) * 4
        lam = np.ones(shape, np.float32)
        si[:DC_SI_N] = 3
    elif kind == "alltie":
        raw = np.full(shape, int(rng.integers(-2000, 2001)))
        lam = np.zeros(shape, np.float32)
        si[:DC_SI_N] = 16 - np.arange(DC_SI_N)
    else:
        top = {8: 20000, 12: 140000}[precision] if q0 <= 2 else \
            {8: 8000, 12: 260000}[precision]
        raw = rng.integers(-top, top + 1, shape)
        lam = (rng.random(shape) * 4 + 0.01).astype(np.float32)
        si[:DC_SI_N] = rng.integers(2, 17, DC_SI_N)
    return raw.astype(np.int32), lam, si


def eob_example_inputs(seed: int, b: int, bh: int, bw: int,
                       kind: str = "seeded"):
    """Seeded numpy (ei (8, N) f32, ac_si (b, 256) int32) for the EOB-run
    DP, N = b * bh * bw (at least 4 block rows).

    seeded: an all-zero row (has_eob 2), a row with no all-zero block, a
    row that is one long zero run and one with EOBs every 7 blocks (runs
    past 16), tie-heavy integer costs, and skip costs at BIG and past it.
    adversarial: the rows cycle through every cost tied (czero = skip =
    1, and image 0's EOBn costs all 16: ac_si[16 * k] = 16 - k), all
    zero, every other block all zero, zeroing dearer than keeping (long
    walks back), and seeded rows (skip at BIG in a tenth of the blocks)."""
    rng = np.random.default_rng(seed)
    r, n = b * bh, b * bh * bw
    czero = rng.integers(0, 6, (r, bw)).astype(np.float32)
    skip = rng.integers(0, 6, (r, bw)).astype(np.float32)
    has_eob = rng.integers(0, 3, (r, bw))
    if kind == "adversarial":
        skip[rng.random((r, bw)) < 0.1] = np.float32(BIGF)
        for row in range(r):
            k = row % 5
            if k == 0:
                czero[row] = skip[row] = 1.0
                has_eob[row] = rng.integers(0, 2, bw)
            elif k == 1:
                has_eob[row] = 2
            elif k == 2:
                has_eob[row, 1::2] = 2
                has_eob[row, 0::2] = rng.integers(0, 2, -(-bw // 2))
            elif k == 3:
                czero[row] += 40.0
        si = rng.integers(2, 17, (b, 256)).astype(np.int32)
        si[0, 0:256:16] = 16 - np.arange(16)
    else:
        has_eob[0] = 2
        has_eob[1] = rng.integers(0, 2, bw)
        has_eob[2, 1:-2] = 2
        has_eob[3] = np.where(np.arange(bw) % 7 == 0, 1, 2)
        skip[2] = czero[2]
        skip[rng.random((r, bw)) < 0.1] = np.float32(BIGF)
        skip[rng.random((r, bw)) < 0.05] = np.float32(2.5e38)
        si = rng.integers(2, 17, (b, 256)).astype(np.int32)
        si[0, 0:256:16] = 4              # equal EOBn lengths
    ei = np.zeros((8, n), np.float32)
    ei[0], ei[1], ei[2] = czero.reshape(-1), skip.reshape(-1), \
        has_eob.reshape(-1)
    return ei, si


reset_launches()
