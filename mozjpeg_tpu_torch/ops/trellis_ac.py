"""AC trellis of one spectral band: the hand-written CUDA kernel and its
plain PyTorch version.

Port of mozjpeg_tpu/ops/pallas_trellis.py::trellis_ac_dp_pallas. The
kernel (csrc/trellis_ac.cu: tiles of 16 blocks of one image moved through
shared memory as whole rows, 8 lanes per block, a DP over the nonzero
positions only) is built with nvcc at first use into
mozjpeg_tpu_torch/_build/ and called through ctypes on PyTorch's current
stream. trellis_ac() launches it for CUDA tensors and takes the plain
version only for tensors on the CPU; anything else raises.

Both compute, per block n of image b = n // n_img:
  qval = min((|raw| + 4q) // 8q, maxq); azd = serial f32 prefix of the
  in-band zero-distortion terms; a Viterbi over i in [Ss, Se], previous
  nonzero j and bit length k < kmax with first-minimum (j, k) ties; end
  selection with the EOB length from rate_luts[b, 127, 0]; path walk;
  -> new_band (64, N) int32 signed kept values (0 elsewhere) and
     ei (8, N) f32 rows [czero, skip, has_eob, 0, ...].
(kmax, maxq) is (10, 1023) at 8 bits and (14, 16383) at 12 (INSTANCES);
the kernel is one template with an instantiation for each. The squares
x*x and delta*delta are int32 products that wrap as the JAX program's do
(at 12 bits raw passes 46,341 on strong edges); the plain version keeps
them int32, the kernel multiplies unsigned so that the wrap is defined.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import threading
import time

import torch

from ..native import build as _build
from .symbols import nbits

KMAX = 10          # NBITS(1023), the 8-bit instantiation
RR_K = 16          # row width of the run-indexed rate LUT
# (kmax, maxq) -> the data precision of the kernel's instantiation
INSTANCES = {(10, 1023): 8, (14, 16383): 12}
BIGF = 1e38        # "invalid" cost; float32(1e38) in every table and cost

SOURCE = os.path.join(_build.PKG_DIR, "csrc", "trellis_ac.cu")
LIB_NAME = "libtrellis_ac.so"

_LIB = None
_LOCK = threading.Lock()


def nvcc_command(srcs, out):
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
            "-fPIC", "-o", out, *srcs]


def build():
    """Compile the kernel (if stale). Returns (seconds spent, the report
    lines of ptxas from the build that made the library: registers,
    spills and shared memory)."""
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
            so.mj_trellis_ac.restype = ctypes.c_int
            so.mj_trellis_ac.argtypes = [
                vp, vp, vp, vp, vp, vp, vp, ctypes.c_longlong,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, vp]
            _LIB = so
    return _LIB


def _check(raw, qtbl_zz, ltbl, rate_luts, lam, Ss, Se, n_img, kmax,
           maxq):
    dev = raw.device
    n = raw.shape[1] if raw.dim() == 2 else -1
    b = rate_luts.shape[0] if rate_luts.dim() == 3 else -1
    want = ((raw, (64, n), torch.int32), (qtbl_zz, (64,), torch.int32),
            (ltbl, (64,), torch.float32),
            (rate_luts, (b, 128, RR_K), torch.float32),
            (lam, (n,), torch.float32))
    for t, shape, dtype in want:
        if (tuple(t.shape) != shape or t.dtype != dtype
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(
                "trellis_ac: expected contiguous %s %s on %s, got %s %s on "
                "%s" % (dtype, shape, dev, t.dtype, tuple(t.shape), t.device))
    if n != b * n_img:
        raise ValueError("trellis_ac: N=%d is not B=%d x n_img=%d"
                         % (n, b, n_img))
    if not 1 <= Ss <= Se <= 63:
        raise ValueError("trellis_ac: bad band (%d, %d)" % (Ss, Se))
    if (kmax, maxq) not in INSTANCES:
        raise ValueError("trellis_ac: no instantiation for kmax=%d maxq=%d"
                         % (kmax, maxq))


def trellis_ac(raw, qtbl_zz, ltbl, rate_luts, lam, Ss: int, Se: int,
               n_img: int, kmax: int = KMAX, maxq: int = 1023):
    """raw (64, N) int32 image-major (N = B*n_img); qtbl_zz (64,) int32;
    ltbl (64,) f32 host-IEEE 1/(q*q); rate_luts (B, 128, 16) f32 with the
    EOB code length at [b, 127, 0]; lam (N,) f32 -> (new_band, ei).
    (kmax, maxq) picks the instantiation (INSTANCES); each launch adds one
    to trellis_ac.launches and to trellis_ac.launches_by_kmax[kmax]."""
    _check(raw, qtbl_zz, ltbl, rate_luts, lam, Ss, Se, n_img, kmax, maxq)
    if raw.device.type == "cpu":
        return trellis_ac_plain(raw, qtbl_zz, ltbl, rate_luts, lam, Ss, Se,
                                n_img, kmax, maxq)
    if raw.device.type != "cuda":
        raise ValueError("trellis_ac: no kernel for device %s" % raw.device)
    lib = _lib()
    n = raw.shape[1]
    new_band = torch.empty((64, n), dtype=torch.int32, device=raw.device)
    ei = torch.empty((8, n), dtype=torch.float32, device=raw.device)
    stream = torch.cuda.current_stream(raw.device).cuda_stream
    # the launch goes to the current device: the tensors' card's
    with torch.cuda.device(raw.device):
        rc = lib.mj_trellis_ac(
            raw.data_ptr(), qtbl_zz.data_ptr(), ltbl.data_ptr(),
            rate_luts.data_ptr(), lam.data_ptr(), new_band.data_ptr(),
            ei.data_ptr(), n, n_img, Ss, Se, INSTANCES[(kmax, maxq)],
            stream)
    if rc != 0:
        raise RuntimeError("trellis_ac kernel launch failed: CUDA error %d"
                           % rc)
    trellis_ac.launches += 1
    trellis_ac.launches_by_kmax[kmax] += 1
    return new_band, ei


def reset_launches():
    """Set every launch count of the kernel to 0."""
    trellis_ac.launches = 0
    trellis_ac.launches_by_kmax = {k: 0 for k, _ in INSTANCES}


reset_launches()


def trellis_ac_plain(raw, qtbl_zz, ltbl, rate_luts, lam, Ss: int, Se: int,
                     n_img: int, kmax: int = KMAX, maxq: int = 1023):
    """The kernel's function as whole-tensor PyTorch ops: each DP step is
    one (B, 64, kmax, n_img) cost tensor. Same signature and outputs.
    The squares are int32 and wrap as in the JAX program."""
    dev = raw.device
    n = raw.shape[1]
    b = rate_luts.shape[0]
    big = torch.tensor(BIGF, dtype=torch.float32, device=dev)

    def lanes(t):                       # (R, N) -> (B, R, n_img)
        return t.reshape(t.shape[0], b, n_img).transpose(0, 1)

    x = raw.abs()
    q8 = (qtbl_zz << 3)[:, None]
    qval = torch.clamp_max((x + (q8 >> 1)) // q8, maxq)
    pos = torch.arange(64, device=dev)[:, None]
    in_band = (pos >= Ss) & (pos <= Se)
    zdist = ((x * x).to(torch.float32) * lam[None]) * ltbl[:, None]
    zterm = torch.where(in_band, zdist, 0.0)
    azd = torch.empty_like(zterm)       # serial f32 prefix, C order
    run = zterm[0]
    azd[0] = run
    for i in range(1, 64):
        run = run + zterm[i]
        azd[i] = run

    j_nonzero = (qval != 0) & in_band
    j_start = pos == Ss - 1
    j_valid = j_nonzero | j_start
    acc = torch.where(j_start, 0.0, big).expand(64, n).clone()
    rs = torch.zeros((64, n), dtype=torch.int64, device=dev)
    bv = torch.zeros((64, n), dtype=torch.int32, device=dev)
    nc = nbits(qval)
    kv = torch.arange(kmax, dtype=torch.int32, device=dev)[:, None]

    for i in range(Ss, Se + 1):
        qval_i, nc_i = qval[i], nc[i]
        cand = torch.where(kv == nc_i - 1, qval_i, (2 << kv) - 1)  # (K, N)
        delta = cand * q8[i] - x[i]
        cdist = ((delta * delta).to(torch.float32) * lam) * ltbl[i]
        rate = rate_luts[:, 64 - i:128 - i, :kmax]           # (B, 64, K)
        tail = (azd[i - 1] - azd) + acc                      # (64, N)
        cost = ((rate[..., None] + lanes(cdist)[:, None])
                + lanes(tail)[:, :, None])                   # (B,64,K,n)
        valid = (lanes(j_valid & (pos < i))[:, :, None]
                 & lanes((kv < nc_i) & (qval_i != 0))[:, None]
                 & (rate < big)[..., None])
        cost = torch.where(valid, cost, big)
        # strict '<' fold over k from BIG: the first k of the minimum,
        # and nothing (k 0, cand 0) when no cost beats BIG
        kidx = cost.argmin(2)                                # (B, 64, n)
        bestc = torch.gather(cost, 2, kidx[:, :, None])[:, :, 0]
        upd = bestc < big
        bestc = torch.where(upd, bestc, big)
        bestcand = torch.where(
            upd, torch.gather(lanes(cand), 1, kidx), 0)
        jidx = bestc.argmin(1, keepdim=True)                 # first j
        minval = torch.gather(bestc, 1, jidx)[:, 0].reshape(n)
        acc[i] = torch.where(qval_i != 0, minval, big)
        rs[i] = jidx[:, 0].reshape(n)
        bv[i] = torch.gather(bestcand, 1, jidx)[:, 0].reshape(n)

    azd_se = azd[Se]
    eobl = rate_luts[:, 127, 0].repeat_interleave(n_img)     # (N,)
    end_wo = (acc + azd_se) - azd
    end_cost = end_wo + torch.where(pos < Se, eobl, 0.0)
    end_cost = torch.where(j_nonzero, end_cost, big)
    end_cost = torch.where(j_start, azd_se + eobl, end_cost)
    last = end_cost.argmin(0)                                # first min

    keep = torch.zeros((64, n), dtype=torch.bool, device=dev)
    cur = last
    for _ in range(Se - Ss + 1):
        on = cur >= Ss
        keep |= (pos == cur) & on
        cur = torch.where(on, torch.gather(rs, 0, cur[None])[0], Ss - 1)
    kept = keep & j_nonzero
    new_band = torch.where(kept, torch.where(raw < 0, -bv, bv), 0) \
        .to(torch.int32)

    skip = torch.gather(torch.where(j_start, azd_se, end_wo), 0,
                        last[None])[0]
    ei = torch.zeros((8, n), dtype=torch.float32, device=dev)
    ei[0] = azd_se
    ei[1] = skip
    ei[2] = (last < Se).to(torch.float32) + (last == Ss - 1).to(torch.float32)
    return new_band, ei
