"""Overshoot deringing, batched over all blocks (coefficient-major).

Port of mozjpeg_tpu/ops/dering.py (dering_t, dering_float_t), which
reproduces preprocess_deringing and float_preprocess_deringing (mozjpeg
jcdctmgr.c:416-570): runs of clipped-white samples along the zigzag walk
are replaced by a Catmull-Rom overshoot curve capped by min(31, 2*q0,
headroom).

Exactness: eager PyTorch rounds every f32 op, so the cubic keeps C's
per-product rounding without the JAX package's contraction barriers (do
not torch.compile it). The `position += step` scan is a serial 64-step
f32 loop, and the step table is a gather from the IEEE f32 table 1/n.
"""
from __future__ import annotations

import numpy as np
import torch

MAXS = 127  # 255 - CENTERJSAMPLE

# IEEE f32 1/n for n in [0, 65]; entries 0 and 1 are only read at masked
# non-run positions and hold 0 (as in the JAX package's table)
with np.errstate(divide="ignore"):
    _STEP_LUT = np.float32(1.0) / np.arange(66, dtype=np.float32)
_STEP_LUT[:2] = 0.0
_LUTS = {}


def _step_lut(dev) -> torch.Tensor:
    """_STEP_LUT on dev, uploaded once per device (so that a call
    uploads nothing and can be captured in a CUDA graph)."""
    t = _LUTS.get(str(dev))
    if t is None:
        t = _LUTS[str(dev)] = torch.as_tensor(_STEP_LUT, device=dev)
    return t


def _hold(values, valid, reverse: bool, seed):
    """Last-valid-value propagation down axis 0 (first-valid when
    reverse), seeded at the edge like the reference's clamped indexing."""
    n = values.shape[0]
    pos = torch.arange(n, device=values.device)[:, None]
    at_edge = pos == (n - 1 if reverse else 0)
    v = torch.where(at_edge, seed, values)
    k = valid | at_edge
    if reverse:
        src = torch.where(k, pos, n - 1).flip(0).cummin(0).values.flip(0)
    else:
        src = torch.where(k, pos, 0).cummax(0).values
    return torch.gather(v, 0, src)


def dering_t(zz: torch.Tensor, q0: int) -> torch.Tensor:
    """(64, N) int32 centered zigzag samples, q0 = the DC quant value."""
    m = zz >= MAXS
    cnt = m.sum(0)
    # C's int division truncates toward zero (the numerator can go
    # negative at deeper precisions, where floor division would differ)
    headroom = torch.div(MAXS * 64 - zz.sum(0), cnt.clamp_min(1),
                         rounding_mode="trunc")
    maxovershoot = MAXS + torch.clamp_max(headroom, min(31, 2 * int(q0)))
    val, active = _curve(zz, m, cnt)
    new = torch.minimum(torch.ceil(val).to(torch.int32), maxovershoot[None])
    return torch.where(m & active[None], new, zz).to(torch.int32)


def dering_float_t(zz: torch.Tensor, q0: int) -> torch.Tensor:
    """Float-DCT deringing (jcdctmgr.c:503-570 float_preprocess_deringing)
    on (64, N) float32 centered zigzag samples: the headroom cap divides in
    f32 (tensor by tensor, IEEE) and the curve value is not ceil'd."""
    m = zz >= MAXS
    cnt = m.sum(0)
    total = zz.sum(0)            # integers in f32: exact in any order
    head = torch.div(MAXS * 64.0 - total, cnt.clamp_min(1).to(torch.float32))
    maxovershoot = MAXS + torch.clamp_max(head, float(min(31, 2 * int(q0))))
    val, active = _curve(zz, m, cnt)
    new = torch.minimum(val, maxovershoot[None])
    return torch.where(m & active[None], new, zz)


def _curve(zz: torch.Tensor, m: torch.Tensor, cnt: torch.Tensor):
    """The Catmull-Rom overshoot value at every position of a run of
    clipped samples (f32, (64, N)), and whether each block is deringed."""
    dev = zz.device
    n = zz.shape[1]
    pos = torch.arange(64, device=dev)[:, None]
    notm = ~m
    active = (cnt > 0) & (cnt < 64)

    start = torch.where(notm, pos, -1).cummax(0).values + 1
    end = torch.where(notm, pos, 64).flip(0).cummin(0).values.flip(0)

    zdn = torch.cat([zz[:1], zz[:-1]], 0)            # zz[i-1]
    zup = torch.cat([zz[1:], zz[-1:]], 0)            # zz[i+1]
    f1 = _hold(zz, notm, False, zz[:1])
    f2 = _hold(zdn, notm, False, zz[:1])
    l1 = _hold(zz, notm, True, zz[-1:])
    l2 = _hold(zup, notm, True, zz[-1:])

    fslope = torch.maximum(f1 - f2, MAXS - f1)
    lslope = torch.maximum(l1 - l2, MAXS - l1)
    fslope_ = torch.where(start == 0, lslope, fslope)
    lslope_ = torch.where(end == 64, fslope, lslope)

    length = end - start
    step = _step_lut(dev)[torch.clamp(length + 1, 0, 65)]
    run_first = m & ~torch.cat(
        [torch.zeros((1, n), dtype=torch.bool, device=dev), m[:-1]], 0)

    # exact position accumulation: sequential f32 adds, restarted at
    # every run's first element
    t = torch.empty((64, n), dtype=torch.float32, device=dev)
    carry = torch.zeros(n, dtype=torch.float32, device=dev)
    for i in range(64):
        carry = torch.where(run_first[i], step[i], carry + step[i])
        t[i] = carry

    tan1 = (fslope_ * length).to(torch.float32)      # (v3 - v1) * length
    tan2 = (-lslope_ * length).to(torch.float32)     # (v4 - v2) * length
    t2 = t * t
    t3 = t2 * t
    cf1 = (2.0 * t3 - 3.0 * t2) + 1.0
    cf2 = (-2.0 * t3) + 3.0 * t2
    cf3 = (t3 - 2.0 * t2) + t
    cf4 = t3 - t2
    val = ((127.0 * cf1 + tan1 * cf3) + 127.0 * cf2) + tan2 * cf4
    return val, active
