"""The AC trellis kernel's algorithm, on the CPU: a scalar per-block model
of csrc/trellis_ac.cu, written here in numpy float32, against the plain
PyTorch version, bit for bit on both outputs.

The kernel cannot run without a card, so this model is what holds its
order of work here: the serial azd prefix over the band only, a DP that
visits the nonzero positions alone, with the predecessors (Ss-1, then the
earlier nonzero positions) split over LANES lanes by j % LANES, each lane
folding its j ascending and k ascending with strict '<' from BIG, the
lanes joined by the lexicographic minimum of (cost, j), and (j 0, cand 0)
for a step that nothing beats; the end selection as the lexicographic
minimum of (end cost, j) over the start state, the first zero position and
the nonzero positions; a path walk over nonzero positions. The inputs come from
codec/trellis.ac_example_inputs, which tests/test_torch_cuda.py and
chip_smoke.py use too.
"""
import numpy as np
import pytest
import torch

from mozjpeg_tpu_torch.codec import trellis as ttr
from mozjpeg_tpu_torch.ops import trellis_ac as tac

F32 = np.float32
BIG = F32(1e38)
KINDS = ("tie", "sparse", "dense", "zero", "no_codes")
BANDS = ((1, 63), (1, 8), (9, 63))
LANES = 8          # lanes per block in the kernel (csrc/trellis_ac.cu L)


def _wrap32(v):
    return np.int64(v).astype(np.int32)    # int32 products wrap


def _lexmin(cands):
    """Lexicographic minimum of (cost, j, payload) tuples, as the kernel's
    shuffle over lanes; the payload rides along."""
    best = cands[0]
    for c in cands[1:]:
        if c[0] < best[0] or (c[0] == best[0] and c[1] < best[1]):
            best = c
    return best


def model_block(raw, q8, ltbl, lut, lam, ss, se):
    """One block as the kernel's lanes compute it -> (new_band (64,)
    int32, ei (8,) f32, DP steps taken, path-walk steps)."""
    azd = {ss - 1: F32(0)}
    acc = {ss - 1: F32(0)}
    run = F32(0)
    mask = []
    for p in range(ss, se + 1):
        xa = abs(int(raw[p]))
        run = run + (F32(_wrap32(xa * xa)) * lam) * ltbl[p]
        azd[p] = run
        if xa >= q8[p] - (q8[p] >> 1):           # qval != 0
            mask.append(p)
    azd_se = run
    rs, bv = {}, {}
    for i in mask:                               # nonzero positions only
        x = abs(int(raw[i]))
        qval = min((x + (q8[i] >> 1)) // q8[i], 1023)
        nc = int(qval).bit_length()
        cand = [qval if nc == k + 1 else (2 << k) - 1 for k in range(nc)]
        cdist = [(F32(_wrap32((c * q8[i] - x) ** 2)) * lam) * ltbl[i]
                 for c in cand]
        lanes = []
        for lane in range(LANES):
            best, bj, bc = BIG, 0, 0
            for j in [ss - 1] + [m for m in mask if m < i]:
                if j % LANES != lane:
                    continue
                tail = (azd[i - 1] - azd[j]) + acc[j]
                for k in range(nc):
                    rate = lut[64 - i + j, k]
                    cost = (rate + cdist[k]) + tail
                    if rate < BIG and cost < best:
                        best, bj, bc = cost, j, cand[k]
            lanes.append((best, bj, bc))
        acc[i], rs[i], bv[i] = _lexmin(lanes)
    eobl = lut[127, 0]
    start = (azd_se + eobl, ss - 1, azd_se)
    zeros = [p for p in range(64) if p != ss - 1 and p not in mask]
    if zeros:                                    # end cost BIG there
        z = zeros[0]
        azd_z = F32(0) if z < ss else (azd_se if z > se else azd[z])
        start = _lexmin([start, (BIG, z, (BIG + azd_se) - azd_z)])
    lanes = [start if lane == 0 else (F32(np.inf), 64, F32(0))
             for lane in range(LANES)]
    for j in mask:
        end_wo = (acc[j] + azd_se) - azd[j]
        ec = end_wo + (eobl if j < se else F32(0))
        lanes[j % LANES] = _lexmin([lanes[j % LANES], (ec, j, end_wo)])
    _, last, skip = _lexmin(lanes)
    nb = np.zeros(64, np.int32)
    cur, walk = last, 0
    while cur >= ss and cur in rs:
        nb[cur] = -bv[cur] if raw[cur] < 0 else bv[cur]
        cur, walk = rs[cur], walk + 1
    ei = np.zeros(8, np.float32)
    ei[0], ei[1] = azd_se, skip
    ei[2] = F32(last < se) + F32(last == ss - 1)
    return nb, ei, len(mask), walk


@pytest.mark.parametrize("band", BANDS)
@pytest.mark.parametrize("kind", KINDS)
def test_nonzero_only_order_equals_plain(kind, band):
    ss, se = band
    b, n_img = 2, 24 if kind == "dense" else 150
    raw, qtbl, ltbl, luts, lam = ttr.ac_example_inputs(kind, b, n_img,
                                                       seed=len(kind))
    nb_p, ei_p = tac.trellis_ac_plain(
        torch.as_tensor(raw), torch.as_tensor(qtbl), torch.as_tensor(ltbl),
        torch.as_tensor(luts), torch.as_tensor(lam), ss, se, n_img)
    q8 = [int(q) << 3 for q in qtbl]
    steps = 0
    for n in range(b * n_img):
        nb, ei, nnz, walk = model_block(raw[:, n], q8, ltbl, luts[n // n_img],
                                        lam[n], ss, se)
        assert walk <= nnz
        steps += nnz
        np.testing.assert_array_equal(nb, nb_p[:, n].numpy())
        assert ei.tobytes() == ei_p[:, n].numpy().tobytes(), n
    assert (steps == 0) == (kind == "zero")
    if kind == "dense":
        assert steps == b * n_img * (se - ss + 1)
