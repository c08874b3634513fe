"""The trellis program's two row scans (ops/trellis_rows.py) on the CPU.

The DC trellis of one component (trellis_dc, whose CPU route is the plain
per-phase loop) against the JAX program that the main path mirrors,
make_trellis_all_t with no AC band and the DC trellis on; the EOB-run DP
(eob_dp, reading the AC kernel's `ei` strip and each image's AC code
lengths in place) against the JAX _eob_block_dp. Then numpy models of the
two CUDA kernels of csrc/trellis_rows.cu, each following its kernel's
order of work, against the plain versions bit for bit: the kernels cannot
run without a card, so these models are the CPU check of their algorithm.

  DC model: one warp per chain (an image's iMCU row), its v block rows in
  turn with lastDC carried from row to row and reset at each chain; per
  row and tile of 256 columns, every candidate and distortion first (one
  division a column), the pair costs trans(c[t][k] - c[t-1][l]) +
  dist[t][k] ahead of the chain, and a chain step that adds the
  predecessors' costs and takes the first minimum by a tree over l (the
  left, lower-index child unless the right one is strictly smaller); the
  final choice is the warp's lexicographic (cost, lane) minimum with idle
  lanes at +inf; the walk back runs in segments of ceil(bw / 32) columns
  (each segment's map of its end states, the maps chained from the last
  segment down, each segment walked); the chosen row is the next row's
  above_dc.
  EOB model: one warp per block row in push order; the serial azbc
  prefix on one lane; lane l owns steps l, l + 32, ...; once abc[t] is
  final every lane folds candidate t into its later steps with a strict
  '<', and step t's owner closes it (the BIG candidate t + 1, or (BIG,
  0) for an all-zero block) and hands abc[t + 1] to every lane; the
  final run over i in [0, L] as a warp's lexicographic (cost, i)
  minimum; the walk back along the back-pointers on one lane.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mozjpeg_tpu.codec import trellis as jtr
from mozjpeg_tpu.codec.pipeline import CompGeom as JGeom
from mozjpeg_tpu_torch.codec import trellis as ttr
from mozjpeg_tpu_torch.ops import trellis_rows as trw

F32 = np.float32
BIG = F32(1e38)
INF = F32(np.inf)
LANES = np.arange(32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _dc_si(rng):
    si = np.zeros(256, np.int32)
    si[:17] = rng.integers(2, 17, 17)
    return si


# (name, B, bh, bw, v, q0, nc, delta_w, precision): v 1 and 2 with
# bh % v != 0, delta_w 0 and 0.5, nc 1, 3 and 9, ties on the quant grid,
# the clamp at 1023 and at 16383, and 12-bit values whose squares and
# cand * q8 products wrap int32
DC_CASES = [
    ("v2-odd-delta-nc9-clamp", 2, 5, 7, 2, 2, 9, 0.5, 8),
    ("v1-nc3", 2, 3, 9, 1, 40, 3, 0.0, 8),
    ("v2-odd-delta-nc1", 1, 3, 6, 2, 5, 1, 0.5, 8),
    ("ties", 2, 4, 12, 2, 1, 9, 0.5, 8),
    ("12bit-wrap-delta", 2, 3, 8, 2, 3000, 9, 0.5, 12),
    ("12bit-clamp", 1, 3, 10, 1, 1, 9, 0.0, 12),
]


def dc_inputs(name, b, bh, bw, q0, precision, seed):
    return trw.dc_example_inputs("tie" if name == "ties" else "seeded", b,
                                 bh, bw, q0, precision, seed)


def _jax_dc_program(case, inputs):
    """The JAX trellis program's DC trellis of one component."""
    name, b, bh, bw, v, q0, nc, delta_w, precision = case
    raw_dc, lam, si = inputs
    geom = JGeom(h=1, v=v, w=8 * bw, hgt=8 * bh, bw=bw, bh=bh,
                 bw_pad=bw, bh_pad=bh)
    n = b * bh * bw
    raws = np.zeros((64, n), np.int32)
    raws[0] = raw_dc.reshape(-1)
    qz = np.full(64, 7, np.int32)
    qz[0] = q0
    run = jtr.make_trellis_all_t((geom,), None, (), True, (nc,),
                                 batch=b, precision=precision,
                                 delta_w=delta_w)
    packed = jtr.pack_trellis_inputs(
        [lam.reshape(-1)], [np.zeros((b, 256), np.int32)], [si], [qz])
    got = run((jnp.asarray(raws),),
              (jnp.zeros((64, n), jnp.int16),), jnp.asarray(packed))
    return np.asarray(got[0])[0].astype(np.int32).reshape(b, bh, bw)


@pytest.fixture(scope="module")
def dc_jax():
    """Each DC case through the JAX program: (case, inputs, DC out)."""
    out = {}
    for i, case in enumerate(DC_CASES):
        name, b, bh, bw, v, q0, nc, delta_w, precision = case
        inputs = dc_inputs(name, b, bh, bw, q0, precision, 40 + i)
        out[name] = (case, inputs, _jax_dc_program(case, inputs))
    return out


def _dc_args(case, inputs):
    name, b, bh, bw, v, q0, nc, delta_w, precision = case
    raw_dc, lam, si = inputs
    maxq = ttr.kmax_maxq(precision)[1]
    return (_t(raw_dc), _t(lam), q0, float(ttr.recip2_table()[q0]), si, nc,
            v, delta_w, maxq)


@pytest.mark.parametrize("name", [c[0] for c in DC_CASES])
def test_dc_component_matches_jax_program(dc_jax, name):
    """trellis_dc on the CPU (the plain per-phase loop) equals the JAX
    trellis program's DC trellis of the component, and so does the
    kernel's numpy model."""
    case, inputs, want = dc_jax[name]
    args = _dc_args(case, inputs)
    before = trw.trellis_dc.launches
    got = trw.trellis_dc(*args)
    assert trw.trellis_dc.launches == before      # the CPU launches nothing
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(model_dc(*args), want)


def test_dc_in_trellis_all_is_the_component_function():
    """trellis_all's DC stage gives trellis_dc's output in row 0 and
    records one call per component."""
    rng = np.random.default_rng(5)
    geoms = [JGeom(1, 2, 48, 40, 6, 5, 6, 5), JGeom(1, 1, 24, 24, 3, 3, 3, 3)]
    b, rec = 2, {}
    raws, qs, lams, sis, qzs = [], [], [], [], []
    for g in geoms:
        n = b * g.bh * g.bw
        raws.append(_t(rng.integers(-4000, 4000, (64, n)).astype(np.int32)))
        qs.append(_t(rng.integers(-9, 9, (64, n)).astype(np.int16)))
        lams.append(_t((rng.random(n) + 0.1).astype(F32)))
        sis.append(_dc_si(rng))
        qzs.append(np.full(64, 3 + len(qzs), np.int32))
    ncands = [ttr.get_num_dc_candidates(int(q[0])) for q in qzs]
    ac_sis = [torch.zeros((b, 256), dtype=torch.int32)] * 2
    outs = ttr.trellis_all(geoms, raws, qs, lams, ac_sis, sis, qzs, ncands,
                           b, bands=(), delta_w=0.5, record=rec)
    assert len(rec["trellis_dc"]) == 2 and "trellis_eob" not in rec
    for ci, g in enumerate(geoms):
        dc = trw.trellis_dc(*rec["trellis_dc"][ci])
        assert torch.equal(outs[ci][0], dc.reshape(-1).to(torch.int16))
        assert torch.equal(outs[ci][1:], qs[ci][1:])


eob_inputs = trw.eob_example_inputs


EOB_SHAPES = [(2, 3, 40), (1, 5, 1), (3, 2, 70)]


@pytest.fixture(scope="module")
def eob_jax():
    out = {}
    for i, (b, bh, bw) in enumerate(EOB_SHAPES):
        ei, si = eob_inputs(60 + i, b, bh, bw)
        r = b * bh
        with np.errstate(over="ignore"):
            want = jtr._eob_block_dp(
                jnp.asarray(ei[0].reshape(r, bw)),
                jnp.asarray(ei[1].reshape(r, bw)),
                jnp.asarray(ei[2].astype(np.int32).reshape(r, bw)),
                jnp.asarray(np.repeat(si.astype(F32), bh, 0)))
        out[(b, bh, bw)] = (ei, si, np.asarray(want))
    return out


@pytest.mark.parametrize("shape", EOB_SHAPES)
def test_eob_dp_matches_jax(eob_jax, shape):
    """eob_dp on the CPU (the plain version) equals the JAX
    _eob_block_dp, and so does the kernel's numpy model."""
    ei, si, want = eob_jax[shape]
    b, bh, bw = shape
    before = trw.eob_dp.launches
    got = trw.eob_dp(_t(ei), _t(si), bh, bw)
    assert trw.eob_dp.launches == before
    assert got.dtype == torch.bool and got.shape == (b * bh, bw)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(model_eob(ei, si, bh, bw), want)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    raw = torch.zeros((1, 2, 3), dtype=torch.int32)
    lam = torch.ones((1, 2, 3))
    si = np.zeros(256, np.int32)
    for bad in (dict(nc=10), dict(nc=0), dict(v=0), dict(dc_si=si[:16])):
        kw = dict(dc_si=si, nc=3, v=1) | bad
        with pytest.raises(ValueError):
            trw.trellis_dc(raw, lam, 4, 1 / 16, **kw)
    with pytest.raises(ValueError):
        trw.trellis_dc(raw.to(torch.int64), lam, 4, 1 / 16, si, 3, 1)
    with pytest.raises(ValueError):
        trw.trellis_dc(raw, lam.transpose(1, 2).contiguous().transpose(1, 2),
                       4, 1 / 16, si, 3, 1)
    ei = torch.zeros((8, 6))
    with pytest.raises(ValueError):
        trw.eob_dp(ei, torch.zeros((1, 256), dtype=torch.int32), 2, 4)
    with pytest.raises(ValueError):
        trw.eob_dp(ei, torch.zeros((1, 256), dtype=torch.int64), 2, 3)
    with pytest.raises(ValueError):
        trw.eob_dp(ei[:3], torch.zeros((1, 256), dtype=torch.int32), 2, 3)
    with pytest.raises(ValueError):
        trw.trellis_dc(raw.to("meta"), lam.to("meta"), 4, 1 / 16, si, 3, 1)


# ---------------------------------------------------------------------------
# numpy models of csrc/trellis_rows.cu
# ---------------------------------------------------------------------------

def _wrap(a):
    """int32 two's complement wrap of int64 values."""
    return ((np.asarray(a, np.int64) + 2 ** 31) % 2 ** 32 - 2 ** 31)


def _nbits(a):
    a = np.asarray(a, np.int64)
    out = np.zeros(a.shape, np.int64)
    for k in range(1, 33):
        out = np.where(a >= (1 << (k - 1)), k, out)
    return out


def warp_first_min(v, i):
    """The kernel's xor butterfly over 32 lanes on (value, index): every
    lane ends with the lexicographic minimum."""
    v, i = v.copy(), i.copy()
    for off in (16, 8, 4, 2, 1):
        ov, oi = v[LANES ^ off], i[LANES ^ off]
        take = (ov < v) | ((ov == v) & (oi < i))
        v, i = np.where(take, ov, v), np.where(take, oi, i)
    return v, i


DC_TC = 256        # columns a tile of the kernel's per-row pass


def first_min_tree(v):
    """The kernel's first-minimum tree over v (nc, ...): each node keeps
    its left (lower-index) child unless the right one is strictly
    smaller -> (value, index), each of shape v.shape[1:]."""
    nc = v.shape[0]
    vals = [v[l] for l in range(nc)]
    idx = [np.full(v.shape[1:], l, np.int64) for l in range(nc)]
    s = 1
    while s < nc:
        for j in range(0, nc - s, 2 * s):
            take = vals[j + s] < vals[j]
            vals[j] = np.where(take, vals[j + s], vals[j])
            idx[j] = np.where(take, idx[j + s], idx[j])
        s *= 2
    return vals[0], idx[0]


def model_dc(raw_dc, lam, q0, ltbl0, dc_si, nc, v, delta_w, maxq,
             tile=DC_TC):
    """trellis_dc_kernel's order of work, one chain (an image's iMCU row,
    its v rows in turn, lastDC from 0) at a time. Per row: per tile of
    `tile` columns, the per-row pass (one division a column, every
    candidate and distortion, slot 0 the column before the tile); the
    pair costs trans(c[t][k] - c[t-1][l]) + dist[t][k], formed ahead of
    the chain; the chain, whose step adds the predecessors' costs to the
    pairs and takes the first-minimum tree; the final choice as the
    warp's lexicographic (cost, lane) minimum with idle lanes at +inf;
    the walk back in segments of S = ceil(bw / 32) columns (each
    segment's map from its NC end states, the maps chained from the last
    segment down, each segment's walk); the chosen DC recomputed from the
    raw value, which is the next row's above_dc."""
    raw_dc, lam = raw_dc.numpy(), lam.numpy()
    b, bh, bw = raw_dc.shape
    si = np.asarray(dc_si, np.int64)[:17]
    q8, half = q0 * 8, nc // 2
    w, ltbl0 = F32(delta_w), F32(ltbl0)
    tw = min(tile, bw)
    tf = (np.arange(17) + si).astype(F32)           # trans by nbits(|d|)
    ks = np.arange(nc)
    out = np.zeros(raw_dc.shape, np.int32)

    def trans(d):
        return tf[_nbits(np.abs(d))]

    def cands(r, sel):
        x = np.abs(r.astype(np.int64))
        base = (x + (q8 >> 1)) // q8 - half           # x >= 0: C's division
        cm = np.clip(base[..., None] + sel, -maxq, maxq)
        return cm, np.where((r < 0)[..., None], -cm, cm)

    per_img = -(-bh // v)
    S = -(-bw // 32)
    nseg = -(-bw // S)
    for chain in range(b * per_img):
        img, r0 = chain // per_img, chain % per_img * v
        last, s_dc = 0, None
        for p in range(v):
            row = r0 + p
            if row >= bh:
                break
            grad = delta_w > 0.0 and p > 0
            rr, lr = raw_dc[img, row], lam[img, row]
            bts = np.zeros((bw, nc), np.int64)
            acc = None
            prev_c = None                              # tile slot 0
            for ts in range(0, bw, tw):
                tn = min(tw, bw - ts)
                cols = slice(ts, ts + tn)
                # 1. the per-row pass over the tile
                r = rr[cols]
                cm, c = cands(r, ks)
                lam_dc = lr[cols].astype(F32) * ltbl0
                d = _wrap(cm * q8 - np.abs(r.astype(np.int64))[:, None])
                dist = _wrap(d * d).astype(F32) * lam_dc[:, None]
                if grad:
                    ar = raw_dc[img, row - 1, cols].astype(np.int64)
                    vd = _wrap(_wrap(ar - r)[:, None]
                               - _wrap(_wrap(s_dc[cols].astype(np.int64)
                                             * q8)[:, None]
                                       - _wrap(c * q8)))
                    vdist = _wrap(vd * vd).astype(F32) * lam_dc[:, None]
                    dist = dist + w * (vdist - dist)
                slots = c if prev_c is None else np.concatenate(
                    [prev_c[None], c])
                off = 0 if prev_c is None else 1      # slot of column ts
                # 2. the pair costs ahead of the chain, then the chain
                i0 = 0
                if ts == 0:
                    acc = trans(c[0] - last) + dist[0]
                    i0 = 1
                for i in range(i0, tn):
                    pair = (trans(slots[i + off][None, :]
                                  - slots[i + off - 1][:, None])
                            + dist[i][None, :])        # (l, k)
                    best, bl = first_min_tree(pair + acc[:, None])
                    bts[ts + i] = bl
                    acc = best
                prev_c = c[-1]
            lanes_acc = np.where(LANES < nc, acc[np.minimum(LANES, nc - 1)],
                                 INF)
            _, fi = warp_first_min(lanes_acc, LANES)
            # 3. the walk back in segments
            seg_map = {}
            for j in range(1, nseg):
                t0, t1 = j * S, min(j * S + S, bw) - 1
                cur = ks.copy()
                for t in range(t1, t0, -1):
                    cur = bts[t, cur]
                seg_map[j] = bts[t0, cur]
            sel = np.zeros(bw, np.int64)
            for j in range(nseg):
                t0, t1 = j * S, min(j * S + S, bw) - 1
                cur = int(fi[0])
                for jj in range(nseg - 1, j, -1):
                    cur = int(seg_map[jj][cur])
                for t in range(t1, t0, -1):
                    sel[t], cur = cur, int(bts[t, cur])
                sel[t0] = cur
            # 4. the chosen DC of every column
            vals = np.take_along_axis(cands(rr, ks)[1], sel[:, None],
                                      1)[:, 0].astype(np.int32)
            out[img, row] = vals
            s_dc, last = vals, int(vals[-1])
    return out


def model_eob(ei, ac_si, bh, bw):
    """eob_dp_kernel's push order, every block row at once (a warp a row):
    the row's czero summed on one lane in C order into azbc, base[b] =
    skip[b] + azbc[b], req = [0, has_eob...]; lane l owns steps l, l + 32,
    ... (registers up to 512 steps, shared memory past them: the same
    order). For t = 0..L-1, with abc[t] final: every lane folds candidate
    t into its steps b >= t with a strict '<' (cost ((base[b] - azbc[t]) +
    abc[t]) + rate(b - t + req[t]), or BIG where req[t] is 2); step t's
    owner closes it (the BIG candidate t + 1, or (BIG, 0) for an all-zero
    block) and abc[t + 1] goes to every lane. Then the final run over i
    in [0, L] (lanes fold i = lane, lane + 32, ..., the warp's
    lexicographic minimum) and the walk back along the back-pointers."""
    n = ei.shape[1]
    rows, L = n // bw, bw
    S = -(-L // 32)
    steps = np.arange(32 * S)                       # 32 j + lane
    kept = np.zeros((rows, L), bool)
    with np.errstate(over="ignore", invalid="ignore"):
        si = ac_si[np.arange(rows) // bh].astype(np.int64)
        rate = np.zeros((rows, 32), F32)
        rate[:, :16] = np.arange(16).astype(F32) + si[:, 0:256:16].astype(F32)
        czero = ei[0].reshape(rows, L)
        req = np.concatenate([np.zeros((rows, 1), np.int64),
                              ei[2].reshape(rows, L).astype(np.int64)], 1)
        azbc = np.zeros((rows, L + 1), F32)
        a = np.zeros(rows, F32)
        for b in range(L):                          # one lane, C order
            a = a + czero[:, b]
            azbc[:, b + 1] = a
        base = np.zeros((rows, 32 * S), F32)
        base[:, :L] = ei[1].reshape(rows, L) + azbc[:, :L]
        zero = np.zeros((rows, 32 * S), bool)
        zero[:, :L] = req[:, 1:] == 2
        bv = np.full((rows, 32 * S), INF)
        bi = np.zeros((rows, 32 * S), np.int64)
        abc = np.zeros(rows, F32)
        rix = np.arange(rows)[:, None]
        for t in range(L):
            rq = req[:, t]
            d = np.maximum(steps[None, :] - t + rq[:, None], 0)
            c = ((base - azbc[:, t, None]) + abc[:, None]) + rate[rix,
                                                                  _nbits(d)]
            c = np.where((rq != 2)[:, None], c, BIG)
            upd = (steps >= t)[None, :] & (c < bv)
            bv, bi = np.where(upd, c, bv), np.where(upd, t, bi)
            # the owner closes step t
            z, big = zero[:, t], BIG < bv[:, t]
            abc = np.where(z | big, BIG, bv[:, t])
            bi[:, t] = np.where(z, 0, np.where(big, t + 1, bi[:, t]))
        brs = bi[:, :L]
        for r in range(rows):
            def end_cost(i):
                c = (azbc[r, L] - azbc[r, i]) + rate[r, _nbits(L - i
                                                               + req[r, i])]
                return np.where(req[r, i] != 2, c, BIG)
            fv, fi = np.full(32, INF), np.full(32, 1 << 30)
            for i0 in range(0, L + 1, 32):
                i = i0 + LANES
                on = i <= L
                c = end_cost(np.minimum(i, L))
                upd = on & (c < fv)
                fv, fi = np.where(upd, c, fv), np.where(upd, i, fi)
            _, fi = warp_first_min(fv, fi)
            last = int(fi[0]) - 1
            while 0 <= last < L:                    # the walk back
                kept[r, last] = True
                nxt = int(brs[r, last]) - 1
                if nxt >= last:
                    break
                last = nxt
    return kept


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("v,nc,delta_w,precision", [
    (1, 9, 0.0, 8), (2, 9, 0.5, 8), (3, 5, 0.25, 8), (4, 1, 1.0, 8),
    (2, 3, 0.5, 12), (2, 9, 0.0, 12)])
def test_dc_kernel_model_matches_plain(seed, v, nc, delta_w, precision):
    """The DC kernel's model against the plain version on seeded inputs:
    bh % v != 0 for v > 1, ragged chains, ties (seed 0 takes the tie
    generator), 12-bit wrap and clamps."""
    b, bh, bw = 2, 2 * v + 1, 5 + seed
    if seed == 0:
        name, q0 = "ties", 1
    else:
        name, q0 = "seeded", (1, 2, 9, 33, 3000)[seed - 1]
    raw_dc, lam, si = dc_inputs(name, b, bh, bw, q0, precision, 100 + seed)
    case = (name, b, bh, bw, v, q0, nc, delta_w, precision)
    args = _dc_args(case, (raw_dc, lam, si))
    np.testing.assert_array_equal(model_dc(*args),
                                  trw.trellis_dc_plain(*args).numpy())


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("b,bh,bw", [(1, 4, 33), (2, 2, 17), (1, 6, 2),
                                    (1, 4, 70)])
def test_eob_kernel_model_matches_plain(seed, b, bh, bw):
    """The EOB kernel's model against the plain version: rows past one
    warp's 32 candidates (bw 33), runs past 16, BIG costs."""
    ei, si = eob_inputs(200 + seed, b, bh, bw)
    with np.errstate(over="ignore"):
        want = trw.eob_dp_plain(_t(ei), _t(si), bh, bw).numpy()
    np.testing.assert_array_equal(model_eob(ei, si, bh, bw), want)


EOB_LS = (1, 31, 32, 33, 504)     # row lengths around a warp, 12 MP luma


@pytest.fixture(scope="module")
def eob_adversarial_jax():
    """Adversarial EOB rows (every cost tied, all zero, every other block
    all zero, keep-heavy, seeded; trellis_rows.eob_example_inputs) for each
    row length, through the JAX _eob_block_dp (one compile per length)."""
    dp = jax.jit(jtr._eob_block_dp)
    out = {}
    for L in EOB_LS:
        ei, si = eob_inputs(700 + L, 2, 5, L, "adversarial")
        with np.errstate(over="ignore"):
            want = dp(jnp.asarray(ei[0].reshape(-1, L)),
                      jnp.asarray(ei[1].reshape(-1, L)),
                      jnp.asarray(ei[2].astype(np.int32).reshape(-1, L)),
                      jnp.asarray(np.repeat(si.astype(F32), 5, 0)))
        out[L] = (ei, si, np.asarray(want))
    return out


@pytest.mark.parametrize("L", EOB_LS)
def test_eob_push_model_on_adversarial_rows_matches_plain_and_jax(
        eob_adversarial_jax, L):
    """The push-order model and the plain version against the JAX
    _eob_block_dp on rows of every cost tied (equal EOBn costs), all-zero
    rows, every other block all zero, keep-heavy rows (long walks back)
    and seeded rows, at L = 1, 31, 32, 33 and 504 (a 12 MP luma row)."""
    ei, si, want = eob_adversarial_jax[L]
    with np.errstate(over="ignore"):
        plain = trw.eob_dp_plain(_t(ei), _t(si), 5, L).numpy()
    np.testing.assert_array_equal(plain, want)
    np.testing.assert_array_equal(model_eob(ei, si, 5, L), want)
    assert want[3::5].sum() > L // 2 or L < 4     # keep-heavy rows keep


@pytest.mark.parametrize("L", [513, 700])
def test_eob_push_model_past_the_registers_matches_plain(L):
    """Rows longer than the kernel's 512 register steps (its shared-memory
    states), adversarial, against the plain version."""
    ei, si = eob_inputs(800 + L, 1, 5, L, "adversarial")
    with np.errstate(over="ignore"):
        plain = trw.eob_dp_plain(_t(ei), _t(si), 5, L).numpy()
    np.testing.assert_array_equal(model_eob(ei, si, 5, L), plain)


# (name, B, bh, bw, v, q0, nc, delta_w, precision) of the inputs built to
# break the kernel: every candidate tied (one raw value, lambda 0, equal
# transitions) at nc 1, 2, 8 and 9 and bw 1 and 33 (33: the walk back's
# 17 segments of 2 columns); 12-bit squares that wrap int32
# and the clamp at 16383; the vertical gradient at v = 2 with an odd bh
DC_MORE = [("alltie-nc%d-bw%d" % (nc, bw), 1, 2, bw, 1, 8, nc, 0.0, 8)
           for nc in (1, 2, 8, 9) for bw in (1, 33)] + [
    ("12bit-wrap", 1, 3, 33, 1, 3000, 9, 0.0, 12),
    ("12bit-clamp-16383", 1, 3, 33, 1, 1, 9, 0.0, 12),
    ("grad-v2-odd-bh", 2, 5, 33, 2, 2, 9, 0.5, 8),
]


@pytest.fixture(scope="module")
def dc_jax_more():
    """Each DC_MORE case through the JAX package: trellis_dc_rows over
    the rows for v = 1 (independent rows, lastDC 0, lambda * 1/q0^2 in
    f32), the trellis program for v = 2."""
    out = {}
    for i, case in enumerate(DC_MORE):
        name, b, bh, bw, v, q0, nc, delta_w, precision = case
        kind = "alltie" if name.startswith("alltie") else "seeded"
        inputs = trw.dc_example_inputs(kind, b, bh, bw, q0, precision,
                                       500 + i)
        if v == 1:
            raw_dc, lam, si = inputs
            lam_dc = lam * F32(ttr.recip2_table()[q0])
            got, _ = jtr.trellis_dc_rows(
                jnp.asarray(raw_dc.reshape(-1, bw)),
                jnp.zeros(b * bh, jnp.int32), jnp.int32(q0),
                jnp.asarray(si), jnp.asarray(lam_dc.reshape(-1, bw)), nc,
                ttr.kmax_maxq(precision)[1])
            want = np.asarray(got).astype(np.int32).reshape(b, bh, bw)
        else:
            want = _jax_dc_program(case, inputs)
        out[name] = (case, inputs, want)
    return out


@pytest.mark.parametrize("name", [c[0] for c in DC_MORE])
def test_dc_adversarial_inputs_match_plain_and_jax(dc_jax_more, name):
    """The plain version and the DC kernel's model on the inputs built
    to break the kernel (ties everywhere, nc 1-9, one column and two
    walk-back segments, int32 wrap, the 16383 clamp, the gradient at an
    odd bh) equal the JAX package."""
    case, inputs, want = dc_jax_more[name]
    args = _dc_args(case, inputs)
    np.testing.assert_array_equal(trw.trellis_dc_plain(*args).numpy(), want)
    np.testing.assert_array_equal(model_dc(*args), want)


@pytest.mark.parametrize("kind,q0", [("tie", 1), ("seeded", 2)])
@pytest.mark.parametrize("bw,tile", [(260, DC_TC), (45, 8)])
def test_dc_model_across_tiles_matches_plain(bw, tile, kind, q0):
    """Rows past one tile of the per-row pass (the kernel's 256 columns,
    and 8-column tiles over a short row), with the vertical gradient, on
    tie-heavy small steps and on spread values: each tile's slot 0
    carries the column before it."""
    case = (kind, 1, 3, bw, 2, q0, 9, 0.5, 8)
    inputs = trw.dc_example_inputs(kind, 1, 3, bw, q0, 8, 300 + bw)
    args = _dc_args(case, inputs)
    np.testing.assert_array_equal(model_dc(*args, tile=tile),
                                  trw.trellis_dc_plain(*args).numpy())
