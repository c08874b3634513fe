"""The port's restart-parallel bit packers (mozjpeg_tpu_torch/ops/bitpack.py)
against the JAX package's (mozjpeg_tpu/ops/bitpack.py) and the serial
host coder, byte for byte: sequential and every progressive scan kind,
with and without restarts, at 8 and 12 bits, on the same seeded planes;
and encode_many with device_entropy (MJ_DEVICE_ENTROPY) against the
port's host emission and the JAX package's device emission.

Each JAX packer compiles once per scan kind, geometry and restart
interval (1-4 s here), so the cases share one geometry.
"""
import numpy as np
import pytest
import torch

import mozjpeg_tpu as mj
import mozjpeg_tpu_torch as mjt
from mozjpeg_tpu.ops import bitpack as jbp
from mozjpeg_tpu_torch.codec import encoder as E
from mozjpeg_tpu_torch.codec import scans
from mozjpeg_tpu_torch.codec.pipeline import geometry
from mozjpeg_tpu_torch.entropy import encode as entenc
from mozjpeg_tpu_torch.entropy.huffman import derive_codes
from mozjpeg_tpu_torch.ops import bitpack as bp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread while this file runs: the suite runs several
    workers on the host's cores, and the engines' many small ops, each
    a parallel region on every core, then wait on one another's
    threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GEOM = geometry(168, 120, [(2, 2), (1, 1), (1, 1)])   # partial MCUs
TBL = {0: 0, 1: 1, 2: 1}


def _planes(precision, seed):
    """Per component (bh_pad, bw_pad, 64) int16 zigzag planes: a DC walk,
    sparse AC of both signs, all-zero blocks, long zero runs (ZRLs) and,
    at 12 bits, magnitudes of 14 bits."""
    rng = np.random.default_rng(seed)
    amp = 255 if precision == 8 else 8191
    out = []
    for g in GEOM[2]:
        p = np.zeros((g.bh_pad, g.bw_pad, 64), np.int16)
        p[:, :, 0] = np.cumsum(rng.integers(-40, 41, (g.bh_pad, g.bw_pad)),
                               1) * (1 if precision == 8 else 8)
        nz = rng.random((g.bh_pad, g.bw_pad, 63)) < 0.15
        p[:, :, 1:] = np.where(nz, rng.integers(-amp, amp + 1, nz.shape), 0)
        p[::3, ::4, 1:] = 0                            # lone EOBs
        p[1::5, ::3, 1:63] = 0                          # 62 zeros, 3 ZRLs
        out.append(p)
    return out


def _tables(sg, restart):
    """The scan's optimal tables from the host's statistics -> per scan
    component (ehufco, ehufsi) DC and AC lists."""
    _, dcc, acc = entenc.encode_scan(sg, TBL, TBL, {}, {}, restart,
                                     gather=True)
    dc, ac = [], []
    for ci, _, _ in sg.entries:
        t = TBL[ci]
        dc.append(derive_codes(entenc.gen_optimal_table(dcc[t]))
                  if dcc[t].any() else None)
        ac.append(derive_codes(entenc.gen_optimal_table(acc[t]))
                  if acc[t].any() else None)
    return dc, ac


CASES = [  # (scan, restart, precision)
    (scans.ScanInfo((0, 1, 2), 0, 63, 0, 0), 0, 8),
    (scans.ScanInfo((0, 1, 2), 0, 63, 0, 0), 5, 8),
    (scans.ScanInfo((0, 1, 2), 0, 0, 0, 1), 0, 8),
    (scans.ScanInfo((0, 1, 2), 0, 0, 0, 1), 3, 8),
    (scans.ScanInfo((0, 1, 2), 0, 0, 1, 0), 0, 8),
    (scans.ScanInfo((0,), 1, 5, 0, 2), 0, 8),
    (scans.ScanInfo((1,), 6, 63, 0, 0), 7, 8),
    (scans.ScanInfo((0,), 1, 63, 1, 0), 0, 8),
    (scans.ScanInfo((2,), 3, 40, 2, 1), 7, 8),
    (scans.ScanInfo((0, 1, 2), 0, 63, 0, 0), 0, 12),
    (scans.ScanInfo((0,), 1, 63, 0, 0), 4, 12),
]


@pytest.mark.parametrize("scan,restart,precision", CASES)
def test_packers_match_jax_and_host(scan, restart, precision):
    planes = _planes(precision, 3 + restart)
    sg = entenc.ScanGeometry(scan, GEOM, planes)
    dc, ac = _tables(sg, restart)
    host = E.encode_scan_optimal(sg, TBL, TBL, restart).data
    sub = [planes[ci] for ci, _, _ in sg.entries]
    geoms = [(h, v) for _, h, v in sg.entries]
    args = (geoms, sg.mcus_x, sg.mcus_y)
    ours = _pack(sub, args, scan, restart, dc, ac)
    if scan.Ss == 0 and scan.Se == 63:
        theirs = jbp.encode_scan_bitpar(sub, *args, restart, dc, ac,
                                        precision=precision)
    else:
        theirs = jbp.encode_scan_progressive_device(
            sub, *args, scan.Ss, scan.Se, scan.Ah, scan.Al, restart,
            dc_tables=dc if scan.Ss == 0 else None,
            ac_tables=ac if scan.Ss else None, precision=precision)
    assert ours == theirs
    assert ours == host


def _pack(sub, args, scan, restart, dc, ac):
    """The port's packer of the scan's kind."""
    if scan.Ss == 0 and scan.Se == 63:
        return bp.encode_scan_bitpar(sub, *args, restart, dc, ac)
    return bp.encode_scan_progressive_device(
        sub, *args, scan.Ss, scan.Se, scan.Ah, scan.Al, restart,
        dc_tables=dc if scan.Ss == 0 else None,
        ac_tables=ac if scan.Ss else None)


@pytest.mark.parametrize("scan,restart,precision", CASES)
def test_packers_in_chunks(scan, restart, precision, monkeypatch):
    """Lanes built a few rows at a time (a chunk that straddles restart
    segments, the two-pass placement, correction bits attached to flushes
    in other chunks) give the host coder's bytes."""
    planes = _planes(precision, 3 + restart)
    sg = entenc.ScanGeometry(scan, GEOM, planes)
    dc, ac = _tables(sg, restart)
    sub = [planes[ci] for ci, _, _ in sg.entries]
    args = ([(h, v) for _, h, v in sg.entries], sg.mcus_x, sg.mcus_y)
    rows = []
    real = bp.pack_rows

    def spy(dev, n_rows, *a, **k):
        rows.append(n_rows)
        return real(dev, n_rows, *a, **k)

    monkeypatch.setattr(bp, "pack_rows", spy)
    monkeypatch.setattr(bp, "chunk_rows", lambda dev, lanes_per_row: 7)
    ours = _pack(sub, args, scan, restart, dc, ac)
    assert rows and min(rows) > 2 * 7               # several chunks
    assert ours == E.encode_scan_optimal(sg, TBL, TBL, restart).data


def test_device_twins_and_rst_stitching():
    """Planes given as device twins (DualPlane) pack like host arrays; a
    shard's segments stitch with rst_offset and a trailing marker."""
    planes = _planes(8, 1)
    scan = scans.ScanInfo((0, 1, 2), 0, 63, 0, 0)
    sg = entenc.ScanGeometry(scan, GEOM, planes)
    dc, ac = _tables(sg, 2)
    twins = []
    for p in planes:
        d = np.zeros_like(p).view(E.DualPlane)
        d.dev = torch.as_tensor(p)
        twins.append(d)
    args = ([(2, 2), (1, 1), (1, 1)], GEOM[0], GEOM[1], 2, dc, ac)
    assert bp.encode_scan_bitpar(twins, *args) == \
        bp.encode_scan_bitpar(planes, *args)
    for off, trail in ((3, False), (6, True)):
        assert bp.encode_scan_bitpar(planes, *args, rst_offset=off,
                                     trailing_rst=trail) == \
            jbp.encode_scan_bitpar(planes, *args, rst_offset=off,
                                   trailing_rst=trail)


def test_ac_refine_eob_bins_match_jax():
    rng = np.random.default_rng(9)
    n = 5000
    e = (rng.random(n) < 0.9).astype(np.int32)
    br = np.where(e > 0, rng.integers(0, 40, n), 0).astype(np.int32)
    ev = (rng.random(n) < 0.02).astype(np.int32)
    for ri in (0, 1, 37, 3000):
        np.testing.assert_array_equal(bp.ac_refine_eob_bins(e, br, ev, ri),
                                      jbp.ac_refine_eob_bins(e, br, ev, ri))


def _photos(n, h=48, w=64):
    rng = np.random.default_rng(21)
    yy, xx = np.mgrid[0:h, 0:w]
    return [np.clip(np.stack([127 + 90 * np.sin(xx / (4 + i) + i),
                              127 + 80 * np.cos(yy / 3),
                              255.0 * (xx + yy) / (w + h)], -1)
                    + rng.normal(0, 16, (h, w, 3)), 0, 255).astype(np.uint8)
            for i in range(n)]


REFINE_SCRIPT = [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2),
                 ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1),
                 ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                 ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0),
                 ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0)]


@pytest.mark.parametrize("kw,jax_too", [
    ({"progressive": False}, True),
    ({"optimize_scans": False}, True),
    ({"progressive": False, "restart_in_rows": 1}, False),
    ({"scan_script": REFINE_SCRIPT}, False),
    ({"optimize_scans": False, "restart_interval": 3}, False),
    ({"progressive": False, "optimize_coding": False}, False),
])
def test_device_entropy_encode_many(kw, jax_too):
    """encode_many(device_entropy=True) gives the host emission's bytes
    (and the JAX package's, on the two aligned images, for a sequential
    and a simple progressive frame), with no scan left to the host
    coder."""
    imgs = _photos(2) + [_photos(1, 29, 37)[0]]
    E.reset_host_routes()
    dev = mjt.encode_many(imgs, mjt.EncoderConfig(device_entropy=True, **kw),
                          device="cpu")
    assert E.engine_host_routes == {"emit": 0, "search": 0}
    assert dev == mjt.encode_many(imgs, mjt.EncoderConfig(**kw),
                                  device="cpu")
    if jax_too:
        assert dev[:2] == mj.encode_many(imgs[:2], mj.EncoderConfig(
            device_entropy=True, **kw))


def test_device_entropy_12bit_and_env(monkeypatch):
    """12-bit device emission, and MJ_DEVICE_ENTROPY=1 / 0."""
    img12 = [(p.astype(np.uint16) << 4) | 9 for p in _photos(2)]
    kw = dict(precision=12, optimize_scans=False)
    assert mjt.encode_many(img12, mjt.EncoderConfig(device_entropy=True,
                                                    **kw), device="cpu") == \
        mjt.encode_many(img12, mjt.EncoderConfig(**kw), device="cpu")
    calls = []
    real = bp.encode_scan_progressive_device

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(bp, "encode_scan_progressive_device", spy)
    imgs = _photos(1)
    cfg = mjt.EncoderConfig(optimize_scans=False)
    monkeypatch.setenv("MJ_DEVICE_ENTROPY", "1")
    on = mjt.encode_many(imgs, cfg, device="cpu")
    nscans = len(scans.simple_progression_max(3, 0, True))
    assert len(calls) == nscans
    monkeypatch.setenv("MJ_DEVICE_ENTROPY", "0")
    assert mjt.encode_many(imgs, cfg, device="cpu") == on
    assert len(calls) == nscans


def test_device_entropy_python_search(monkeypatch):
    """The Python scan search (MJ_NATIVE_SCANSEARCH=0) emits every
    candidate with the device packers, with the native search's bytes."""
    imgs = _photos(1)
    native = mjt.encode_many(imgs, mjt.EncoderConfig(), device="cpu")
    monkeypatch.setenv("MJ_NATIVE_SCANSEARCH", "0")
    E.reset_host_routes()
    assert mjt.encode_many(imgs, mjt.EncoderConfig(device_entropy=True),
                           device="cpu") == native
    assert E.engine_host_routes["emit"] == 0
