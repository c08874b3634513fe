"""The port's progressive AC coders (native/entropy.cpp mj_encode_ac_first
and mj_encode_ac_refine, a per-block nonzero bitmap walked by count
trailing zeros) held to their plain twins (mj_encode_ac_{first,refine}
_plain, every coefficient tested one at a time) on the CPU.

- Gather: the same symbol counts and return value; emission with the
  optimal tables of those counts: the same bytes and return value.
- Every band and Al of the scan search's script (native/scansearch.cpp
  build_script), restart intervals 0, 1 and 7, on seeded planes: all
  zero, photo-like, dense, and with +-1023, +-16383 and +-32767 values,
  at odd strides whose padding holds junk.
- An all-zero band over more than 32,767 blocks (the 0x7FFF EOB-run
  flush), and a refinement plane of correction bits alone (BE > 937).
- The walked-block counters: every block, and those whose band is empty
  after the point transform.
- entropy.cpp built alone with the portable flags (MJ_NATIVE_PORTABLE=1,
  no -march=native: the scalar prepare) gives the same on a subset.
"""
import ctypes
import os
import subprocess

import numpy as np
import pytest

from mozjpeg_tpu_torch import native
from mozjpeg_tpu_torch.entropy.encode import gen_optimal_table
from mozjpeg_tpu_torch.entropy.huffman import derive_codes
from mozjpeg_tpu_torch.native import build

# (Ss, Se, Ah, Al): the AC scans of build_script, luma and chroma
SPLITS = (2, 5, 8, 12, 18)
SCANS = sorted(
    {(1, 8, 0, al) for al in range(4)} | {(9, 63, 0, al) for al in range(4)}
    | {(1, 63, al + 1, al) for al in range(3)} | {(1, 63, 0, 0)}
    | {(1, f, 0, 0) for f in SPLITS} | {(f + 1, 63, 0, 0) for f in SPLITS})
RESTARTS = (0, 1, 7)
KINDS = ("zero", "photo", "dense", "max1023", "max16383", "max32767")

_PLAIN = {"first": "mj_encode_ac_first_plain",
          "refine": "mj_encode_ac_refine_plain"}
_NEW = {"first": "mj_encode_ac_first", "refine": "mj_encode_ac_refine"}


def _plane(kind, seed, bh=9, bw=13, pad=4):
    """A (bh, bw + pad, 64) zigzag plane; the pad columns hold junk the
    coders must not read."""
    rng = np.random.default_rng([seed, KINDS.index(kind)])
    shape = (bh, bw + pad, 64)
    if kind == "zero":
        p = np.zeros(shape, np.int16)
    elif kind == "photo":
        # about 2 nonzero AC a block, thinning out with frequency; DC wide
        k = np.arange(64)
        keep = rng.random(shape) < np.minimum(1.0, 0.35 * np.exp(-k / 6.0))
        p = np.where(keep, np.rint(rng.laplace(0, 6, shape)), 0)
        p[..., 0] = rng.integers(-1023, 1024, shape[:2])
    elif kind == "dense":
        # every coefficient nonzero, many of them +-1 .. +-3
        mag = np.where(rng.random(shape) < 0.5, rng.integers(1, 4, shape),
                       rng.integers(1, 1024, shape))
        p = mag * rng.choice([-1, 1], shape)
    else:
        lim = int(kind[3:])
        p = np.rint(rng.laplace(0, 40, shape))
        p[rng.random(shape) < 0.4] = 0
        ext = rng.random(shape) < 0.15
        p[ext] = rng.choice([-lim, lim, -(lim - 1), lim // 2], ext.sum())
        p = np.clip(p, -lim, lim)
    p = np.asarray(p, np.int16)
    p[:, bw:] = rng.integers(-32767, 32768, (bh, pad, 64))
    return p, bw


def _comp(p, bw, tbl):
    c = native.CompPlane()
    c.coef = p.ctypes.data
    c.bw, c.bh, c.stride = bw, p.shape[0], p.shape[1]
    c.h = c.v = 1
    c.dc_tbl = c.ac_tbl = tbl
    return c


def _call(fn, p, bw, scan, ri, tables=None, walked=False, tbl=1):
    """One coder call -> (return value, ac counts, bytes or None, walked
    counters or None); with tables None a gather pass."""
    Ss, Se, _, Al = scan
    c = _comp(p, bw, tbl)
    counts = np.zeros((4, 257), np.int64)
    gather = tables is None
    co, si = ((np.zeros(1024, np.uint32), np.zeros(1024, np.uint8))
              if gather else tables)
    out = np.zeros(p.shape[0] * bw * 192 + 65536, np.uint8)
    args = [ctypes.byref(c), Ss, Se, Al, ri, co.ctypes.data_as(native.u32p),
            si.ctypes.data_as(native.u8p), out.ctypes.data_as(native.u8p),
            out.size, counts.ctypes.data_as(native.i64p), int(gather)]
    w = np.zeros(2, np.int64) if walked else None
    if not fn.__name__.endswith("_plain"):
        args.append(None if w is None else w.ctypes.data_as(native.i64p))
    n = fn(*args)
    return n, counts, (None if gather else bytes(out[:max(n, 0)])), w


def _tables(counts, tbl=1):
    co = np.zeros(1024, np.uint32)
    si = np.zeros(1024, np.uint8)
    c, s = derive_codes(gen_optimal_table(counts[tbl].copy()))
    co[tbl * 256:(tbl + 1) * 256] = c
    si[tbl * 256:(tbl + 1) * 256] = s
    return co, si


def _same(new_lib, p, bw, scan, ri):
    """The new coder of new_lib against the plain twin of the port's
    library, gather then emission -> the gather's return value."""
    kind = "refine" if scan[2] else "first"
    plain = getattr(native.lib(), _PLAIN[kind])
    new = getattr(new_lib, _NEW[kind])
    what = "scan %s restart %d" % (scan, ri)
    a = _call(plain, p, bw, scan, ri)
    b = _call(new, p, bw, scan, ri)
    assert b[0] == a[0], what
    assert (b[1] == a[1]).all(), what
    tables = _tables(a[1])
    a = _call(plain, p, bw, scan, ri, tables)
    b = _call(new, p, bw, scan, ri, tables)
    assert b[0] == a[0] and b[0] > 0, what
    assert b[2] == a[2], what
    return a[0]


@pytest.mark.parametrize("ri", RESTARTS)
@pytest.mark.parametrize("kind", KINDS)
def test_walk_equals_the_plain_twins(kind, ri):
    p, bw = _plane(kind, seed=ri)
    for scan in SCANS:
        _same(native.lib(), p, bw, scan, ri)


@pytest.mark.parametrize("bw,pad", [(1, 2), (7, 1), (31, 6)])
def test_odd_strides(bw, pad):
    p, bw = _plane("photo", seed=bw, bh=5, bw=bw, pad=pad)
    for scan in SCANS:
        for ri in RESTARTS:
            _same(native.lib(), p, bw, scan, ri)


@pytest.mark.parametrize("scan", [(1, 63, 0, 0), (9, 63, 0, 2),
                                  (1, 63, 1, 0)])
def test_eob_run_flush_at_0x7fff(scan):
    """An empty band over 40,000 blocks, broken twice by a coded block:
    runs of 32,767 and more, flushed by the coder's own limit."""
    p = np.zeros((125, 320, 64), np.int16)
    flat = p.reshape(-1, 64)
    flat[33000, 1:9] = [5, -3, 2, 1, 1, 0, -1, 7]    # 9-63 stays empty
    flat[39990, 20] = -1
    _same(native.lib(), p, 320, scan, 0)


@pytest.mark.parametrize("ri", [0, 7])
def test_refine_correction_bits_past_937(ri):
    """Blocks whose whole band is already nonzero (|c| >> Al of 2 or 3)
    buffer 63 correction bits each and end in the EOB run, so BE passes
    937 every 15 blocks; a few newly nonzero coefficients interleave."""
    rng = np.random.default_rng(5)
    p = (rng.integers(2, 4, (6, 17, 64)) * rng.choice([-1, 1], (6, 17, 64))
         ).astype(np.int16)
    p.reshape(-1, 64)[::23, 40] = 1
    _same(native.lib(), p, 17, (1, 63, 1, 0), ri)
    _same(native.lib(), p << 1, 17, (1, 63, 2, 1), ri)


@pytest.mark.parametrize("kind", ["zero", "photo", "dense"])
def test_walked_counters(kind):
    p, bw = _plane(kind, seed=11)
    core = p[:, :bw]
    lib = native.lib()
    for scan in SCANS:
        Ss, Se, Ah, Al = scan
        empty = int(((np.abs(core[..., Ss:Se + 1].astype(np.int32)) >> Al)
                     == 0).all(-1).sum())
        fn = lib.mj_encode_ac_refine if Ah else lib.mj_encode_ac_first
        n, counts, _, w = _call(fn, p, bw, scan, 7, walked=True)
        assert w.tolist() == [core.shape[0] * bw, empty], scan
        # an emission pass counts the same blocks
        _, _, _, w = _call(fn, p, bw, scan, 7, _tables(counts), walked=True)
        assert w.tolist() == [core.shape[0] * bw, empty], scan


@pytest.fixture(scope="module")
def portable(tmp_path_factory):
    """entropy.cpp alone, compiled with the portable flags."""
    mp = pytest.MonkeyPatch()
    mp.setenv("MJ_NATIVE_PORTABLE", "1")
    flags = build.compile_flags()
    mp.undo()
    assert not any(f.startswith("-march") for f in flags)
    out = str(tmp_path_factory.mktemp("portable") / "libentropy.so")
    src = os.path.join(build.SRC_DIR, "entropy.cpp")
    res = subprocess.run(["g++", *flags, src, "-o", out],
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    so = ctypes.CDLL(out)
    cpp = ctypes.POINTER(native.CompPlane)
    for name in _NEW.values():
        fn = getattr(so, name)
        fn.restype = ctypes.c_long
        fn.argtypes = [cpp] + [ctypes.c_int] * 4 + [
            native.u32p, native.u8p, native.u8p, ctypes.c_long, native.i64p,
            ctypes.c_int, native.i64p]
    return so


@pytest.mark.parametrize("kind", ["photo", "dense", "max32767"])
def test_portable_build_equals_the_plain_twins(portable, kind):
    p, bw = _plane(kind, seed=3)
    for scan in SCANS:
        for ri in (0, 7):
            _same(portable, p, bw, scan, ri)
