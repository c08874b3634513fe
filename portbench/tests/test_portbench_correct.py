"""The check that decides `correct`: the reference agrees with the
program's CPU path exactly, and the control and each fault a cell can
have come out not correct."""
import contextlib

import numpy as np
import pytest
import torch

import mozjpeg_tpu_torch as mjt
from mozjpeg_tpu_torch.codec import trellis as port_trellis
from portbench.core import harness, images
from portbench.reference import encode_ref, jpeg_read, scan_ref
from portbench_util import tiny

CLEAN = {"bad_stream": 0, "bad_coef": 0, "bad_scans": 0, "bad_trellis": 0}


def _check(data, img, **kw):
    r = encode_ref.check_stream(data, img, 75, True, 2, 2, True, seed=11,
                                **kw)
    return {k: r[k] for k in CLEAN}


@pytest.fixture(scope="module")
def streams():
    imgs = images.suites([(48, 64), (96, 80), (64, 48)], 1, 2**32 + 5,
                         "cpu")[0]
    cfg = mjt.EncoderConfig(quality=75)
    return imgs, mjt.encode_many(imgs, cfg, device="cpu")


def test_reference_holds_the_encoder(streams):
    imgs, jpegs = streams
    for img, data in zip(imgs, jpegs):
        assert _check(data, img) == CLEAN
        assert encode_ref.header_ok(data, img.shape[1], img.shape[0], 75,
                                    True, 2, 2)


def _adversarial(kind):
    rng = np.random.default_rng(7)
    if kind == "flat":          # no AC at all: EOB runs over the frame
        img = np.full((256, 256, 3), 120, np.uint8)
    elif kind == "noise":       # refinement scans, long correction runs
        img = rng.integers(0, 256, (128, 192, 3)).astype(np.uint8)
    elif kind == "half":        # a frequency split with refinement
        img = np.full((256, 256, 3), 90, np.uint8)
        img[:, :128] = rng.integers(0, 256, (256, 128, 3))
    else:                       # saturated: deringing and clamps
        img = np.zeros((32, 48, 3), np.uint8)
        img[:, ::3] = 255
        img[5:20, 10:40] = (255, 0, 255)
    return img


@pytest.mark.parametrize("kind", ["flat", "noise", "half", "saturated"])
def test_reference_holds_adversarial_streams(kind):
    img = _adversarial(kind)
    data = mjt.encode_many([img], mjt.EncoderConfig(quality=75),
                           device="cpu")[0]
    assert _check(data, img) == CLEAN


def test_wrong_frame_is_a_bad_stream(streams):
    imgs, jpegs = streams
    r = encode_ref.check_stream(jpegs[0], imgs[0], 90, True, 2, 2, True)
    assert r["bad_stream"] == 1
    assert encode_ref.check_stream(jpegs[0][:100], imgs[0], 75, True, 2, 2,
                                   True)["bad_stream"] == 1
    assert not encode_ref.header_ok(jpegs[0][:100], 64, 48, 75, True, 2, 2)


def test_the_default_script_is_not_a_search_script():
    """mozjpeg's 9-scan script without the search (jcparam.c) is not one
    the search writes, so an encoder that skips it fails every answer."""
    default = (((0, 1, 2), 0, 0, 0, 0), ((0,), 1, 8, 0, 2),
               ((1,), 1, 8, 0, 0), ((2,), 1, 8, 0, 0), ((0,), 9, 63, 0, 2),
               ((0,), 1, 63, 2, 1), ((0,), 1, 63, 1, 0),
               ((1,), 9, 63, 0, 0), ((2,), 9, 63, 0, 0))
    scripts = scan_ref.possible_scripts(3)
    assert len(scripts) > 100 and default not in scripts


def _suboptimal_tables(data: bytes) -> bytes:
    """The same coefficients, every scan coded with tables built from
    its symbol counts each raised by one: a valid stream, not optimal."""
    fr = jpeg_read.parse(data)
    coefs = jpeg_read.coefficients(fr)
    sf = scan_ref.Frame(list(coefs),
                        [jpeg_read.real_grid(fr, ci) for ci in range(3)],
                        [(c.h, c.v) for c in fr.comps],
                        -(-fr.width // 16), -(-fr.height // 16))
    gen = scan_ref.gen_optimal_table
    scan_ref.gen_optimal_table = lambda counts: gen(
        np.where(np.arange(256) < 176, counts + 1, counts))
    try:
        scans = [b for _, b in scan_ref.search(sf)]
    finally:
        scan_ref.gen_optimal_table = gen
    head = data[:data.index(fr.scans[0].raw)]
    return head + b"".join(scans) + b"\xff\xd9"


class Faulty:
    """The program with one fault planted under the timed path."""

    CONFIG = {"no_trellis": {"trellis_quant": False},
              "no_dc_trellis": {"trellis_quant_dc": False},
              "no_scan_search": {"optimize_scans": False},
              "std_trellis_tables": {"optimize_coding": False}}

    def __init__(self, fault):
        self.fault = fault
        self.prev = None
        self.DCTMethod = mjt.DCTMethod

    def EncoderConfig(self, **kw):
        return mjt.EncoderConfig(**dict(kw, **self.CONFIG.get(self.fault,
                                                              {})))

    @contextlib.contextmanager
    def _planted(self):
        if self.fault != "zero_ac":
            yield
            return
        run = port_trellis.trellis_all

        def zero_ac(*a, **kw):
            out = run(*a, **kw)
            return tuple(torch.where(
                torch.arange(64, device=q.device)[:, None] == 0, q,
                torch.zeros_like(q)) for q in out)
        port_trellis.trellis_all = zero_ac
        try:
            yield
        finally:
            port_trellis.trellis_all = run

    def encode_many(self, images_, config=None, device=None):
        with self._planted():
            outs = mjt.encode_many(images_, config, device=device)
        if self.fault == "stale":
            prev, self.prev = self.prev, outs
            return prev if prev is not None else outs
        if self.fault == "half":
            return outs[:len(outs) // 2]
        if self.fault == "altered":
            return [o[:len(o) * 2 // 3] + bytes([o[len(o) * 2 // 3] ^ 0x24])
                    + o[len(o) * 2 // 3 + 1:] for o in outs]
        if self.fault == "tables":
            return [_suboptimal_tables(outs[0])] + outs[1:]
        return outs


# which numbers each fault has to fail
FAULTS = {None: set(), "stale": {"bad_coefs"}, "half": {"bad_answers"},
          "altered": set(), "control": {"bad_coefs", "bad_trellis"},
          "no_trellis": {"bad_trellis"}, "no_dc_trellis": {"bad_trellis"},
          "zero_ac": {"bad_trellis"},
          "no_scan_search": {"bad_answers", "bad_scans"},
          "std_trellis_tables": {"bad_trellis"}, "tables": {"bad_scans"}}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_faults_come_out_not_correct(fault):
    out = harness.run_cell(tiny(), 2**31 + 17, 0.3, False, device="cpu",
                           control=fault == "control",
                           program=Faulty(fault))
    assert out["correct"] is (fault is None), out["checks"]
    failed = {k for k, v in out["checks"].items() if v["value"] > 0}
    assert FAULTS[fault] <= failed, out["checks"]
    assert list(out)[-1] == "checks"


def test_checks_in_worker_processes_agree():
    """The same run checked in two spawned processes and in this one."""
    outs = [harness.run_cell(tiny(check_workers=w), 2**31 + 19, 0.3, False,
                             device="cpu", program=Faulty("stale"))
            for w in (0, 2)]
    assert outs[0]["checks"] == outs[1]["checks"]
    assert outs[0]["checks"]["bad_coefs"]["value"] > 0


def _made_planes(kind, rng):
    """(width, height, zigzag planes over the padded grid) made to drive
    the scan coder's rare paths."""
    if kind == "long_runs":           # EOB runs past 0x7FFF blocks
        w, h = 1664, 1600
    else:
        w, h = 256, 192
    grid = [(h // 8, w // 8), (h // 16, w // 16), (h // 16, w // 16)]
    planes = []
    for bh, bw in grid:
        p = np.zeros((bh, bw, 64), np.int16)
        p[..., 0] = rng.integers(-300, 300, (bh, bw))
        if kind == "corrections":     # dense |AC| >= 2: forced flushes of
            mag = rng.integers(2, 8, (bh, bw, 63))   # the buffered bits
            keep = rng.random((bh, bw, 63)) < 0.8
            p[..., 1:] = np.where(keep, mag * rng.choice([-1, 1], mag.shape),
                                  0)
            p[::7, ::5, 1:] = np.where(rng.random(p[::7, ::5, 1:].shape)
                                       < 0.05, 1, p[::7, ::5, 1:])
        elif kind == "sparse":        # long zero runs, ZRLs at corrections
            mag = rng.integers(1, 40, (bh, bw, 63))
            keep = rng.random((bh, bw, 63)) < 0.06
            p[..., 1:] = np.where(keep, mag * rng.choice([-1, 1], mag.shape),
                                  0)
        planes.append(p)
    return w, h, planes


@pytest.mark.parametrize("kind", ["long_runs", "corrections", "sparse"])
def test_scan_reference_matches_the_native_search_on_made_coefficients(
        kind):
    """The port's native scan search over coefficient planes made to hit
    the rare paths (0x7FFF runs, correction bits past MAX_CORR_BITS, ZRLs
    at correction coefficients), against scan_ref on the same planes."""
    from mozjpeg_tpu_torch.codec import encoder, pipeline, scanopt
    w, h, planes = _made_planes(kind, np.random.default_rng(23))
    ctx = encoder.resolve_group(np.zeros((h, w, 3), np.uint8),
                                mjt.EncoderConfig(quality=75))
    geom = pipeline.geometry(w, h, [(2, 2), (1, 1), (1, 1)])
    data = scanopt.encode_optimize_scans_native(
        w, h, geom, planes, ctx.qtables, ctx.cfg, 3, (0, 1, 1))
    fr = jpeg_read.parse(data)
    coefs = jpeg_read.coefficients(fr)
    for got, want in zip(coefs, planes):
        assert np.array_equal(got, want)
    assert encode_ref.bad_scans(fr, coefs) == 0
    if kind != "sparse":
        fsf = scan_ref.Frame(list(coefs), [jpeg_read.real_grid(fr, ci)
                                           for ci in range(3)],
                             [(2, 2), (1, 1), (1, 1)], w // 16, h // 16)
        ems = ([scan_ref.ac_first(fsf.coefs[0].reshape(-1, 64), 1, 63, 0, 0)]
               if kind == "long_runs" else
               [scan_ref.ac_refine(fsf.coefs[0].reshape(-1, 64), 1, 63, 0, 0)])
        assert any(((e.key % scan_ref.BLK) == scan_ref.POST).any()
                   for e in ems)
