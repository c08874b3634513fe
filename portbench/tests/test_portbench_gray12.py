"""The cell xray9mp-gray12.encode on the CPU (and, where there is one, on
the card): its seeded radiographs, its operation's checks with the
control and planted faults, its new metrics' readers on hand-made runs,
and what the registry makes of it."""
import subprocess
import sys
from collections import namedtuple
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import mozjpeg_tpu_torch as mjt
from portbench.core import harness, radiographs, registry, spans, trace
from portbench.core import geometry, geometry12, window
from portbench.reference import gray12_ref, jpeg_read, scan_ref
from test_portbench_correct import Faulty

CELL = "xray9mp-gray12.encode"
TINY = [{"width": 96, "height": 72, "count": 2},
        {"width": 64, "height": 80, "count": 1}]
NEW = ["enc.span.scan_gather_ms_per_mp", "enc.span.scan_emit_ms_per_mp",
       "trellis_ac14_roofline", "p1_blocks12_roofline"]
PER_LAYER = {"enc.prep_ms_per_mp", "enc.p1_ms_per_mp",
             "enc.trellis_ms_per_mp", "enc.download_ms_per_mp",
             "enc.host_entropy_ms_per_mp", "enc.device_idle",
             "enc.span.prep_ms_per_mp", "enc.span.upload_ms_per_mp",
             "enc.span.launch_ms_per_mp", "enc.span.download_ms_per_mp",
             "enc.span.entropy_wait_ms_per_mp",
             "enc.span.unattributed_ms_per_mp", "enc.span.entropy_threads",
             *NEW}


def tiny(**traffic) -> registry.Cell:
    """The cell over a suite of three small radiographs and a small pool,
    checked in this process."""
    cell = registry.load(CELL)
    t = dict(cell.traffic, pool_mp=0.001, warm_calls=1, check_images=3,
             check_workers=0, trellis_blocks=64, trellis_rows=2)
    t.update(traffic)
    return cell._replace(config=dict(cell.config, suite=TINY), traffic=t)


def test_registry_reports_the_cells_metrics():
    cell = registry.load(CELL)
    assert cell.chips == 1 and cell.traffic["op"] == "encode_gray12"
    assert cell.config["suite"] == [{"width": 3072, "height": 3072,
                                     "count": 16}]
    assert cell.config["encoder"] == {"quality": 90, "precision": 12,
                                      "progressive": False}
    assert [m.name for m in cell.end_to_end] == ["encode_mps", "setup_s"]
    assert {m.name for m in cell.per_layer} == PER_LAYER
    assert len(cell.per_layer) == len(PER_LAYER)


def test_radiographs_are_seeded():
    shapes = [(72, 96), (80, 64)]
    a = radiographs.suites(shapes, 2, 2**33 + 1, "cpu")
    b = radiographs.suites(shapes, 2, 2**33 + 1, "cpu")
    c = radiographs.suites(shapes, 2, 2**33 + 2, "cpu")
    for sa, sb in zip(a, b):
        for x, y in zip(sa, sb):
            assert np.array_equal(x, y)
    assert any(not np.array_equal(x, y) for x, y in zip(a[0], c[0]))
    assert not np.array_equal(a[0][0], a[1][0])
    for img, (h, w) in zip(a[0], shapes):
        assert img.shape == (h, w) and img.dtype == np.uint16
        assert img.max() == 4095 and img.min() < 400
    # the same work from seed to seed: the saturated share stays close
    big = [radiographs.suites([(384, 384)], 1, s, "cpu")[0][0]
           for s in (7, 2**40 + 3, 123456789)]
    share = [(im == 4095).mean() for im in big]
    assert max(share) - min(share) < 0.06, share


def _suboptimal_scan(data: bytes) -> bytes:
    """The same coefficients coded with tables from counts raised by one:
    a valid stream, not optimal."""
    fr = jpeg_read.parse(data)
    coefs = jpeg_read._Decoder(fr).run()[0]
    gen = scan_ref.gen_optimal_table
    scan_ref.gen_optimal_table = lambda counts: gen(
        np.where(np.arange(256) < 176, counts + 1, counts))
    try:
        scan = gray12_ref.scan_bytes(coefs)
    finally:
        scan_ref.gen_optimal_table = gen
    return data[:data.index(fr.scans[0].raw)] + scan + b"\xff\xd9"


class Faulty12(Faulty):
    CONFIG = dict(Faulty.CONFIG, progressive={"progressive": True},
                  no_dering={"overshoot_deringing": False})

    def encode_many(self, images_, config=None, device=None):
        if self.fault != "tables":
            return super().encode_many(images_, config, device)
        outs = mjt.encode_many(images_, config, device=device)
        return [_suboptimal_scan(outs[0])] + outs[1:]


FAULTS = {None: set(), "control": {"bad_coefs"}, "stale": {"bad_coefs"},
          "half": {"bad_answers"}, "no_trellis": {"bad_trellis"},
          "no_dc_trellis": {"bad_trellis"}, "zero_ac": {"bad_trellis"},
          "progressive": {"bad_answers"}, "no_dering": {"bad_coefs"},
          "tables": {"bad_scan"}, "altered": set()}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_faults_come_out_not_correct(fault):
    out = harness.run_cell(tiny(), 2**31 + 23, 0.3, False, device="cpu",
                           control=fault == "control",
                           program=Faulty12(fault))
    assert out["correct"] is (fault is None), out["checks"]
    failed = {k for k, v in out["checks"].items() if v["value"] > 0}
    assert FAULTS[fault] <= failed, out["checks"]


def test_traced_cpu_run_reports_the_scan_counters():
    out = harness.run_cell(tiny(), 2**31 + 29, 0.3, True, device="cpu")
    assert out["correct"] is True, out["checks"]
    m = out["metrics"]
    for name in ("enc.span.scan_gather_ms_per_mp",
                 "enc.span.scan_emit_ms_per_mp"):
        assert m[name]["value"] > 0
    # no kernel runs on the CPU: the rooflines read nothing
    assert "trellis_ac14_roofline" not in m
    assert "p1_blocks12_roofline" not in m


S = namedtuple("S", "name start_ns end_ns id parent call thread attrs")


def test_span_readers_on_made_spans(monkeypatch):
    """Two images of one 2 MP call: 3000 + 5000 ns gathering and
    4000 + 6000 ns emitting; a call before the window is left out."""
    def call(t0, i, scale):
        return [S("enc.call", t0, t0 + 20000, i, 0, i, 1,
                  {"pixels": 2_000_000}),
                S("enc.entropy_image", t0 + 100, t0 + 9000, i + 1, i, i, 2,
                  {"scan_gather_ns": 3000 * scale,
                   "scan_emit_ns": 4000 * scale}),
                S("enc.entropy_image", t0 + 200, t0 + 9500, i + 2, i, i, 3,
                  {"scan_gather_ns": 5000 * scale,
                   "scan_emit_ns": 6000 * scale})]
    got = call(10_000, 50, 9) + call(1_000_000, 1, 1)
    monkeypatch.setattr(spans, "program_spans", lambda: got)
    run = SimpleNamespace(calls=[window.Call(1_000_000 / 1e9,
                                             1_020_000 / 1e9, 2.0, 2)])
    want = {"enc.span.scan_gather_ms_per_mp": 8000e-6 / 2,
            "enc.span.scan_emit_ms_per_mp": 10000e-6 / 2}
    for name, v in want.items():
        assert registry._reader(registry.PKG_DIR, name)(run) == \
            pytest.approx(v)
    monkeypatch.setattr(spans, "program_spans", lambda: [
        s._replace(attrs={}) for s in got])
    for name in want:
        assert registry._reader(registry.PKG_DIR, name)(run) is None


def test_roofline_readers_on_a_made_trace():
    b_p1 = geometry12.p1_blocks12_bytes(3072, 3072, [(1, 1)])
    b_tr = geometry12.trellis_ac14_bytes(3072, 3072, [(1, 1)])
    n = 384 * 384
    assert b_p1 == n * (64 * 4 + 64 * 2 + 64 * 4 + 5) + 1024
    assert b_tr == n * (64 * 4 + 4 + 64 * 4 + 32) + 128 * 16 * 4
    kernels = {
        "void (anonymous namespace)::p1_blocks_kernel<int>(int const*)":
            [2, 2e-3],
        "void (anonymous namespace)::p1_blocks_kernel<unsigned char>()":
            [1, 5.0],
        "void trellis_ac_kernel<14, 16383>(int const*)": [2, 4e-2],
        "void trellis_ac_kernel<10, 1023>(int const*)": [1, 5.0]}
    reading = trace.Reading(1.0, 2.0, kernels, [], [])
    run = SimpleNamespace(trace=reading, kernel_bytes={
        "p1_blocks12": 2 * b_p1, "trellis_ac14": 2 * b_tr})
    read = registry._reader(registry.PKG_DIR, "p1_blocks12_roofline")
    assert read(run) == pytest.approx(
        geometry.roofline_pct(2 * b_p1, 2e-3))
    read = registry._reader(registry.PKG_DIR, "trellis_ac14_roofline")
    assert read(run) == pytest.approx(
        geometry.roofline_pct(2 * b_tr, 4e-2))
    for name in ("p1_blocks12_roofline", "trellis_ac14_roofline"):
        read = registry._reader(registry.PKG_DIR, name)
        assert read(SimpleNamespace(trace=None, kernel_bytes={})) is None
        assert read(SimpleNamespace(trace=reading, kernel_bytes={})) is None
    # the 8-bit readers read nothing of this cell's kernel bytes
    for name in ("p1_blocks_roofline", "trellis_ac_roofline"):
        assert registry._reader(registry.PKG_DIR, name)(run) is None


def test_the_reference_loads_neither_jax_nor_the_port():
    code = ("import sys; import portbench.reference.gray12_ref, "
            "portbench.core.radiographs, portbench.core.geometry12; "
            "from portbench.core import modcheck; "
            "print(modcheck.forbidden_loaded(), "
            "'mozjpeg_tpu_torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=registry.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["[]", "False"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_traced_run_on_the_card():
    _card()
    out = harness.run_cell(tiny(check_workers=2), 2**31 + 31, 1.0, True,
                           device="cuda")
    assert out["correct"] is True, out["checks"]
    for name in NEW:
        assert out["metrics"][name]["value"] > 0
    for name in ("trellis_ac14_roofline", "p1_blocks12_roofline"):
        assert out["metrics"][name]["value"] <= 100


@pytest.mark.cuda
def test_control_on_the_card():
    _card()
    out = harness.run_cell(tiny(), 2**31 + 37, 0.5, False, device="cuda",
                           control=True)
    assert out["correct"] is False
    assert out["checks"]["bad_coefs"]["value"] > 0
