"""The harness's arithmetic: the window's rate, the trace's intervals,
the kernels' bytes bounds, the JAX check and the seeded images."""
import numpy as np
import pytest
import torch

from portbench.core import geometry, images, modcheck, trace, window


def test_rate_counts_whole_calls_over_the_whole_window():
    t = iter([10.0, 10.5, 10.5, 11.5, 11.5, 12.25, 99.0])
    calls = window.run(lambda k: (2.0, 3), 2.0, clock=lambda: next(t))
    # the third call ends past the 2 s deadline and is the last one
    assert [c.start for c in calls] == [10.0, 10.5, 11.5]
    assert window.span_s(calls) == pytest.approx(2.25)
    assert window.rate_mps(calls) == pytest.approx(6.0 / 2.25)


def test_window_stops_after_the_call_in_flight():
    t = iter([0.0, 5.0, 99.0])
    calls = window.run(lambda k: (1.0, 1), 1.0, clock=lambda: next(t))
    assert len(calls) == 1 and window.rate_mps(calls) == pytest.approx(0.2)


def test_merged_union_and_idle_gaps():
    spans = [(5, 8), (0, 2), (1, 3), (7, 9), (12, 13)]
    m = trace.merged(spans)
    assert m == [(0, 3), (5, 9), (12, 13)]
    assert trace.clip(m, 2, 12) == [(2, 3), (5, 9)]
    assert trace.idle(trace.clip(m, 2, 12), 2, 12) == [(3, 5), (9, 12)]


def _ev(name, s, e, dev):
    return trace.Ev(name, s, e, dev)


def test_read_busy_window_kernels_and_labels():
    evs = [_ev(trace.CALL_SPAN, 0, 100, False),
           _ev(trace.CALL_SPAN, 100, 200, False),
           _ev("host_prep", 10, 60, False),
           _ev("k1", 0, 10, True), _ev("k1", 5, 20, True),
           _ev("k2", 150, 160, True), _ev("k3", 195, 230, True)]
    r = trace.read(evs)
    assert r.window_s == pytest.approx(200e-9)
    # busy: [0, 20) and [150, 160) and [195, 200) inside the window
    assert r.busy_s == pytest.approx(35e-9)
    assert r.kernels["k1"] == [2, pytest.approx(25e-9)]
    assert r.device_ops[0][0] == "k3"
    # the longest gap, [20, 150), is labelled by the call span (its
    # midpoint 85 is past host_prep); the next, [160, 195), likewise
    assert r.idle_gaps[0] == [trace.CALL_SPAN, pytest.approx(130e-9)]
    r2 = trace.read([_ev(trace.CALL_SPAN, 0, 100, False),
                     _ev("host_prep", 10, 90, False),
                     _ev("k", 0, 5, True)])
    assert r2.idle_gaps[0][0] == "host_prep"
    assert trace.read([_ev("k", 0, 5, True)]) is None


def test_kernel_seconds_by_name():
    ks = {"void trellis_ac_kernel<10, 1023>(int)": [3, 0.5],
          "void trellis_ac_kernel<14, 16383>(int)": [1, 0.25],
          "other": [1, 1.0]}
    assert trace.kernel_seconds(ks, "trellis_ac_kernel", ("16383",)) == 0.5


def test_bytes_bounds_from_geometry():
    s420 = [(2, 2), (1, 1), (1, 1)]
    assert geometry.comp_blocks(768, 512, s420) == [6144, 1536, 1536]
    assert geometry.comp_blocks(4032, 3024, s420) == [190512, 47628, 47628]
    # odd sizes round each component up to whole blocks
    assert geometry.comp_blocks(1021, 683, s420) == [128 * 86, 64 * 43,
                                                     64 * 43]
    # a group of eight Kodak-size images: 33.4 MB for p1_blocks (PERF.md's
    # 0.00998 ms at 3.35 TB/s) and 40.6 MB for the AC trellis (0.0121 ms)
    p1 = 8 * geometry.p1_blocks_bytes(768, 512, s420)
    tr = 8 * geometry.trellis_ac_bytes(768, 512, s420)
    assert p1 == 8 * (9216 * 453 + 3 * 1024)
    assert tr == 8 * (9216 * 548 + 3 * 8192)
    assert p1 / geometry.H100_BYTES_PER_S * 1e3 == pytest.approx(0.00998,
                                                                 abs=1e-5)
    assert tr / geometry.H100_BYTES_PER_S * 1e3 == pytest.approx(0.0121,
                                                                 abs=1e-4)
    assert geometry.roofline_pct(3.35e12, 2.0) == pytest.approx(50.0)
    assert geometry.roofline_pct(1.0, 0.0) is None


def test_forbidden_modules_by_whole_top_level_name():
    names = ["mozjpeg_tpu_torch", "mozjpeg_tpu_torch.codec", "numpy",
             "jaxtyping", "flaxen.x", "jax_like"]
    assert modcheck.forbidden(names) == []
    assert modcheck.forbidden(names + ["jax.numpy", "mozjpeg_tpu.codec"]) \
        == ["jax", "mozjpeg_tpu"]
    assert modcheck.forbidden(["jaxlib", "flax.linen"]) == ["flax", "jaxlib"]


def test_images_are_seeded_and_shaped():
    shapes = [(48, 64), (64, 48)]
    a = images.suites(shapes, 2, 2**31 + 99, "cpu")
    b = images.suites(shapes, 2, 2**31 + 99, "cpu")
    c = images.suites(shapes, 2, 2**31 + 98, "cpu")
    assert [im.shape for im in a[0]] == [(48, 64, 3), (64, 48, 3)]
    assert all(im.dtype == np.uint8 for s in a for im in s)
    assert all(np.array_equal(x, y) for s, t in zip(a, b)
               for x, y in zip(s, t))
    assert not np.array_equal(a[0][0], c[0][0])
    # suites of one pool differ, and each image holds the clipped highlight
    assert not np.array_equal(a[0][0], a[1][0])
    assert all((im == 255).all(-1).sum() > 0 for s in a for im in s)


@pytest.mark.cuda
def test_images_on_the_card_are_seeded():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a = images.suites([(3024, 4032)], 1, 5, "cuda")[0][0]
    b = images.suites([(3024, 4032)], 1, 5, "cuda")[0][0]
    assert a.shape == (3024, 4032, 3) and np.array_equal(a, b)


