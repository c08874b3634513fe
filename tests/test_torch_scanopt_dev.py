"""The port's device scan search (mozjpeg_tpu_torch/codec/scanopt_dev.py)
against the JAX package's (mozjpeg_tpu/codec/scanopt_dev.py) and the
port's host search, byte for byte; the engines' switches
(device_scanopt, deployment, MJ_DEVICE_SCANOPT, MJ_DEPLOYMENT) and
their host routes.

The JAX search compiles once for the shared geometry (two 64x48 images,
4:2:0), in a module fixture (about 50 s here); every other JAX call of
this file reuses that program. Shapes the JAX search would compile again
for (48x32 at 4:4:4, grayscale, other DC scan modes) are held to the
port's host search only.
"""
import numpy as np
import pytest
import torch

import mozjpeg_tpu as mj
import mozjpeg_tpu_torch as mjt
from mozjpeg_tpu.codec import pipeline as jpipe
from mozjpeg_tpu.codec import scanopt_dev as jsd
from mozjpeg_tpu_torch.codec import encoder as E
from mozjpeg_tpu_torch.codec import scanopt_dev as sd
from mozjpeg_tpu_torch.codec.config import EncoderConfig
from mozjpeg_tpu_torch.codec.pipeline import geometry
from mozjpeg_tpu_torch.utils import attachment


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


def _photo(h, w, seed):
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([127 + 100 * np.sin(xx / 6 + seed),
                    127 + 90 * np.cos(yy / 5 + seed),
                    255.0 * (xx + yy) / (w + h)], -1)
    img[r.integers(0, h // 2):, r.integers(0, w // 2):] = r.uniform(0, 255, 3)
    return np.clip(img + r.normal(0, 12, img.shape), 0, 255).astype(np.uint8)


PHOTOS = [_photo(48, 64, 1), _photo(48, 64, 2)]
# a flat image ends every block in zeros (one EOB run over the frame)
# and a gradient's AC sits in the first positions
FLAT_GRAD = [np.full((48, 64, 3), 118, np.uint8),
             np.tile(np.linspace(0, 255, 64).astype(np.uint8)[None, :, None],
                     (48, 1, 3))]


@pytest.fixture(scope="module")
def jax_bytes():
    cfg = mj.EncoderConfig(device_scanopt=True)
    return {"photos": mj.encode_many(PHOTOS, cfg),
            "flat_grad": mj.encode_many(FLAT_GRAD, cfg),
            "local": mj.encode_many(PHOTOS,
                                    mj.EncoderConfig(deployment="local"))}


@pytest.fixture
def searched(monkeypatch):
    """Counts the port's device searches."""
    calls = []
    real = sd.encode_batch_scans

    def spy(*a, **k):
        calls.append(a[7])              # b, the group's images
        return real(*a, **k)

    monkeypatch.setattr(sd, "encode_batch_scans", spy)
    E.reset_host_routes()
    return calls


def test_bytes_match_jax_and_host_search(jax_bytes, searched):
    ours = mjt.encode_many(PHOTOS, EncoderConfig(device_scanopt=True),
                           device="cpu")
    assert searched == [2]
    assert ours == jax_bytes["photos"]
    assert ours == mjt.encode_many(PHOTOS, EncoderConfig(), device="cpu")
    assert E.engine_host_routes == {"emit": 0, "search": 0}


def test_flat_and_gradient(jax_bytes, searched):
    ours = mjt.encode_many(FLAT_GRAD, EncoderConfig(device_scanopt=True),
                           device="cpu")
    assert searched == [2]
    assert ours == jax_bytes["flat_grad"]
    assert ours == mjt.encode_many(FLAT_GRAD, EncoderConfig(), device="cpu")


def test_sizes_pass_matches_jax(jax_bytes):
    """On the same seeded coefficients, the port's sizes pass gives the
    JAX program's sizes, bit counts and tables (bits, values, ok)."""
    b = 2
    mx, my, comps = geometry(64, 48, [(2, 2), (1, 1), (1, 1)])
    rng = np.random.default_rng(5)
    finals = []
    for g in comps:
        n = b * g.bh * g.bw
        q = np.zeros((64, n), np.int16)
        q[0] = np.cumsum(rng.integers(-30, 31, n))
        nz = rng.random((63, n)) < np.linspace(0.6, 0.01, 63)[:, None]
        q[1:] = np.where(nz, rng.integers(-40, 41, (63, n)), 0)
        q[1:, ::7] = 0
        finals.append(q)
    cand = sd.get_candidates(3, 0)
    _, sc = sd.sizes_pass(cand, [torch.as_tensor(q) for q in finals],
                          (mx, my, comps), b)
    jgeom = jpipe.geometry(64, 48, [(2, 2), (1, 1), (1, 1)])
    prog = jsd._sizes_program(3, 0, tuple(jgeom[2]), b, jgeom[0], jgeom[1])
    jsc = jsd._Sidecar(jsd.get_candidates(3, 0), np.asarray(prog(
        tuple(finals))), b)
    for ci in range(3):
        for li in range(cand.n_first[ci]):
            np.testing.assert_array_equal(sc.sizes[("first", ci, li)],
                                          jsc.fsizes[ci][:, li])
            np.testing.assert_array_equal(sc.bits[("first", ci, li)],
                                          jsc.fbits[ci][:, li])
        for li in range(cand.n_ref[ci]):
            np.testing.assert_array_equal(sc.sizes[("ref", ci, li)],
                                          jsc.rsizes[ci][:, li])
            np.testing.assert_array_equal(sc.bits[("ref", ci, li)],
                                          jsc.rbits[ci][:, li])
    for pos in range(len(cand.dc_scans)):
        np.testing.assert_array_equal(sc.sizes[("dc", pos)],
                                      jsc.dcsizes[pos])
        np.testing.assert_array_equal(sc.bits[("dc", pos)], jsc.dcbits[pos])
    np.testing.assert_array_equal(sc.tbits, jsc.tbits)
    np.testing.assert_array_equal(sc.tvals, jsc.tvals)
    np.testing.assert_array_equal(sc.tok, jsc.tok)


def test_deployment_local_and_switches(jax_bytes, searched, monkeypatch):
    """deployment="local" turns both engines on, as in the JAX package;
    MJ_DEPLOYMENT=local and MJ_DEVICE_SCANOPT=1 do too, and "0" or
    deployment="remote" keep the host search."""
    host = mjt.encode_many(PHOTOS, EncoderConfig(), device="cpu")
    local = mjt.encode_many(PHOTOS, EncoderConfig(deployment="local"),
                            device="cpu")
    assert local == jax_bytes["local"] == host
    assert searched == [2]
    monkeypatch.setenv("MJ_DEPLOYMENT", "local")
    assert mjt.encode_many(PHOTOS, device="cpu") == host
    assert mjt.encode_many(PHOTOS, EncoderConfig(deployment="remote"),
                           device="cpu") == host
    assert searched == [2, 2]
    monkeypatch.setenv("MJ_DEVICE_SCANOPT", "0")
    assert mjt.encode_many(PHOTOS, device="cpu") == host
    assert searched == [2, 2]
    monkeypatch.delenv("MJ_DEPLOYMENT")
    monkeypatch.setenv("MJ_DEVICE_SCANOPT", "1")
    assert mjt.encode_many(PHOTOS, device="cpu") == host
    assert searched == [2, 2, 2]


@pytest.mark.parametrize("deployment", ["auto", "local", "remote"])
@pytest.mark.parametrize("flag", [None, True, False])
def test_switches_resolve_as_jax(deployment, flag):
    """Without the environment, each switch resolves as the JAX
    package's does on its CPU backend ("auto" is off on both)."""
    for name in ("device_entropy", "device_scanopt"):
        kw = {name: flag, "deployment": deployment}
        ours = getattr(EncoderConfig(**kw).resolved(), name)
        assert ours == getattr(mj.EncoderConfig(**kw).resolved(), name)


def test_sync_latency_probe():
    assert 0 < attachment.sync_latency_ms("cpu") < float("inf")
    if not torch.cuda.is_available():
        assert attachment.sync_latency_ms("cuda") == float("inf")


@pytest.mark.parametrize("imgs,kw", [
    ([_photo(32, 48, 3), _photo(32, 48, 4)], {"quality": 92}),
    (PHOTOS, {"dc_scan_opt_mode": 1}),
    (PHOTOS, {"dc_scan_opt_mode": 2}),
    ([p[..., 1] for p in PHOTOS], {}),
    (PHOTOS, {"icc": bytes(range(256)) * 3}),
])
def test_other_layouts_match_host_search(imgs, kw, searched):
    ours = mjt.encode_many(imgs, EncoderConfig(device_scanopt=True, **kw),
                           device="cpu")
    assert searched == [len(imgs)]
    assert ours == mjt.encode_many(imgs, EncoderConfig(**kw), device="cpu")


@pytest.mark.parametrize("imgs,kw", [
    ([_photo(29, 37, 6)], {}),                    # iMCU dummy blocks
    (PHOTOS, {"restart_interval": 2}),
    (PHOTOS, {"arithmetic": True}),
    (PHOTOS, {"optimize_scans": False}),
])
def test_unsupported_takes_host_search(imgs, kw, searched):
    ours = mjt.encode_many(imgs, EncoderConfig(device_scanopt=True, **kw),
                           device="cpu")
    assert searched == []
    assert ours == mjt.encode_many(imgs, EncoderConfig(**kw), device="cpu")


def test_unbuildable_table_falls_back_to_host_search(searched, monkeypatch):
    """A candidate table flagged not ok sends the group to the host
    search (the JAX package's _FallbackNeeded), counted."""
    real = sd.tablegen.gen_optimal_tables

    def not_ok(freqs, sizes=False):
        out = real(freqs, sizes)
        if sizes:                       # the trellis's rate tables
            return out
        return out[0], out[1], torch.zeros_like(out[2])

    monkeypatch.setattr(sd.tablegen, "gen_optimal_tables", not_ok)
    ours = mjt.encode_many(PHOTOS, EncoderConfig(device_scanopt=True),
                           device="cpu")
    assert searched == [2]
    assert E.engine_host_routes["search"] == 1
    assert ours == mjt.encode_many(PHOTOS, EncoderConfig(), device="cpu")
