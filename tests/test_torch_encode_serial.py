"""The port's serial encode() on the CPU is byte-identical to
mozjpeg_tpu.encode: through the host engine where both route there, and
with MJ_HOST_ENGINE=0 through the port's group route (the JAX package's
batched route); on the GPU route it raises without CUDA; and progress
and trace reporting report what the JAX package reports
(test_torch_report.py holds the routes)."""
import numpy as np
import pytest
import torch

import mozjpeg_tpu as mj
import mozjpeg_tpu_torch as mjt
from test_torch_encode import _photo

A = _photo(48, 64, 21)
CASES = [
    (A, dict(quality=75)),
    (A[..., 0].copy(), dict(quality=75)),
    (np.concatenate([A, _photo(48, 64, 22)[..., :1]], -1),
     dict(quality=75)),
    (A, dict(quality=75, restart_in_rows=2)),
    (A, dict(quality=95, subsampling=(1, 1))),
    (_photo(29, 37, 23), dict(quality=75)),
]
IDS = ["default", "gray-2d", "cmyk", "restart-rows2", "q95-1x1",
       "unaligned-37x29"]


@pytest.mark.parametrize("img,kw", CASES, ids=IDS)
def test_encode_cpu_matches_jax(img, kw):
    got = mjt.encode(img, mjt.EncoderConfig(**kw), device="cpu")
    assert got == mj.encode(img, mj.EncoderConfig(**kw))
    assert got[:2] == b"\xff\xd8" and got[-2:] == b"\xff\xd9"


@pytest.mark.parametrize("img,kw", CASES[:3], ids=IDS[:3])
def test_encode_cpu_without_host_engine_matches_jax(monkeypatch, img, kw):
    """Both packages with MJ_HOST_ENGINE=0: the port's group route against
    the JAX package's batched route. The other cases are in
    test_torch_host_engine.py."""
    monkeypatch.setenv("MJ_HOST_ENGINE", "0")
    assert mjt.encode(img, device="cpu", **kw) == mj.encode(img, **kw)


def test_encode_overrides_equal_config():
    assert (mjt.encode(A, device="cpu", quality=60, trellis_eob_opt=True)
            == mjt.encode(A, mjt.EncoderConfig(quality=60,
                                               trellis_eob_opt=True),
                          device="cpu"))


def test_encode_gpu_route_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mjt.encode(A, device=device)


@pytest.mark.parametrize("arg", ["progress", "trace"])
def test_reporting_is_refused(arg):
    """Reporting is accepted: each callback alone gets the JAX package's
    calls, from encode() and from encode_many."""
    for name, x in (("encode", A), ("encode_many", [A])):
        calls = []
        cb = {"progress": lambda *a: calls.append(a),
              "trace": calls.append}[arg]
        got = getattr(mjt, name)(x, device="cpu", **{arg: cb})
        want_calls = []
        wcb = {"progress": lambda *a: want_calls.append(a),
               "trace": want_calls.append}[arg]
        assert got == getattr(mj, name)(x, **{arg: wcb})
        assert calls == want_calls and calls
