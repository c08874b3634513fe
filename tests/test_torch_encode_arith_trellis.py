"""The arithmetic trellis (mozjpeg's default with -arithmetic) through
the port's encode_many on the CPU, byte-identical to
mozjpeg_tpu.encode_many: through the host engine (YCbCr), and through
the port's per-image route, which runs the row trellis in PyTorch and
trains the coder on the host (MJ_HOST_ENGINE=0, and colorspace="rgb",
which no host route serves); and one case of arithmetic coding without
the trellis."""
import pytest

from mozjpeg_tpu_torch.codec import encoder as tenc
from test_torch_encode import _photo, assert_config_encodes

RGB = [_photo(48, 64, 41), _photo(29, 37, 42)]


@pytest.mark.parametrize("kw", [
    dict(),
    dict(restart_in_rows=1, use_scans_in_trellis=True),
], ids=["default", "rows1-bands"])
def test_arith_trellis_host_engine_matches_jax(kw):
    ctx = tenc.resolve_group(RGB[0], tenc.EncoderConfig(arithmetic=True,
                                                        **kw))
    assert not tenc.batchable(ctx)
    assert_config_encodes(RGB, quality=75, arithmetic=True, **kw)


@pytest.mark.parametrize("imgs,kw", [
    (RGB[1:], dict(restart_interval=3)),
    (RGB[:1], dict(colorspace="rgb", progressive=False)),
], ids=["unaligned-rst3", "rgb-seq"])
def test_arith_trellis_per_image_route_matches_jax(monkeypatch, imgs, kw):
    monkeypatch.setenv("MJ_HOST_ENGINE", "0")
    assert_config_encodes(imgs, quality=75, arithmetic=True, **kw)


def test_arith_without_trellis_sequential_restart_matches_jax():
    """Arithmetic without the trellis, sequential with restart_interval=2
    (the batched route; one of test_torch_encode_arith.py's family,
    run here to spread the JAX compiles over two test workers)."""
    assert_config_encodes(RGB[:1], quality=75, arithmetic=True,
                          trellis_quant=False, restart_interval=2,
                          progressive=False)
