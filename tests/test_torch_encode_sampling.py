"""Byte equality of the port's encode_many with mozjpeg_tpu.encode_many
at the other subsamplings of the slice, on one aligned and one unaligned
shape (kept apart from test_torch_encode.py so the two files' JAX
compiles run on different test workers)."""
import pytest

from test_torch_encode import IMAGES, assert_byte_identical


@pytest.mark.parametrize("kw", [dict(quality=85, subsampling=(2, 1)),
                                dict(quality=92, subsampling=(1, 1))],
                         ids=["q85-422", "q92-444"])
def test_encode_many_byte_identical_subsampling(kw):
    assert_byte_identical(IMAGES[1:3], **kw)
