"""PyTorch + CUDA port of the mozjpeg_tpu codec.

Byte-identical to mozjpeg_tpu for the encode configurations it carries
(see codec/encoder.py) and pixel-identical for the streams it decodes (see
codec/decoder.py); it imports neither jax nor mozjpeg_tpu. The AC trellis
runs as a hand-written CUDA kernel (csrc/trellis_ac.cu); the rest of the
device work is PyTorch, and the host work is the shared C++ engine built
into the port's own library.

    import mozjpeg_tpu_torch as mjt
    jpegs = mjt.encode_many(images, mjt.EncoderConfig(quality=75))
    jpeg = mjt.encode(image, quality=75)
    pixels = mjt.decode_many(jpegs)
    half = mjt.decode_scaled(jpeg, 1, 2)

    python -m mozjpeg_tpu_torch.cli.djpeg -scale 1/2 -bmp in.jpg > o.bmp
"""
from .codec.config import DCTMethod, EncoderConfig, Profile
from .codec.decoder import (BufferedImage, decode, decode_cropped,
                            decode_grayscale, decode_many, decode_rgb565,
                            decode_scaled)
from .codec.encoder import encode, encode_many

__version__ = "0.1.0"

__all__ = ["BufferedImage", "DCTMethod", "EncoderConfig", "Profile",
           "decode", "decode_cropped", "decode_grayscale", "decode_many",
           "decode_rgb565", "decode_scaled", "encode", "encode_many"]
