"""Command lines of the PyTorch port (mirrors mozjpeg_tpu/cli: djpeg,
jpegyuv)."""
