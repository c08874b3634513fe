"""codec layer of the PyTorch port (mirrors mozjpeg_tpu/codec)."""
