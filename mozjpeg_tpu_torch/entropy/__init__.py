"""entropy layer of the PyTorch port (mirrors mozjpeg_tpu/entropy)."""
