"""Image file readers and writers of the PyTorch port (mirrors
mozjpeg_tpu/utils: ppm, bmp, gif, targa)."""
