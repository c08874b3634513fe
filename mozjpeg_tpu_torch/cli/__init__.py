"""Command lines of the PyTorch port (mirrors mozjpeg_tpu/cli, and the
repo root's tjbench.py and rd_collect.py as cli/tjbench.py and
cli/rd_collect.py)."""
