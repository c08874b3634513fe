"""The port stands alone: importing it loads neither jax nor the JAX
package, no module of it imports them, and it never falls back to the CPU
when the GPU it was asked for is missing."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mozjpeg_tpu_torch as mjt
from mozjpeg_tpu_torch.cli import rd_collect, tjbench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "mozjpeg_tpu_torch")


def _forbidden(name: str) -> bool:
    return (name in ("jax", "mozjpeg_tpu")
            or name.startswith(("jax.", "jaxlib", "mozjpeg_tpu.")))


def test_import_leaves_jax_and_jax_package_unloaded():
    code = ("import sys, mozjpeg_tpu_torch\n"
            "import mozjpeg_tpu_torch.cli.djpeg, "
            "mozjpeg_tpu_torch.cli.jpegyuv, "
            "mozjpeg_tpu_torch.codec.lossless, "
            "mozjpeg_tpu_torch.codec.report, "
            "mozjpeg_tpu_torch.codec.transcode, "
            "mozjpeg_tpu_torch.turbojpeg, "
            "mozjpeg_tpu_torch.utils.png, mozjpeg_tpu_torch.utils.jobs, "
            "mozjpeg_tpu_torch.cli.cjpeg, mozjpeg_tpu_torch.cli.jpegtran, "
            "mozjpeg_tpu_torch.cli.yuvjpeg, mozjpeg_tpu_torch.cli.rdjpgcom, "
            "mozjpeg_tpu_torch.cli.wrjpgcom, "
            "mozjpeg_tpu_torch.cli.rdswitch, "
            "mozjpeg_tpu_torch.ops.sparsepack, "
            "mozjpeg_tpu_torch.ops.planepack, "
            "mozjpeg_tpu_torch.ops.transport, "
            "mozjpeg_tpu_torch.ops.trellis_rows, "
            "mozjpeg_tpu_torch.ops.p1, "
            "mozjpeg_tpu_torch.utils.xfer, "
            "mozjpeg_tpu_torch.utils.attachment, "
            "mozjpeg_tpu_torch.cli.tjbench, mozjpeg_tpu_torch.cli.rd_collect\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', "
            "'mozjpeg_tpu') or m.startswith(('jax.', 'jaxlib', "
            "'mozjpeg_tpu.')))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _py_files():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_module_imports_jax_or_the_jax_package():
    scanned = {os.path.relpath(p, REPO) for p in _py_files()}
    # the modules each slice brought are among those scanned
    for rel in ("cli/djpeg.py", "cli/jpegyuv.py", "codec/arith.py",
                "codec/decoder.py", "codec/encoder.py", "codec/lossless.py",
                "codec/marker.py", "codec/report.py", "codec/transcode.py",
                "turbojpeg.py", "utils/png.py", "utils/jobs.py",
                "cli/cjpeg.py", "cli/jpegtran.py", "cli/yuvjpeg.py",
                "cli/rdjpgcom.py", "cli/wrjpgcom.py", "cli/rdswitch.py",
                "native/__init__.py", "ops/color.py", "ops/dct.py",
                "ops/idct_scaled.py", "ops/trellis_ac.py", "utils/bmp.py",
                "utils/gif.py", "utils/ppm.py", "utils/targa.py",
                "ops/sparsepack.py", "ops/planepack.py", "ops/transport.py",
                "utils/xfer.py", "utils/attachment.py", "cli/tjbench.py",
                "cli/rd_collect.py", "ops/trellis_rows.py", "ops/p1.py"):
        assert os.path.join("mozjpeg_tpu_torch", rel) in scanned
    bad = []
    for path in _py_files():
        rel = os.path.relpath(path, REPO)
        depth = rel.count(os.sep)          # package levels above the file
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                bad += [(rel, a.name) for a in node.names
                        if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom):
                if node.level == 0 and _forbidden(node.module or ""):
                    bad.append((rel, node.module))
                if node.level > depth:     # a relative import out of it
                    bad.append((rel, "." * node.level + (node.module or "")))
    assert not bad, bad


_IMG = np.zeros((16, 16, 3), np.uint8)
_CFG = mjt.EncoderConfig(quality=75)
_ENTRIES = {
    "encode": lambda jpeg, device: mjt.encode(_IMG, _CFG, device=device),
    "encode_many": lambda jpeg, device: mjt.encode_many(
        [_IMG], _CFG, device=device),
    "decode": lambda jpeg, device: mjt.decode(jpeg, device=device),
    "decode_many": lambda jpeg, device: mjt.decode_many([jpeg],
                                                        device=device),
    "decode_grayscale": lambda jpeg, device: mjt.decode_grayscale(
        jpeg, device=device),
    "decode_cropped": lambda jpeg, device: mjt.decode_cropped(
        jpeg, 0, 8, device=device),
    "BufferedImage": lambda jpeg, device: mjt.BufferedImage(
        jpeg, device=device),
    "decode_scaled": lambda jpeg, device: mjt.decode_scaled(
        jpeg, 1, 2, device=device),
    "decode_rgb565": lambda jpeg, device: mjt.decode_rgb565(
        jpeg, device=device),
    "tjbench": lambda jpeg, device: tjbench.main(["in.ppm"], device=device),
    "rd_collect": lambda jpeg, device: rd_collect.main(["in.ppm"],
                                                       device=device),
}


@pytest.fixture(scope="module")
def jpeg():
    return mjt.encode_many([_IMG], _CFG, device="cpu")[0]


@pytest.mark.parametrize("entry,device", [
    pytest.param("encode_many", None, id="None"),
    pytest.param("encode_many", "cuda", id="cuda"),
    *(pytest.param(e, d, id="%s-%s" % (e, d))
      for e in ("encode", "decode", "decode_many", "decode_grayscale",
                "decode_cropped", "BufferedImage", "decode_scaled",
                "decode_rgb565", "tjbench", "rd_collect")
      for d in (None, "cuda"))])
def test_gpu_entry_raises_without_cuda(monkeypatch, jpeg, entry, device):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _ENTRIES[entry](jpeg, device)
