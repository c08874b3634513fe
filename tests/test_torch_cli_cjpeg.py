"""The port's command lines on the CPU against the JAX package's: cjpeg
(main(argv, device="cpu")) on 40 flag sets over PPM, PGM, BMP, GIF, Targa
and PNG inputs (quality lists, tuning, -qtables / -qslots / -scans /
-sample files, -icc and a PNG's iCCP, restarts, -arithmetic, the DCTs,
-lossless, -precision 12 from a 16-bit PPM and 16 with -lossless,
-report / -verbose, -memdst, and the error paths), jpegtran on 16 flag
sets, yuvjpeg, rdjpgcom and wrjpgcom: output files, exit codes and
stderr equal (the version line names each package). cjpeg and yuvjpeg
refuse to run without CUDA unless the caller asks for the CPU."""
import io
import zlib

import numpy as np
import pytest
import torch

import mozjpeg_tpu_torch as mjt
from mozjpeg_tpu.cli import cjpeg as jcjpeg
from mozjpeg_tpu.cli import jpegtran as jjpegtran
from mozjpeg_tpu.cli import rdjpgcom as jrdjpgcom
from mozjpeg_tpu.cli import wrjpgcom as jwrjpgcom
from mozjpeg_tpu.cli import yuvjpeg as jyuvjpeg
from mozjpeg_tpu_torch.cli import cjpeg as tcjpeg
from mozjpeg_tpu_torch.cli import jpegtran as tjpegtran
from mozjpeg_tpu_torch.cli import rdjpgcom as trdjpgcom
from mozjpeg_tpu_torch.cli import wrjpgcom as twrjpgcom
from mozjpeg_tpu_torch.cli import yuvjpeg as tyuvjpeg
from mozjpeg_tpu_torch.utils import bmp, gif, targa
from test_torch_decode import _photo, _truncate
from test_torch_png import _chunk, _icc, _png


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_in")
    img = _photo(48, 64, 71)
    out = {}

    def put(name, data):
        p = d / name
        p.write_bytes(data)
        out[name] = str(p)

    put("in.ppm", b"P6\n64 48\n255\n" + img.tobytes())
    put("in.pgm", b"P5\n# gray\n64 48\n255\n" + img[..., 1].tobytes())
    put("in.bmp", bmp.write_bmp(img))
    pal = np.unique(img[..., :].reshape(-1, 3) // 64 * 64, axis=0)
    idx = np.zeros(img.shape[:2], np.uint8)
    put("in.gif", gif.write_gif(idx + (img[..., 0] // 64) % len(pal),
                                pal, len(pal)))
    put("gray.gif", gif.write_gif(img[..., 2] // 32,
                                  np.repeat(np.arange(0, 256, 32,
                                                      dtype=np.uint8)[:, None],
                                            3, 1), 8))
    put("in.tga", targa.write_targa(img))
    iccp = _chunk(b"iCCP", b"p\x00\x00" + zlib.compress(_icc(300)))
    put("in.png", _png(img, 8, 2, extra=[iccp]))
    put("gray.png", _png(img[..., 0], 8, 0))
    deep = (img.astype(np.uint16) << 4) | 7
    put("deep.ppm", b"P6\n64 48\n4095\n" + deep.astype(">u2").tobytes())
    put("q.txt", "\n# next\n".join(
        " ".join(str(v) for v in range(lo, lo + 64))
        for lo in (10, 20, 30)).encode())
    put("scans.txt", b"0 1 2: 0 0 0 1;\n0: 1 5 0 2;\n0: 6 63 0 2;\n"
        b"1: 1 63 0 1;\n2: 1 63 0 1;\n0: 1 63 2 1;\n0: 1 63 1 0;\n"
        b"1: 1 63 1 0;\n2: 1 63 1 0;\n0 1 2: 0 0 1 0;\n")
    put("icc.bin", bytes(range(256)) * 3)
    put("garbage.ppm", b"Q6 what")
    jpg = mjt.encode(img, mjt.EncoderConfig(quality=80), device="cpu")
    com = twrjpgcom.insert_comment(jpg, b"a note\r\nwith \\ and \x01",
                                   False)
    put("in.jpg", com)
    put("odd.jpg", mjt.encode(_photo(29, 37, 72),
                              mjt.EncoderConfig(quality=80), device="cpu"))
    put("small.jpg", mjt.encode(_photo(16, 24, 73),
                                mjt.EncoderConfig(quality=60), device="cpu"))
    put("trunc.jpg", _truncate(jpg, 0.5))
    rng = np.random.default_rng(74)
    put("in.yuv", rng.integers(0, 256, 64 * 48 * 3 // 2,
                               dtype=np.uint8).tobytes())
    return out


def _rc(fn):
    try:
        return fn()
    except SystemExit as e:
        return e.code


def _run_both(jax_main, port_main, argv, files, tmp_path, capsys,
              device="cpu"):
    """[(exit code, output bytes, stderr)] of the JAX and the port's
    command; "@" in argv is the side's output file, "%name" an input."""
    res = []
    for side, main in (("jax", jax_main), ("port", port_main)):
        out = tmp_path / (side + ".out")
        a = [str(out) if v == "@" else files.get(v[1:], v)
             if v.startswith("%") else v for v in argv]
        rc = _rc(lambda: main(a) if device is None
                 else main(a) if side == "jax" else main(a, device=device))
        err = capsys.readouterr().err.replace("mozjpeg_tpu_torch version",
                                              "mozjpeg_tpu version")
        res.append((rc, out.read_bytes() if out.exists() else None, err))
    return res


CJPEG = [
    ["%in.ppm"], ["-quality", "90", "%in.ppm"],
    ["-quality", "50,60", "%in.ppm"], ["-grayscale", "%in.ppm"],
    ["-baseline", "-optimize", "%in.ppm"], ["-progressive", "-fastcrush",
                                            "%in.ppm"],
    ["-revert", "%in.ppm"], ["-notrellis", "%in.ppm"],
    ["-notrellis-dc", "%in.ppm"], ["-trellis-dc-ver-weight", "1.0",
                                   "%in.ppm"],
    ["-noovershoot", "%in.ppm"], ["-tune-psnr", "%in.ppm"],
    ["-tune-ssim", "%in.ppm"], ["-tune-ms-ssim", "-quality", "80",
                                "%in.ppm"],
    ["-quant-table", "2", "%in.ppm"], ["-qtables", "%q.txt", "%in.ppm"],
    ["-qtables", "%q.txt", "-qslots", "0,1,2", "-fastcrush", "-notrellis",
     "%in.ppm"],
    ["-scans", "%scans.txt", "%in.ppm"], ["-sample", "2x1", "%in.ppm"],
    ["-sample", "1x1", "-grayscale", "%in.ppm"],
    ["-icc", "%icc.bin", "%in.ppm"], ["-restart", "1", "%in.ppm"],
    ["-restart", "2b", "-baseline", "%in.ppm"], ["-arithmetic", "%in.ppm"],
    ["-dc-scan-opt", "2", "-lambda1", "13", "-lambda2", "15", "%in.ppm"],
    ["-dct", "fast", "%in.ppm"], ["-nojfif", "-quant-baseline", "-quality",
                                   "10", "%in.ppm"],
    ["-memdst", "%in.ppm"], ["-report", "-verbose", "%in.ppm"],
    ["-lossless", "4,2", "-restart", "1", "%in.ppm"],
    ["-precision", "12", "%deep.ppm"],
    ["-precision", "16", "-lossless", "1", "%deep.ppm"],
    ["-precision", "16", "%deep.ppm"], ["-rgb", "%in.ppm"],
    ["%in.pgm"], ["%in.bmp"], ["%in.gif"], ["%gray.gif"],
    ["-targa", "%in.tga"], ["-verbose", "%in.png"], ["%gray.png"],
    ["-sample", "2x2,2x1", "%in.ppm"], ["-qtables", "missing.txt",
                                        "%in.ppm"],
    ["-icc", "missing.icc", "%in.ppm"], ["%garbage.ppm"], ["-version"],
]


@pytest.mark.parametrize("argv", CJPEG, ids=[" ".join(a) for a in CJPEG])
def test_cjpeg_equals_jax(files, tmp_path, capsys, argv):
    if "-memdst" not in argv and "-version" not in argv:
        argv = ["-outfile", "@"] + argv
    a, b = _run_both(jcjpeg.main, tcjpeg.main, argv, files, tmp_path,
                     capsys)
    assert a == b


JPEGTRAN = [
    ["%in.jpg"], ["-rotate", "90", "%in.jpg"],
    ["-rotate", "180", "-trim", "%odd.jpg"],
    ["-flip", "horizontal", "%odd.jpg"], ["-transpose", "%odd.jpg"],
    ["-transverse", "-perfect", "%odd.jpg"],
    ["-crop", "32x16+8+8", "-copy", "all", "%in.jpg"],
    ["-wipe", "16x16+16+16", "%in.jpg"],
    ["-drop", "+16+16", "%small.jpg", "%in.jpg"],
    ["-grayscale", "-copy", "none", "%in.jpg"],
    ["-icc", "%icc.bin", "-copy", "all", "%in.jpg"],
    ["-revert", "-restart", "2", "%in.jpg"],
    ["-arithmetic", "-scans", "%scans.txt", "%in.jpg"],
    ["-optimize", "-progressive", "-maxscans", "3", "%in.jpg"],
    ["-rotate", "90", "-transpose", "%in.jpg"],
    ["-strict", "%trunc.jpg"], ["%trunc.jpg"],
]


@pytest.mark.parametrize("argv", JPEGTRAN,
                         ids=[" ".join(a) for a in JPEGTRAN])
def test_jpegtran_equals_jax(files, tmp_path, capsys, argv):
    a, b = _run_both(jjpegtran.main, tjpegtran.main, ["-outfile", "@"]
                     + argv, files, tmp_path, capsys, device=None)
    assert a == b


YUVJPEG = [["75", "64x48", "%in.yuv", "@"], ["75", "64x47", "%in.yuv", "@"], ["101", "64x48", "%in.yuv", "@"],
           ["75", "64by48", "%in.yuv", "@"],
           ["75", "64x48", "missing.yuv", "@"], ["75"]]


@pytest.mark.parametrize("argv", YUVJPEG, ids=[" ".join(a) for a in YUVJPEG])
def test_yuvjpeg_equals_jax(files, tmp_path, capsys, argv):
    a, b = _run_both(jyuvjpeg.main, tyuvjpeg.main, argv, files, tmp_path,
                     capsys)
    assert a == b


def test_rdjpgcom_equals_jax(files):
    data = open(files["in.jpg"], "rb").read()
    for verbose, raw in ((False, False), (True, False)):
        a, b = io.StringIO(), io.StringIO()
        jrdjpgcom.scan(data, verbose, raw, a)
        trdjpgcom.scan(data, verbose, raw, b)
        assert a.getvalue() == b.getvalue() and "a note" in b.getvalue()
    for bad in (b"", b"\xff\xd9"):
        assert _rc(lambda: jrdjpgcom.scan(bad, False, False)) == \
            _rc(lambda: trdjpgcom.scan(bad, False, False))


def test_wrjpgcom_equals_jax(files, tmp_path):
    data = open(files["in.jpg"], "rb").read()
    for comment, replace in ((b"new", False), (b"x" * 300, True)):
        assert twrjpgcom.insert_comment(data, comment, replace) == \
            jwrjpgcom.insert_comment(data, comment, replace)
    outs = []
    for side, main in (("jax", jwrjpgcom.main), ("port", twrjpgcom.main)):
        p = tmp_path / (side + ".jpg")
        main(["-replace", "-comment", "hello", "-outfile", str(p),
              files["in.jpg"]])
        outs.append(p.read_bytes())
    assert outs[0] == outs[1]
    for bad in (b"", b"\xff\xd8\xff\xda\x00\x02", data[:40],
                b"x" * 70000):
        assert _rc(lambda: jwrjpgcom.insert_comment(
            bad if len(bad) < 70000 else data, bad[:70000], False)) == \
            _rc(lambda: twrjpgcom.insert_comment(
                bad if len(bad) < 70000 else data, bad[:70000], False))


@pytest.mark.parametrize("tool", ["cjpeg", "yuvjpeg"])
@pytest.mark.parametrize("device", [None, "cuda"], ids=["None", "cuda"])
def test_device_tools_raise_without_cuda(files, tmp_path, monkeypatch,
                                         tool, device):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main, argv = {
        "cjpeg": (tcjpeg.main, ["-outfile", str(tmp_path / "o.jpg"),
                                files["in.ppm"]]),
        "yuvjpeg": (tyuvjpeg.main, ["75", "64x48", files["in.yuv"],
                                    str(tmp_path / "o.jpg")])}[tool]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv, device=device)
    assert not (tmp_path / "o.jpg").exists()
