"""The port's djpeg and jpegyuv command lines on the CPU write the same
bytes and return the same exit codes as the JAX package's, flag set by
flag set: default PPM, -scale, -rgb565 -bmp, -bmp/-os2, -gif/-gif0,
-targa, -colors with -onepass and -dither, -map, -grayscale, -crop,
-skip, -fast, -dct fast/float, -strict and warnings on a truncated stream,
-icc and -maxscans, with their error paths; jpegyuv on a 4:2:0 stream and
its refusals; and both refuse to run without CUDA unless the caller asks
for the CPU (no fallback)."""
import numpy as np
import pytest
import torch

import mozjpeg_tpu_torch as mjt
from mozjpeg_tpu.cli import djpeg as jdjpeg
from mozjpeg_tpu.cli import jpegyuv as jjpegyuv
from mozjpeg_tpu_torch.cli import djpeg as tdjpeg
from mozjpeg_tpu_torch.cli import jpegyuv as tjpegyuv
from mozjpeg_tpu_torch.utils import gif as tgif
from test_torch_decode import _photo, _truncate


def _enc(im, **kw):
    kw.setdefault("quality", 80)
    return mjt.encode(im, mjt.EncoderConfig(**kw), device="cpu")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Input JPEGs and colormap files on disk."""
    d = tmp_path_factory.mktemp("djpeg_in")
    img, odd = _photo(48, 64, 101), _photo(29, 37, 102)
    icc = bytes(range(256)) * 3
    streams = {
        "ycc": _enc(img),
        "ycc_odd": _enc(odd, subsampling=(2, 1)),
        "gray": _enc(img[..., 0]),
        "arith": _enc(img, arithmetic=True),
        "seq_444": _enc(img, subsampling=(1, 1), progressive=False),
        "icc": _enc(img, icc=icc, density=(2, 28, 30)),
    }
    streams["truncated"] = _truncate(streams["ycc"], 0.6)
    out = {}
    for name, data in streams.items():
        p = d / (name + ".jpg")
        p.write_bytes(data)
        out[name] = str(p)
    pal = np.array([[0, 0, 0], [255, 255, 255], [200, 30, 30],
                    [30, 200, 30], [30, 30, 200], [128, 128, 0]], np.uint8)
    p = d / "map.gif"
    p.write_bytes(tgif.write_gif(np.zeros((1, 6), np.uint8), pal, 6))
    out["map_gif"] = str(p)
    p = d / "map.ppm"
    p.write_bytes(b"P6\n6 1\n255\n" + pal.tobytes())
    out["map_ppm"] = str(p)
    out["icc_bytes"] = icc
    return out


def _run_both(argv, tmp_path, device="cpu"):
    """(exit codes, output bytes) of the JAX and the port's djpeg; -outfile
    and -icc paths get one file per side."""
    res = []
    for side, main in (("jax", jdjpeg.main), ("port", tdjpeg.main)):
        a = [v.replace("@", str(tmp_path / side)) for v in argv]
        rc = main(a) if side == "jax" else main(a, device=device)
        outs = {}
        for name in ("out", "icc"):
            p = tmp_path / ("%s.%s" % (side, name))
            outs[name] = p.read_bytes() if p.exists() else None
        res.append((rc, outs))
    return res


# (input, flags); "@.out" is the output file, "@.icc" the ICC file
FLAG_SETS = [
    ("ycc", []),
    ("ycc", ["-scale", "1/2"]),
    ("ycc", ["-scale", "13/8", "-bmp"]),
    ("ycc_odd", ["-scale", "3/8", "-nosmooth"]),
    ("ycc", ["-rgb565", "-bmp"]),
    ("ycc_odd", ["-rgb565", "-bmp", "-nosmooth"]),
    ("ycc", ["-bmp"]),
    ("ycc_odd", ["-os2"]),
    ("gray", ["-os2"]),
    ("ycc", ["-gif"]),
    ("ycc", ["-gif0"]),
    ("gray", ["-gif"]),
    ("ycc", ["-targa"]),
    ("gray", ["-targa"]),
    ("ycc", ["-colors", "64"]),
    ("ycc", ["-colors", "16", "-dither", "none", "-bmp"]),
    ("ycc", ["-onepass", "-dither", "ordered", "-colors", "27", "-targa"]),
    ("ycc_odd", ["-onepass", "-dither", "fs", "-colors", "8", "-gif"]),
    ("gray", ["-onepass", "-colors", "12", "-targa"]),
    ("gray", ["-colors", "16", "-os2"]),
    ("ycc", ["-map", "MAP_GIF"]),
    ("ycc_odd", ["-map", "MAP_PPM", "-dither", "none", "-bmp"]),
    ("ycc", ["-grayscale"]),
    ("ycc", ["-grayscale", "-os2"]),
    ("ycc", ["-grayscale", "-scale", "1/4"]),
    ("gray", ["-rgb"]),
    ("ycc", ["-crop", "20x16+9+5"]),
    ("ycc_odd", ["-crop", "17x20+3+1", "-grayscale"]),
    ("ycc", ["-crop", "20x60+0+0"]),
    ("ycc", ["-crop", "20x16+9+5", "-scale", "1/2"]),
    ("ycc", ["-skip", "3,10"]),
    ("ycc", ["-skip", "10,3"]),
    ("ycc", ["-skip", "3,60"]),
    ("ycc", ["-scale", "1/2", "-skip", "0,4"]),
    ("ycc", ["-fast"]),
    ("ycc", ["-fast", "-gif"]),
    ("ycc", ["-dct", "fast"]),
    ("seq_444", ["-dct", "float"]),
    ("arith", ["-bmp"]),
    ("truncated", []),
    ("truncated", ["-strict"]),
    ("ycc", ["-strict"]),
    ("icc", ["-icc", "@.icc", "-bmp"]),
    ("ycc", ["-icc", "@.icc"]),
    ("ycc", ["-maxscans", "2"]),
    ("ycc", ["-maxscans", "100", "-gif"]),
]


@pytest.mark.parametrize("name,flags", FLAG_SETS,
                         ids=["%s %s" % (n, " ".join(f)) if f else n
                              for n, f in FLAG_SETS])
def test_djpeg_equals_jax(files, tmp_path, name, flags):
    flags = [{"MAP_GIF": files["map_gif"],
              "MAP_PPM": files["map_ppm"]}.get(f, f) for f in flags]
    (rc_j, out_j), (rc_t, out_t) = _run_both(
        flags + ["-outfile", "@.out", files[name]], tmp_path)
    assert rc_t == rc_j
    assert out_t == out_j
    if rc_j == 0:
        assert out_j["out"]


def test_djpeg_stream_facts(files, tmp_path):
    """The flag sets above reach what they mean to: warnings, an ICC
    profile, more scans than -maxscans allows, an error exit."""
    runs = [["-outfile", "@.out", files["truncated"]],
            ["-icc", "@.icc", "-outfile", "@.out", files["icc"]],
            ["-maxscans", "2", "-outfile", "@.out", files["ycc"]]]
    res = []
    for i, argv in enumerate(runs):
        (tmp_path / str(i)).mkdir()
        res.append(_run_both(argv, tmp_path / str(i))[1])
    (rc_trunc, _), (rc_icc, icc), (rc_max, out_max) = res
    assert rc_trunc == 2
    assert rc_icc == 0 and icc["icc"] == files["icc_bytes"]
    assert rc_max == 1 and out_max["out"] is None


def test_djpeg_to_stdout_equals_jax(files, capsysbinary):
    for main in (jdjpeg.main, lambda a: tdjpeg.main(a, device="cpu")):
        assert main(["-scale", "1/2", files["ycc"]]) == 0
    out = capsysbinary.readouterr().out
    assert len(out) % 2 == 0 and out[:len(out) // 2] == out[len(out) // 2:]
    assert out.startswith(b"P6\n32 24\n255\n")


def test_djpeg_version_names_the_port(capsys):
    assert tdjpeg.main(["-version"]) == 0
    assert "mozjpeg_tpu_torch version" in capsys.readouterr().err


@pytest.mark.parametrize("name", ["ycc", "gray", "ycc_odd"])
def test_jpegyuv_equals_jax(files, tmp_path, name, capsys):
    want, got = tmp_path / "j.yuv", tmp_path / "t.yuv"
    rc_j = jjpegyuv.main([files[name], str(want)])
    err_j = capsys.readouterr().err
    rc_t = tjpegyuv.main([files[name], str(got)], device="cpu")
    assert (rc_t, capsys.readouterr().err) == (rc_j, err_j)
    if rc_j == 0:
        assert got.read_bytes() == want.read_bytes()
        assert len(want.read_bytes()) == 64 * 48 + 2 * 32 * 24
    else:
        assert not got.exists()


def test_jpegyuv_usage_and_paths_equal_jax(files, tmp_path, capsys):
    for argv in ([], [files["ycc"]], [str(tmp_path / "missing.jpg"),
                                     str(tmp_path / "o.yuv")],
                 [files["ycc"], str(tmp_path / "no" / "o.yuv")]):
        rc_j = jjpegyuv.main(argv)
        err_j = capsys.readouterr().err
        rc_t = tjpegyuv.main(argv, device="cpu")
        assert (rc_t, capsys.readouterr().err) == (rc_j, err_j)
        assert rc_j == 1


def test_command_lines_refuse_without_cuda(files, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "o")
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tdjpeg.main(["-outfile", out, files["ycc"]], device=device)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tjpegyuv.main([files["ycc"], out], device=device)
        for fn in (lambda: mjt.decode_scaled(b"", 1, 2, device=device),
                   lambda: mjt.decode_rgb565(b"", device=device)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                fn()
