"""The port stands alone and carries the repo's two mozjpeg tools.

- The native host library builds from the port's own copy of the C++
  sources (native/*.cpp beside native/build.py), and no string constant
  of the port or of chip_smoke.py names the JAX package's directory.
- A copy of the port's package, run in a child with only that copy and
  the interpreter's own paths on sys.path and an audit hook that fails
  on any file, directory, library or command under mozjpeg_tpu/, builds
  its library and gives the in-repo port's bytes and pixels
  (tests/torch_standalone_worker.py).
- The port's tjbench and rd_collect (main(argv, device="cpu")) against
  the root tjbench.py and rd_collect.py on 48x40 photos: every field
  but the measured rates equal, rows exactly equal, TSV and SVG files
  equal byte for byte.
"""
import ast
import contextlib
import functools
import importlib.util
import io
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

import mozjpeg_tpu_torch as mjt
from mozjpeg_tpu_torch.cli import rd_collect as trd
from mozjpeg_tpu_torch.cli import tjbench as ttj
from mozjpeg_tpu_torch.native import build as nbuild

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "mozjpeg_tpu_torch")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_standalone_worker as standalone  # noqa: E402

# the "replaces" labels of chip_smoke.py's kernels line
REPLACES = {"mozjpeg_tpu/ops/pallas_trellis.py:242",
            "mozjpeg_tpu/ops/tablegen.py:30 (XLA, no pallas_call)",
            "mozjpeg_tpu/codec/trellis.py:89 (XLA, no pallas_call)",
            "mozjpeg_tpu/codec/trellis.py:319 (XLA, no pallas_call)",
            "mozjpeg_tpu/codec/pipeline_t.py:413 (XLA, no pallas_call)",
            "mozjpeg_tpu/ops/symbols.py:146 (XLA, no pallas_call)"}


@functools.lru_cache(maxsize=None)
def _root_tool(name):
    spec = importlib.util.spec_from_file_location(
        "root_" + name, os.path.join(REPO, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _photo(h, w, seed):
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([255 * xx / w, 255 * yy / h,
                    128 + 90 * np.sin((xx + 2 * yy) / 5.0)], -1)
    img[: h // 2, w // 2:] = r.uniform(0, 255, 3)
    img += r.normal(0, 9, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ppms(tmp_path_factory):
    d = tmp_path_factory.mktemp("tools_in")
    paths = []
    for i in range(2):
        img = _photo(40, 48, 140 + i)
        p = d / ("photo%d.ppm" % i)
        p.write_bytes(b"P6\n48 40\n255\n" + img.tobytes())
        paths.append(str(p))
    return paths


def _run(main, argv, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        assert main(argv, **kw) == 0
    return out.getvalue()


# ---------------------------------------------------------------------------
# (a) the port's own host sources


def test_native_sources_are_the_ports_own(monkeypatch):
    src = os.path.realpath(nbuild.SRC_DIR)
    assert src == os.path.join(os.path.realpath(PKG), "native")
    for name in nbuild.SOURCES:
        assert os.path.isfile(os.path.join(src, name)), name
    seen = []
    monkeypatch.setattr(nbuild, "ensure_built",
                        lambda out, srcs, cmd: seen.extend(srcs))
    nbuild.build_native()
    assert seen == [os.path.join(nbuild.SRC_DIR, s) for s in nbuild.SOURCES]
    assert all(os.path.realpath(s).startswith(os.path.realpath(PKG) + os.sep)
               for s in seen)


def _docstrings(tree):
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(first.value,
                                                          ast.Constant):
                docs.add(id(first.value))
    return docs


def test_no_string_constant_names_the_jax_package():
    files = [os.path.join(root, f) for root, _, fs in os.walk(PKG)
             for f in fs if f.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert os.path.join(PKG, "cli", "tjbench.py") in files
    bad, labels = [], set()
    for path in files:
        tree = ast.parse(open(path).read(), path)
        docs = _docstrings(tree)
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in docs
                    and (node.value == "mozjpeg_tpu"
                         or node.value.startswith("mozjpeg_tpu/"))):
                if path.endswith("chip_smoke.py") and node.value in REPLACES:
                    labels.add(node.value)
                else:
                    bad.append((os.path.relpath(path, REPO), node.lineno,
                                node.value))
    assert not bad, bad
    assert labels == REPLACES


# ---------------------------------------------------------------------------
# (b) a copy of the port with the JAX package out of reach


def test_standalone_copy_builds_and_matches(tmp_path):
    imgs = np.stack([_photo(40, 48, 150), _photo(40, 48, 151)])
    rc, out, res = standalone.run(REPO, str(tmp_path), "cpu", imgs)
    assert rc == 0, out[-4000:]
    assert res["violations"] == [] and res["built"] == [nbuild.LIB_NAME]
    cfg = mjt.EncoderConfig(quality=75)
    assert res["host_engine_calls"] == len(imgs)
    assert res["encode"] == [mjt.encode(im, cfg, device="cpu")
                             for im in imgs]
    many = mjt.encode_many(list(imgs), cfg, device="cpu")
    assert res["encode_many"] == many
    for got, data in zip(res["decode"], many):
        np.testing.assert_array_equal(got, mjt.decode(data, device="cpu"))


# ---------------------------------------------------------------------------
# (c) tjbench

RATES = ("compress_mps", "decompress_mps")


@pytest.mark.parametrize("flags", [
    ["-subsamp", "420"], ["-subsamp", "444"], ["-subsamp", "gray"],
    ["-progressive", "-optimize"], ["-arithmetic"], ["-scale", "1/2"],
    ["-tile"], ["-tile", "-subsamp", "444"], ["-tile", "-subsamp", "gray"]],
    ids=lambda f: "".join(f))
def test_tjbench_matches_root_tool(ppms, flags):
    argv = [ppms[0], "-json", "-reps", "1", "-warmup", "0"] + flags
    want = json.loads(_run(_root_tool("tjbench").main, argv))
    got = json.loads(_run(ttj.main, argv, device="cpu"))
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k in RATES:
            assert got[k] > 0, k
        elif k.startswith("tile_"):
            assert got[k]["mps"] > 0
            assert ({"tiles": got[k]["tiles"], "exact": got[k]["exact"]}
                    == {"tiles": v["tiles"], "exact": v["exact"]}), k
        else:
            assert got[k] == v, k
    if "-tile" in flags:
        assert len([k for k in got if k.startswith("tile_")]) == len(
            ttj.tile_sizes(got["subsamp"]))
        if got["subsamp"] in ("444", "gray"):
            assert all(got[k]["exact"] for k in got if k.startswith("tile_"))


def test_tjbench_text_lines(ppms):
    """The text lines equal the root tool's, the measured rates aside."""
    argv = [ppms[0], "-reps", "1", "-warmup", "0", "-tile", "-subsamp",
            "gray"]

    def masked(out):
        return re.sub(r"--> +[0-9.]+ MP/s", "--> MP/s", out)
    got = _run(ttj.main, argv, device="cpu")
    assert masked(got) == masked(_run(_root_tool("tjbench").main, argv))
    assert got.splitlines()[-1].endswith("(output 40x48x3)")
    assert sum(ln.startswith("Tile ") for ln in got.splitlines()) == 5
    assert "MISMATCH" not in got


# ---------------------------------------------------------------------------
# (d) rd_collect


@pytest.mark.parametrize("flags", [
    ["-profile", "max", "-json"], ["-profile", "fast", "-json"],
    ["-subsamp", "444", "-json"], ["-average", "-json"],
    ["-profile", "fast", "-average", "-json"], ["-tsv", "-plot"],
    ["-average", "-tsv", "-plot"]], ids=lambda f: "".join(f))
def test_rd_collect_matches_root_tool(ppms, tmp_path, flags):
    def argv(tag):
        a = list(ppms) + ["-q", "50,90"]
        for f in flags:
            if f == "-tsv":
                a += ["-o", str(tmp_path / (tag + ".tsv"))]
            elif f == "-plot":
                a += ["-plot", str(tmp_path / (tag + ".svg"))]
            else:
                a.append(f)
        return a
    want = _run(_root_tool("rd_collect").main, argv("root"))
    got = _run(trd.main, argv("port"), device="cpu")
    assert got == want
    if "-json" in flags:
        rows = json.loads(got)
        assert len(rows) == (2 if "-average" in flags else 4)
        assert all(r["psnr"] > 20 and 0 < r["ssim"] <= 1 for r in rows)
    for ext in ("tsv", "svg"):
        if "-" + ext in flags or (ext == "svg" and "-plot" in flags):
            port = (tmp_path / ("port." + ext)).read_bytes()
            assert port == (tmp_path / ("root." + ext)).read_bytes()
            assert len(port) > 0


def test_transform_keeps_its_source_unchanged(ppms):
    """TJ.transform keeps the last source's coefficients: a sequence of
    transforms of one JPEG on one TJ equals each on a fresh TJ."""
    from mozjpeg_tpu_torch import turbojpeg as tj
    from mozjpeg_tpu_torch.utils import ppm
    img = ppm.read(ppms[1])
    kept = tj.TJ(device="cpu")
    data = kept.compress(img)
    calls = [dict(crop=(16, 0, 16, 16)), dict(op=tj.TJXOP_ROT90),
             dict(op=tj.TJXOP_HFLIP, options=tj.TJXOPT_TRIM),
             dict(options=tj.TJXOPT_GRAY), dict(crop=(0, 16, 48, 24)),
             dict(op=tj.TJXOP_TRANSVERSE, options=tj.TJXOPT_PROGRESSIVE),
             dict(options=tj.TJXOPT_ARITHMETIC), dict(crop=(16, 0, 16, 16))]
    for kw in calls:
        assert kept.transform(data, **kw) == tj.TJ(device="cpu").transform(
            data, **kw), kw
    other = kept.compress(img[::-1].copy())
    assert kept.transform(other) == tj.TJ(device="cpu").transform(other)
