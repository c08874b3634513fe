"""The port's resumable corpus job (utils/jobs.run_corpus_job, over its
encode_many on the CPU) against the JAX package's: the output files and
the manifest records (their input, output, status, bytes and error
fields) of a corpus with PPM, BMP, GIF and Targa inputs of two shapes, a
corrupt input and an unsupported one, then a resume after one input
changed and one output was removed. The configuration (trellis_q_opt)
takes the host engine on both sides, so the JAX side compiles nothing.
Without CUDA the job raises before it reads an input."""
import json
import os

import pytest
import torch

import mozjpeg_tpu as mj
import mozjpeg_tpu_torch as mjt
from mozjpeg_tpu.utils import jobs as jjobs
from mozjpeg_tpu_torch.utils import bmp, gif, jobs as tjobs, targa
from test_torch_decode import _photo

KEYS = ("input", "output", "status", "bytes", "error")


def _corpus(d):
    paths = []

    def put(name, data):
        p = os.path.join(d, name)
        with open(p, "wb") as f:
            f.write(data)
        paths.append(p)

    img, odd = _photo(48, 64, 81), _photo(29, 37, 82)
    put("a.ppm", b"P6\n64 48\n255\n" + img.tobytes())
    put("b.ppm", b"P6\n64 48\n255\n" + _photo(48, 64, 83).tobytes())
    put("c.bmp", bmp.write_bmp(odd))
    put("d.tga", targa.write_targa(odd))
    put("e.gif", gif.write_gif(img[..., 0] // 64,
                               [[0, 0, 0], [90, 20, 20], [20, 180, 20],
                                [250, 250, 250]], 4))
    put("bad.bmp", b"BMnot really")
    put("f.webp", b"RIFF....WEBP")
    os.makedirs(os.path.join(d, "sub"))
    put(os.path.join("sub", "a.ppm"), b"P6\n64 48\n255\n" + img.tobytes())
    return paths


def _records(recs, root):
    return [{k: (r.get(k).replace(root, "@") if isinstance(r.get(k), str)
                 else r.get(k)) for k in KEYS} for r in recs]


def _job(side, tmp_path, **kw):
    root = str(tmp_path / side)
    os.makedirs(root, exist_ok=True)
    if not os.path.exists(os.path.join(root, "in")):
        os.makedirs(os.path.join(root, "in"))
        _corpus(os.path.join(root, "in"))
    inputs = sorted(os.path.join(dp, f) for dp, _, fs in
                    os.walk(os.path.join(root, "in")) for f in fs)
    out = os.path.join(root, "out")
    if side == "jax":
        recs = jjobs.run_corpus_job(
            inputs, out, mj.EncoderConfig(quality=75, trellis_q_opt=True),
            batch_size=3, **kw)
    else:
        recs = tjobs.run_corpus_job(
            inputs, out, mjt.EncoderConfig(quality=75, trellis_q_opt=True),
            batch_size=3, device="cpu", **kw)
    files = {f: open(os.path.join(out, f), "rb").read()
             for f in sorted(os.listdir(out)) if f.endswith(".jpg")}
    return root, recs, files


def test_corpus_job_and_resume_equal_jax(tmp_path):
    runs = {}
    for side in ("jax", "port"):
        root, recs, files = _job(side, tmp_path)
        runs[side] = (_records(recs, root), files)
    assert runs["jax"] == runs["port"]
    assert sum(r["status"] == "done" for r in runs["port"][0]) == 6
    assert sum(r["status"] == "error" for r in runs["port"][0]) == 2
    for side in ("jax", "port"):
        root = str(tmp_path / side)
        # change one input, drop one output: both are redone on resume
        with open(os.path.join(root, "in", "b.ppm"), "ab") as f:
            f.write(b"\n")
        os.remove(os.path.join(root, "out", "c.jpg"))
        seen = []
        root, recs, files = _job(side, tmp_path,
                                 progress=lambda n, t, r: seen.append(
                                     os.path.basename(r["input"])))
        manifest = [json.loads(line) for line in open(os.path.join(
            root, "out", "manifest.jsonl"))]
        runs[side] = (_records(recs, root), files, sorted(seen),
                      _records(manifest, root))
    assert runs["jax"] == runs["port"]
    assert runs["port"][2] == ["b.ppm", "bad.bmp", "c.bmp", "f.webp"]


def test_corpus_job_raises_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tjobs.run_corpus_job([str(tmp_path / "missing.ppm")],
                             str(tmp_path / "out"))
    assert not (tmp_path / "out").exists()
