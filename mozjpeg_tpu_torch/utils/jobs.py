"""Resumable corpus-encode jobs with per-image failure isolation.

The reference's recoverability story is in-process: suspension snapshots
per MCU (jchuff.c savable_state) and setjmp error recovery (example.c,
jerror.c error_exit). At TPU batch scale the durable analog (SURVEY.md §5
checkpoint/resume, failure detection) is the job manifest: every input's
outcome is a JSONL record written as soon as it is known, so a killed or
crashed job resumes exactly where it stopped, and a malformed input is
quarantined as an "error" record instead of failing the batch.

Port of mozjpeg_tpu/utils/jobs.py over the port's encode_many, on the
device run_corpus_job is given (the GPU by default; the device is
checked before any input is read, so a missing GPU raises instead of
being quarantined as an input's error).
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

from ..codec.encoder import _device


def _stat_sig(path: str):
    st = os.stat(path)
    return [int(st.st_size), int(st.st_mtime)]


def load_manifest(manifest_path: str) -> Dict[str, dict]:
    """Latest record per input (later lines supersede earlier ones)."""
    done: Dict[str, dict] = {}
    if not os.path.exists(manifest_path):
        return done
    with open(manifest_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue            # torn write from a killed job: ignore
            done[rec.get("input", "")] = rec
    return done


def run_corpus_job(inputs: Sequence[str], out_dir: str,
                   config=None, manifest_path: Optional[str] = None,
                   batch_size: int = 16, resume: bool = True,
                   progress: Optional[Callable] = None,
                   device=None) -> List[dict]:
    """Encode `inputs` (PPM/BMP/GIF/TGA paths) to `out_dir`/<stem>.jpg.

    Returns the manifest records in input order. A record is written for
    every input as soon as its outcome is known:
      {"input", "output", "status": "done", "bytes", "sig": [size, mtime]}
      {"input", "status": "error", "error": "..."}
    resume=True skips inputs whose manifest record is "done" AND whose
    file signature is unchanged; errors are always retried. Batches of
    same-shape images run through the pipelined batch encoder, on
    `device`: None or "cuda" (the GPU; raises RuntimeError without one)
    or "cpu"."""
    from . import ppm, bmp, gif, targa
    dev = _device(device)

    os.makedirs(out_dir, exist_ok=True)
    manifest_path = manifest_path or os.path.join(out_dir, "manifest.jsonl")
    prior = load_manifest(manifest_path) if resume else {}

    def read_image(path: str):
        ext = os.path.splitext(path)[1].lower()
        if ext in (".ppm", ".pgm", ".pnm"):
            return ppm.read(path)
        with open(path, "rb") as f:
            data = f.read()
        if ext == ".bmp":
            return bmp.read_bmp(data)[0]
        if ext == ".gif":
            return gif.read_gif(data)[0]
        if ext in (".tga", ".targa"):
            return targa.read_targa(data)[0]
        raise ValueError("unsupported input format: %s" % path)

    results: Dict[str, dict] = {}
    pending: List[str] = []
    mf = open(manifest_path, "a")
    try:
        return _run(inputs, out_dir, config, batch_size, prior, results,
                    pending, mf, read_image, progress, dev)
    finally:
        mf.close()


def _run(inputs, out_dir, config, batch_size, prior, results, pending, mf,
         read_image, progress, dev):
    from .. import encode_many

    def emit(rec: dict):
        results[rec["input"]] = rec
        mf.write(json.dumps(rec) + "\n")
        mf.flush()
        if progress:
            progress(len(results), len(inputs), rec)

    for path in inputs:
        rec = prior.get(path)
        if rec and rec.get("status") == "done":
            out = rec.get("output", "")
            try:
                if rec.get("sig") == _stat_sig(path) and os.path.exists(out):
                    results[path] = rec
                    continue
            except OSError:
                pass
        pending.append(path)

    # collision-safe output paths: same-basename inputs from different
    # directories must not clobber each other
    outs: Dict[str, str] = {}
    taken = {r.get("output") for r in results.values() if r.get("output")}
    for path in pending:
        stem = os.path.splitext(os.path.basename(path))[0]
        cand = os.path.join(out_dir, stem + ".jpg")
        k = 1
        while cand in taken:
            cand = os.path.join(out_dir, "%s-%d.jpg" % (stem, k))
            k += 1
        taken.add(cand)
        outs[path] = cand

    # stream in chunks: read + group by shape per chunk so only
    # ~batch_size decoded images are resident at a time; a reader
    # exception on untrusted bytes quarantines the input
    for c0 in range(0, len(pending), batch_size):
        groups: Dict[tuple, List[tuple]] = {}
        for path in pending[c0:c0 + batch_size]:
            try:
                img = read_image(path)
            except Exception as e:              # noqa: BLE001 — quarantine
                emit({"input": path, "status": "error",
                      "error": "%s: %s" % (type(e).__name__, e),
                      "ts": time.time()})
                continue
            groups.setdefault(img.shape, []).append((path, img))
        for shape, items in groups.items():
            chunk = items
            try:
                datas = encode_many([im for _, im in chunk], config,
                                    device=dev)
            except Exception:
                # batch-level failure: isolate per image
                datas = []
                for path, im in chunk:
                    try:
                        datas.append(encode_many([im], config,
                                                 device=dev)[0])
                    except Exception as e:      # noqa: BLE001 — quarantine
                        datas.append(e)
            for (path, _), data in zip(chunk, datas):
                if isinstance(data, Exception):
                    emit({"input": path, "status": "error",
                          "error": "%s: %s" % (type(data).__name__, data),
                          "ts": time.time()})
                    continue
                out = outs[path]
                with open(out, "wb") as f:
                    f.write(data)
                emit({"input": path, "output": out, "status": "done",
                      "bytes": len(data), "sig": _stat_sig(path),
                      "ts": time.time()})

    return [results[p] for p in inputs if p in results]
