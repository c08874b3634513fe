"""The port run from a copy of its package, with the JAX package out of
reach (imports no JAX).

As a library: run(repo, workdir, device, images) copies
<repo>/mozjpeg_tpu_torch/ (without _build/ and caches) into <workdir>,
starts this file as a child in isolated mode (python -I: no PYTHONPATH,
no user site, no script directory on sys.path) and returns the child's
exit code, its output and its results.

As the child:

    python -I torch_standalone_worker.py <copy_parent> <forbidden> <device>
        <in.npy> <out.pkl>

puts only <copy_parent> in front of the interpreter's own sys.path,
checks that the JAX package cannot be found, installs an audit hook that
fails the run on any open, os.listdir, os.scandir, ctypes.dlopen or
subprocess.Popen naming a path under <forbidden> (the checkout's JAX
package), builds the native host library (and on "cuda" the four CUDA
libraries) from the copy, then encodes the images of <in.npy> with the
default configuration: on "cpu" encode() (the host engine), encode_many
and decode of encode_many's bytes; on "cuda" encode() on the card, with
the kernels' launch counts, and each p1 launch of the first image held
against its plain version. Writes the results to <out.pkl>.
"""
import os
import pickle
import shutil
import subprocess
import sys
import time

import numpy as np

PKG = "mozjpeg_tpu_torch"


def run(repo, workdir, device, images, timeout=600):
    """-> (exit code, output, results or None) of a child on a fresh copy
    of <repo>'s port under <workdir>, encoding `images` (n, h, w, 3)."""
    shutil.copytree(os.path.join(repo, PKG), os.path.join(workdir, PKG),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    inpath = os.path.join(workdir, "in.npy")
    outpath = os.path.join(workdir, "out.pkl")
    np.save(inpath, np.asarray(images))
    r = subprocess.run(
        [sys.executable, "-I", os.path.abspath(__file__), workdir,
         os.path.join(repo, "mozjpeg_tpu"), device, inpath, outpath],
        cwd=workdir, capture_output=True, text=True, timeout=timeout)
    res = None
    if os.path.exists(outpath):
        with open(outpath, "rb") as f:
            res = pickle.load(f)
    return r.returncode, r.stdout + r.stderr, res


def _under(path, root) -> bool:
    if isinstance(path, int):
        return False
    try:
        p = os.path.realpath(os.fsdecode(path))
    except TypeError:
        return False
    return p == root or p.startswith(root + os.sep)


def child(copy_parent, forbidden, device, inpath, outpath):
    forbidden = os.path.realpath(forbidden)
    violations = []

    def hook(event, args):
        if event in ("open", "os.listdir", "os.scandir", "ctypes.dlopen"):
            names = list(args[:1])
        elif event == "subprocess.Popen":
            exe, argv, cwd = args[:3]
            names = [exe, cwd] + (list(argv) if isinstance(
                argv, (list, tuple)) else [argv])
        else:
            return
        bad = [n for n in names if n is not None and _under(n, forbidden)]
        if bad:
            violations.append((event, [os.fsdecode(b) for b in bad]))
            raise RuntimeError("%s reached the JAX package: %s"
                               % (event, bad))

    sys.addaudithook(hook)
    repo = os.path.dirname(forbidden)
    sys.path.insert(0, copy_parent)
    on_path = [p for p in sys.path
               if os.path.realpath(p or os.getcwd()) == repo]
    import importlib.util
    found = importlib.util.find_spec("mozjpeg_tpu")
    if on_path or found is not None:
        raise SystemExit("the checkout is reachable: sys.path %s, "
                         "mozjpeg_tpu %s" % (on_path, found))

    import torch
    if device == "cpu":
        torch.set_num_threads(1)
    import mozjpeg_tpu_torch as mjt
    from mozjpeg_tpu_torch.codec import host_engine
    from mozjpeg_tpu_torch.native import build as nbuild
    from mozjpeg_tpu_torch.ops import p1 as tp1
    from mozjpeg_tpu_torch.ops import tablegen as tg
    from mozjpeg_tpu_torch.ops import trellis_ac as tac
    from mozjpeg_tpu_torch.ops import trellis_rows as trw
    for mod in (mjt, nbuild):
        if not _under(mod.__file__, os.path.realpath(copy_parent)):
            raise SystemExit("%s loaded from %s" % (mod.__name__,
                                                    mod.__file__))
    if not _under(nbuild.BUILD_DIR, os.path.realpath(copy_parent)):
        raise SystemExit("the library builds outside the copy")

    t0 = time.perf_counter()
    if device == "cuda":
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(5) as ex:
            futs = [ex.submit(f) for f in (nbuild.build_native, tac.build,
                                           tg.build, trw.build, tp1.build)]
            for f in futs:
                f.result()
        built = [nbuild.LIB_NAME, tac.LIB_NAME, tg.LIB_NAME, trw.LIB_NAME,
                 tp1.LIB_NAME]
    else:
        nbuild.build_native()
        built = [nbuild.LIB_NAME]
    res = {"build_s": time.perf_counter() - t0, "built": built}
    for name in built:
        if not os.path.exists(os.path.join(nbuild.BUILD_DIR, name)):
            raise SystemExit("%s was not built in the copy" % name)

    images = list(np.load(inpath))
    cfg = mjt.EncoderConfig(quality=75)
    host_calls = []
    encode_host = host_engine.encode_host

    def counted_host(*a, **kw):
        host_calls.append(1)
        return encode_host(*a, **kw)
    host_engine.encode_host = counted_host
    if device == "cpu":
        res["encode"] = [mjt.encode(im, cfg, device="cpu") for im in images]
        res["host_engine_calls"] = len(host_calls)
        res["encode_many"] = mjt.encode_many(images, cfg, device="cpu")
        res["decode"] = [mjt.decode(b, device="cpu")
                         for b in res["encode_many"]]
    else:
        t0 = time.perf_counter()
        mjt.encode(images[0], cfg, device="cuda")          # warm-up
        torch.cuda.synchronize()
        res["warm_s"] = time.perf_counter() - t0
        tac.reset_launches()
        tg.reset_launches()
        trw.reset_launches()
        tp1.reset_launches()
        t0 = time.perf_counter()
        res["encode"] = [mjt.encode(im, cfg, device="cuda")
                         for im in images]
        torch.cuda.synchronize()
        res["encode_s"] = time.perf_counter() - t0
        res["launches"] = {"trellis_ac": tac.trellis_ac.launches,
                           "tablegen": tg.launches,
                           "trellis_dc": trw.trellis_dc.launches,
                           "p1_blocks": tp1.p1_blocks.launches,
                           "p1_eob_hist": tp1.p1_eob_hist.launches}
        res["p1_check"] = _p1_check(tp1, lambda: mjt.encode(
            images[0], cfg, device="cuda"))
        res["host_engine_calls"] = len(host_calls)
    res["violations"] = violations
    with open(outpath, "wb") as f:
        pickle.dump(res, f)
    if violations:
        raise SystemExit("the run reached the JAX package: %s" % violations)
    print("standalone %s: ok, build %.1f s" % (device, res["build_s"]))


def _p1_check(tp1, fn):
    """fn() with each p1 kernel launch recorded (ops/p1.RECORDERS), then
    each held against its plain version -> [largest difference, launches
    held, all exact]."""
    import torch
    rec = []

    def record(kind, args):
        if kind == "p1_eob_hist":
            args = (args[0], args[1].clone()) + tuple(args[2:])
        rec.append((kind, args))
    tp1.RECORDERS.append(record)
    try:
        fn()
    finally:
        tp1.RECORDERS.remove(record)
    err, exact = 0.0, True
    for kind, a in rec:
        if kind == "p1_eob_hist":
            got = [tp1.p1_eob_hist(a[0], a[1].clone(), *a[2:])]
            want = [tp1.p1_eob_hist_plain(a[0], a[1].clone(), *a[2:])]
        else:
            got, want = tp1.p1_blocks(*a), tp1.p1_blocks_plain(*a)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            exact = exact and g.dtype == w.dtype and torch.equal(g, w)
            err = max(err, float((g.double() - w.double()).abs().max()))
    return [err, len(rec), exact]


if __name__ == "__main__":
    child(*sys.argv[1:6])
