"""End-to-end encode times of the PyTorch port in several checkouts, one
process each, in the order given (e.g. parent, change, change, parent):

    python3 scripts/torch_p1_ab.py OLD_TREE NEW_TREE NEW_TREE OLD_TREE

Made to weigh p1's kernels (csrc/p1.cu) end to end against a tree
without them. Each tree's process builds its own libraries, then on the
seeded photos of its chip_smoke.py gives: encode_many's MP/s over the
phase-4 corpus (sixteen 768x512 and three 1021x683 photos, quality 75,
the default) and over phase 11's eight 12-bit 768x512 photos (median of
3 after a warm-up each), the synchronised stage times of one 8x768x512
group at 8 and at 12 bits, and encode() of one 4032x3024 photo at
cjpeg's configuration (median of 3 after a warm-up). Needs a CUDA card;
prints the card's name and power limit first.
"""
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def run_tree():
    """This process's part: the measurements in the current directory's
    tree."""
    sys.path.insert(0, os.getcwd())
    import torch
    import chip_smoke as cs
    import mozjpeg_tpu_torch as mjt
    from mozjpeg_tpu_torch.cli import cjpeg
    from mozjpeg_tpu_torch.codec import encoder
    from mozjpeg_tpu_torch.native import build as nbuild
    builds = [nbuild.build_native]
    for name in ("trellis_ac", "tablegen", "trellis_rows", "p1"):
        if importlib.util.find_spec("mozjpeg_tpu_torch.ops." + name):
            builds.append(importlib.import_module(
                "mozjpeg_tpu_torch.ops." + name).build)
    with ThreadPoolExecutor(len(builds)) as ex:
        for f in [ex.submit(b) for b in builds]:
            f.result()
    kodak = [cs.photo(512, 768, 100 + i) for i in range(16)]
    corpus = kodak + [cs.photo(683, 1021, 200 + i) for i in range(3)]
    rng = np.random.default_rng(1200)
    corpus12 = []
    for i in range(8):
        hi = cs.photo(512, 768, 1200 + i).astype(np.uint16) << 4
        corpus12.append(hi | rng.integers(0, 16, hi.shape, dtype=np.uint16))
    dev = torch.device("cuda")
    res = {}

    def median_s(fn):
        fn()
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return statistics.median(walls), walls

    for name, imgs, cfg in (
            ("8-bit default", corpus, mjt.EncoderConfig(quality=75)),
            ("12-bit default", corpus12,
             mjt.EncoderConfig(quality=75, precision=12))):
        mp = sum(im.shape[0] * im.shape[1] for im in imgs) / 1e6
        s, walls = median_s(lambda: mjt.encode_many(imgs, cfg))
        res[name + " MP/s"] = round(mp / s, 3)
        res[name + " MP/s reps"] = [round(mp / w, 3) for w in walls]
        group = imgs[:8]
        ctx = encoder.resolve_group(group[0], cfg)
        times = {}
        with ThreadPoolExecutor(8) as pool:
            for f in encoder.encode_group(group, ctx, dev, pool,
                                          times=times):
                f.result()
        res["%s stages of one 8x768x512 group (ms)" % name] = {
            k: round(v * 1e3, 3) for k, v in times.items()}
    big = cs.photo(3024, 4032, 1212)
    cfg_cj = cjpeg.config_from_args(cjpeg.build_parser().parse_args([]))
    s, walls = median_s(lambda: mjt.encode(big, cfg_cj, device="cuda"))
    res["4032x3024 encode() s"] = round(s, 4)
    res["4032x3024 encode() s reps"] = [round(w, 4) for w in walls]
    print("p1 A/B [%s]: %s" % (os.getcwd(), json.dumps(res)), flush=True)


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "--here":
        run_tree()
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    me = os.path.abspath(__file__)
    for tree in sys.argv[1:]:
        subprocess.run([sys.executable, me, "--here"], cwd=tree, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
