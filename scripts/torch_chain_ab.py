"""The row-scan and p1 kernels, and the encode around them, in several
checkouts, one process each, in the order given (e.g. parent, change,
change, parent):

    python3 scripts/torch_chain_ab.py OLD_TREE NEW_TREE NEW_TREE OLD_TREE

Made to weigh a redesign of hand kernels against a tree with their
earlier design: csrc/trellis_rows.cu's trellis_dc_kernel and
eob_dp_kernel, csrc/p1.cu's p1_blocks_kernel and p1_eob_hist_kernel.
Each tree's process builds its own libraries, then on the seeded photos
of its chip_smoke.py gives: each kernel's device ms over the launches of
one 8x768x512 group (3) and of one 4032x3024 image (3), held and with
the host's launch gaps (CUDA events, chip_smoke.cuda_ms), and its first
(luma) launch held; the DC kernel's time a chain step (v * bw steps a
chain) and the EOB-run DP's a step (bw steps a row; its launches are
those of the same group and image encoded with trellis_eob_opt);
encode_many's MP/s over the phase-4 corpus (sixteen 768x512 and three
1021x683 photos, quality 75, median of 3 after a warm-up); and encode()
of the 4032x3024 photo at quality 75 (median of 3 after a warm-up), and
the trellis_eob_opt family's encode_many MP/s over the sixteen 768x512
photos. Uses only entry points that both designs have. Needs a CUDA
card; prints the card's name and power limit first.
"""
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor


def kernel_times(cs, recorded, reps):
    """The four kernels over a group's recorded launches: {name: {ms,
    ms_with_launch_gaps, first_launch_ms}} (the EOB-run histogram kernel
    adds into scratch histograms)."""
    import torch
    from mozjpeg_tpu_torch.ops import p1 as tp1
    from mozjpeg_tpu_torch.ops import trellis_rows as trw
    dcs, eobs = recorded["trellis_dc"], recorded["p1_eob_hist"]
    blocks, dps = recorded["p1_blocks"], recorded["trellis_eob"]
    scratch = [torch.zeros_like(a[1]) for a in eobs]
    fns = {"trellis_dc": (lambda: [trw.trellis_dc(*a) for a in dcs],
                          lambda: trw.trellis_dc(*dcs[0])),
           "p1_eob_hist": (lambda: [tp1.p1_eob_hist(a[0], h, *a[2:])
                                    for a, h in zip(eobs, scratch)],
                           lambda: tp1.p1_eob_hist(eobs[0][0], scratch[0],
                                                   *eobs[0][2:])),
           "p1_blocks": (lambda: [tp1.p1_blocks(*a) for a in blocks],
                         lambda: tp1.p1_blocks(*blocks[0])),
           "eob_dp": (lambda: [trw.eob_dp(*a) for a in dps],
                      lambda: trw.eob_dp(*dps[0]))}
    out = {}
    for name, (group, first) in fns.items():
        out[name] = {
            "ms": round(cs.cuda_ms(group, reps), 5),
            "ms_with_launch_gaps": round(cs.cuda_ms(group, reps,
                                                    hold=False), 5),
            "first_launch_ms": round(cs.cuda_ms(first, reps), 5)}
    a0 = dcs[0]
    steps = a0[6] * a0[0].shape[2]                  # v * bw
    out["trellis_dc"]["chain_steps"] = steps
    out["trellis_dc"]["us_a_step"] = round(
        out["trellis_dc"]["first_launch_ms"] * 1e3 / steps, 5)
    steps = dps[0][3]                               # bw
    out["eob_dp"]["chain_steps"] = steps
    out["eob_dp"]["us_a_step"] = round(
        out["eob_dp"]["first_launch_ms"] * 1e3 / steps, 5)
    return out


def run_tree():
    """This process's part: the measurements in the current directory's
    tree."""
    sys.path.insert(0, os.getcwd())
    import torch
    import chip_smoke as cs
    import mozjpeg_tpu_torch as mjt
    from mozjpeg_tpu_torch.codec import encoder
    from mozjpeg_tpu_torch.native import build as nbuild
    from mozjpeg_tpu_torch.ops import p1 as tp1
    from mozjpeg_tpu_torch.ops import tablegen, trellis_ac, trellis_rows
    with ThreadPoolExecutor(5) as ex:
        for f in [ex.submit(b) for b in (
                nbuild.build_native, trellis_ac.build, tablegen.build,
                trellis_rows.build, tp1.build)]:
            f.result()
    kodak = [cs.photo(512, 768, 100 + i) for i in range(16)]
    corpus = kodak + [cs.photo(683, 1021, 200 + i) for i in range(3)]
    big = cs.photo(3024, 4032, 1212)
    cfg = mjt.EncoderConfig(quality=75)
    cfg_eob = mjt.EncoderConfig(quality=75, trellis_eob_opt=True)
    dev = torch.device("cuda")
    res = {}

    def record(group):
        """One encode_group of `group` with its DC trellis and p1 launches
        recorded, then one with trellis_eob_opt for its EOB-run DP
        launches."""
        rec = {}

        def p1_rec(kind, args):
            if kind == "p1_eob_hist":
                args = (args[0], args[1].clone()) + tuple(args[2:])
            rec.setdefault(kind, []).append(args)
        tp1.RECORDERS.append(p1_rec)
        try:
            with ThreadPoolExecutor(8) as pool:
                ctx = encoder.resolve_group(group[0], cfg)
                for f in encoder.encode_group(group, ctx, dev, pool,
                                              record=rec):
                    f.result()
        finally:
            tp1.RECORDERS.remove(p1_rec)
        eob = {}
        with ThreadPoolExecutor(8) as pool:
            ctx = encoder.resolve_group(group[0], cfg_eob)
            for f in encoder.encode_group(group, ctx, dev, pool,
                                          record=eob):
                f.result()
        rec["trellis_eob"] = eob["trellis_eob"]
        torch.cuda.synchronize()
        return rec

    res["one 8x768x512 group"] = kernel_times(cs, record(kodak[:8]), 20)
    res["one 4032x3024 image"] = kernel_times(cs, record([big]), 10)

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

    mp = sum(im.shape[0] * im.shape[1] for im in corpus) / 1e6
    s, walls = median_s(lambda: mjt.encode_many(corpus, cfg))
    res["encode_many MP/s"] = round(mp / s, 3)
    res["encode_many MP/s reps"] = [round(mp / w, 3) for w in walls]
    s, walls = median_s(lambda: mjt.encode(big, cfg, device="cuda"))
    res["4032x3024 encode() s"] = round(s, 4)
    res["4032x3024 encode() s reps"] = [round(w, 4) for w in walls]
    mp = sum(im.shape[0] * im.shape[1] for im in kodak) / 1e6
    s, walls = median_s(lambda: mjt.encode_many(kodak, cfg_eob))
    res["trellis_eob_opt encode_many MP/s"] = round(mp / s, 3)
    res["trellis_eob_opt encode_many MP/s reps"] = [round(mp / w, 3)
                                                     for w in walls]
    print("chain A/B [%s]: %s" % (os.getcwd(), json.dumps(res)), flush=True)


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
