"""The PyTorch port's device scan search in several checkouts, one
process each, in the order given (e.g. parent, change, change, parent):

    python3 scripts/torch_search_ab.py OLD_TREE NEW_TREE NEW_TREE OLD_TREE

For one group of eight 768x512 photos and one 4032x3024 photo (the
seeded photos of the tree's chip_smoke.py), each tree's line gives the
wall time of three device searches (scanopt_dev.encode_batch_scans on
the same final coefficients), the peak memory above the coefficients,
and one sizes pass's kernels and device time (torch.profiler). Needs a
CUDA card; prints the card's name and power limit first.
"""
import os
import statistics
import subprocess
import sys
import time


def run_tree():
    """This process's part: the measurements in the current directory's
    tree."""
    sys.path.insert(0, os.getcwd())
    import torch
    import chip_smoke as cs
    import mozjpeg_tpu_torch as mjt
    from mozjpeg_tpu_torch.codec import encoder
    from mozjpeg_tpu_torch.codec import scanopt_dev as sd
    dev = torch.device("cuda")
    cfg = mjt.EncoderConfig(quality=75)
    cand = sd.get_candidates(3, 0)
    for label, imgs in (
            ("8x768x512", [cs.photo(512, 768, 100 + i) for i in range(8)]),
            ("4032x3024", [cs.photo(3024, 4032, 1212)])):
        ctx = encoder.resolve_group(imgs[0], cfg)
        p1 = encoder._batch_p1(imgs, ctx, dev)
        finals, _ = encoder._finals(p1, ctx, dev, len(imgs), loop_ris=False)
        walls = []
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(3):
            t0 = time.perf_counter()
            sd.encode_batch_scans([im.shape[1] for im in imgs],
                                  [im.shape[0] for im in imgs], p1[0],
                                  finals, ctx.qtables, ctx.cfg, 3, len(imgs))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        dms, nk, _ = cs.profiled(
            lambda: sd.sizes_pass(cand, finals, p1[0], len(imgs)), reps=1)
        print("search [%s] in %s: walls %s s, median %.4f s; peak %.1f MiB; "
              "sizes pass %d kernels, %.3f ms device time" % (
                  label, os.getcwd(), ", ".join("%.4f" % w for w in walls),
                  statistics.median(walls), peak, nk, dms), flush=True)


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
