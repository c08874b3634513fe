"""The Annex-K tablegen kernel's builds side by side on one card:

    python3 scripts/torch_tablegen_ab.py [OLD_TREE ...]

builds this tree's mozjpeg_tpu_torch/csrc/tablegen.cu as it is
(`default`) and with one warp a block (`-DTG_WARPS=1`), and each
OLD_TREE's tablegen.cu as it is (the same C entry, mj_tablegen), one
nvcc each, all started together, into mozjpeg_tpu_torch/_build/ab/.
Every build is held exactly against gen_optimal_tables_plain (bits,
values, ok, code lengths) on the inputs below, then timed held (CUDA
events behind a sleep kernel, the queue full) in turns, builds in the
order above and then reversed:

- the trellis route's call of one group of eight seeded 768x512 photos
  (T = 24, chip_smoke.py's photos and configuration);
- that group's sizes pass of the device scan search (T = 1,136);
- chip_smoke.adversarial_freqs();
- the step sweep: T = 24 seeded tables with n = 2, 17, 65, 129, 193 and
  257 present symbols (the pseudo-symbol one of them), counts 1-4,999;
  a table of n makes n - 1 merges, so the slope of the held time over
  n - 1 (least squares) is the time a merge step;
- then each adversarial table alone (T = 1), with its present symbols,
  its live sum and the key path that sum takes (32-bit below 2^23), so
  that the 64-bit path's steps and the length limiting show apart.

Needs a CUDA card; prints the card's name and power limit first, and
each build's ptxas report.
"""
import ctypes
import os
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def builds(trees):
    """[(label, source, extra nvcc flags)] in timing order."""
    src = os.path.join(ROOT, "mozjpeg_tpu_torch", "csrc", "tablegen.cu")
    out = [("default", src, []), ("TG_WARPS=1", src, ["-DTG_WARPS=1"])]
    for i, tree in enumerate(trees):
        out.append(("tree %d %s" % (i, tree), os.path.join(
            os.path.abspath(tree), "mozjpeg_tpu_torch", "csrc",
            "tablegen.cu"), []))
    return out


def build_all(specs):
    """nvcc for every spec at once -> [(ctypes library, ptxas lines)]."""
    from mozjpeg_tpu_torch.ops.trellis_ac import nvcc_command
    ab = os.path.join(ROOT, "mozjpeg_tpu_torch", "_build", "ab")
    os.makedirs(ab, exist_ok=True)

    def one(i):
        label, src, flags = specs[i]
        so = os.path.join(ab, "libtablegen_%d.so" % i)
        cmd = nvcc_command([src], so)
        r = subprocess.run(cmd[:1] + flags + cmd[1:], capture_output=True,
                           text=True)
        if r.returncode:
            raise SystemExit("build %s failed:\n%s" % (label, r.stderr))
        lib = ctypes.CDLL(so)
        vp = ctypes.c_void_p
        lib.mj_tablegen.restype = ctypes.c_int
        lib.mj_tablegen.argtypes = [vp, ctypes.c_int, vp, vp, vp, vp, vp]
        return lib, [ln.strip() for ln in (r.stdout + r.stderr).splitlines()
                     if "registers" in ln or "spill" in ln]

    with ThreadPoolExecutor(len(specs)) as ex:
        return list(ex.map(one, range(len(specs))))


def launch(lib, f):
    """One launch of a build on (T, 257) counts f -> (bits, vals, ok, si),
    as ops/tablegen.gen_optimal_tables(f, sizes=True) gives them."""
    import torch
    t, dev = f.shape[0], f.device
    bits = torch.empty((t, 17), dtype=torch.int32, device=dev)
    vals = torch.empty((t, 256), dtype=torch.int32, device=dev)
    ok = torch.empty((t,), dtype=torch.bool, device=dev)
    si = torch.empty((t, 256), dtype=torch.int32, device=dev)
    rc = lib.mj_tablegen(f.data_ptr(), t, bits.data_ptr(), vals.data_ptr(),
                         ok.data_ptr(), si.data_ptr(),
                         torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise SystemExit("launch failed: CUDA error %d" % rc)
    return bits, vals, ok, si


def inputs(dev):
    """[(label, (T, 257) int32 counts on dev)]."""
    import torch
    import chip_smoke as cs
    import mozjpeg_tpu_torch as mjt
    from mozjpeg_tpu_torch.codec import encoder
    from mozjpeg_tpu_torch.codec import scanopt_dev as sd
    group = [cs.photo(512, 768, 100 + i) for i in range(8)]
    ctx = encoder.resolve_group(group[0], mjt.EncoderConfig(quality=75))
    rec = {}
    with ThreadPoolExecutor(8) as pool:
        for fut in encoder.encode_group(group, ctx, dev, pool, record=rec):
            fut.result()
    p1 = encoder._batch_p1(group, ctx, dev)
    finals, _ = encoder._finals(p1, ctx, dev, 8, loop_ris=False)
    sizes = torch.nn.functional.pad(sd._Pass(
        sd.get_candidates(3, 0), finals, p1[0], 8).histograms().to(
            torch.int32), (0, 1))
    out = [("trellis route", rec["tablegen"][0]),
           ("sizes pass", sizes),
           ("adversarial", torch.as_tensor(cs.adversarial_freqs(),
                                           device=dev))]
    out += [("sweep n=%d" % n, torch.as_tensor(cs.sweep_freqs(n),
                                               device=dev))
            for n in cs.SWEEP_N]
    return out


def main():
    import torch
    import chip_smoke as cs
    from mozjpeg_tpu_torch.ops import tablegen as tg
    if not torch.cuda.is_available():
        print("torch_tablegen_ab: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    specs = builds(sys.argv[1:])
    libs = build_all(specs)
    for (label, _, _), (_, rep) in zip(specs, libs):
        for ln in rep:
            print("build [%s]: %s" % (label, ln), flush=True)
    data = inputs(dev)
    for name, f in data:
        bits, vals, ok = tg.gen_optimal_tables_plain(f)
        want = (bits, vals, ok, tg.derive_codes(bits, vals)[1])
        for (label, _, _), (lib, _) in zip(specs, libs):
            got = launch(lib, f)
            torch.cuda.synchronize()
            exact = all(torch.equal(a, b) for a, b in zip(got, want))
            print("exact [%s] on %s (T=%d): %s" % (label, name, f.shape[0],
                                                   exact), flush=True)
    times = {}
    order = list(range(len(specs)))
    for i in order + order[::-1]:
        lib = libs[i][0]
        for name, f in data:
            times.setdefault((i, name), []).append(
                cs.cuda_ms(lambda: launch(lib, f), 20))
    for i, (label, _, _) in enumerate(specs):
        for name, _ in data:
            ms = times[(i, name)]
            print("held ms [%s] %s: %s (mean %.5f); %s" % (
                label, name, ", ".join("%.5f" % v for v in ms),
                statistics.fmean(ms), smi), flush=True)
        x = np.array([n - 1 for n in cs.SWEEP_N], np.float64)
        y = np.array([statistics.fmean(times[(i, "sweep n=%d" % n)])
                      for n in cs.SWEEP_N])
        slope, icept = np.polyfit(x, y, 1)
        print("step sweep [%s]: %.3f us a merge step, %.4f ms at 0 merges"
              % (label, slope * 1e3, icept), flush=True)
    adv = dict(data)["adversarial"]
    for r in range(adv.shape[0]):
        f = adv[r:r + 1].contiguous()
        row = f[0].long()
        live = int(torch.where((row > 0) & (row < tg.BIG), row, 0).sum()) + 1
        ms = [cs.cuda_ms(lambda: launch(lib, f), 20) for lib, _ in libs]
        print("adversarial table %d alone: %d present, live sum %d (%s "
              "keys); held ms %s" % (
                  r, int((row[:256] > 0).sum()) + 1, live,
                  "32-bit" if live < tg.PACKED_BELOW else "64-bit",
                  ", ".join("[%s] %.5f" % (lb, m) for (lb, _, _), m in
                            zip(specs, ms))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
