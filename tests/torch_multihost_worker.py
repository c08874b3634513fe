"""Worker process of tests/test_torch_multihost.py (imports no JAX).

    python torch_multihost_worker.py <host:port> <nprocs> <rank> <entries>
        <device> <in.npz> <out_prefix> <mode> [<mode> ...]

Joins the process group (gloo for CPU entries), builds the global mesh of
<entries> entries of <device> per process, runs each mode's multi-process
encoder of mozjpeg_tpu_torch.parallel.multihost on the arrays of <in.npz>
(batch: "batch", one image: "image") and writes each result to
<out_prefix>.<mode>.<rank>.<i>.jpg. Mode "idle" encodes the npz's
"small" image, whose few iMCU rows leave the last process without a
shard, through the scan-search encoder.
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    coord, nprocs, rank, entries, device, inpath, outpref = sys.argv[1:8]
    modes = sys.argv[8:]
    nprocs, rank, entries = int(nprocs), int(rank), int(entries)

    import torch
    torch.set_num_threads(1)
    from mozjpeg_tpu_torch.parallel import multihost as mh

    data = np.load(inpath)
    devices = [device] * entries
    mh.init(coord, nprocs, rank, devices=devices)
    mesh = mh.global_mesh("rows", devices=devices)
    batch = data["batch"]
    bl = batch.shape[0] // nprocs
    local = batch[rank * bl:(rank + 1) * bl]
    img = data["image"]
    for mode in modes:
        if mode == "batch":
            outs = mh.encode_batch_multihost(local, 75.0,
                                             mesh=mh.global_mesh(
                                                 devices=devices))
        elif mode == "hostlocal":
            outs = mh.encode_batch_hostlocal(local, 75.0, device=device)
        elif mode == "idle":
            outs = [mh.encode_row_sharded_scanopt_multihost(
                data["small"], 75.0, restart_rows=1, mesh=mesh)]
        else:
            fn = {"rows": mh.encode_row_sharded_multihost,
                  "trellis": mh.encode_row_sharded_trellis_multihost,
                  "progressive": mh.encode_row_sharded_progressive_multihost,
                  "scanopt": mh.encode_row_sharded_scanopt_multihost}[mode]
            outs = [fn(img, 75.0, restart_rows=1, mesh=mesh)]
        for i, b in enumerate(outs):
            with open("%s.%s.%d.%d.jpg" % (outpref, mode, rank, i),
                      "wb") as f:
                f.write(b)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
