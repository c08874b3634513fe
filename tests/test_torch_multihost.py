"""The port's multi-process encoders (mozjpeg_tpu_torch/parallel/
multihost.py) over torch.distributed, byte-exact against one process.

Spawns two real OS processes joined with gloo, four CPU mesh entries
each (one eight-entry global mesh), through tests/torch_multihost_worker.py
(which imports no JAX), and checks that

  * a batch split across both processes (the histogram sum crossing the
    process boundary) equals parallel.batch.encode_batch on one
    eight-entry mesh, image for image;
  * ONE image with an uneven height (a partial bottom iMCU row) row-
    sharded across both processes, through the baseline, trellis,
    progressive and full-default scan-search encoders, equals the one-
    process encoder on the eight-entry mesh, in both processes, and so
    does an image whose rows leave the second process without a shard;
  * the process-local corpus sharding (encode_batch_hostlocal) equals
    encode_many.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import mozjpeg_tpu_torch as mjt
from mozjpeg_tpu_torch.parallel import batch as pbatch
from mozjpeg_tpu_torch.parallel import rows as prows

NPROCS, ENTRIES = 2, 4
ROW_MODES = ("rows", "trellis", "progressive", "scanopt")
MODES = ("batch", "hostlocal", "idle") + ROW_MODES


def _photo(h, w, seed):
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([255 * xx / w, 255 * yy / h,
                    128 + 90 * np.sin((xx + 2 * yy) / 5.0)], -1)
    img[: h // 2, w // 2:] = r.uniform(0, 255, 3)
    img += r.normal(0, 9, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


BATCH = np.stack([_photo(32, 48, 40 + i) for i in range(8)])
IMAGE = _photo(121, 64, 50)          # 8 iMCU rows, the last one partial
SMALL = _photo(60, 40, 51)           # 4 iMCU rows: process 1 holds none


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def worker_outputs(tmp_path_factory):
    """Every mode's outputs of the two processes: {mode: [rank 0's list,
    rank 1's list]}."""
    tmp = tmp_path_factory.mktemp("mh")
    inpath = str(tmp / "in.npz")
    np.savez(inpath, batch=BATCH, image=IMAGE, small=SMALL)
    outpref = str(tmp / "out")
    coord = "127.0.0.1:%d" % _free_port()
    worker = os.path.join(os.path.dirname(__file__),
                          "torch_multihost_worker.py")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, worker, coord, str(NPROCS), str(r), str(ENTRIES),
         "cpu", inpath, outpref, *MODES], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for r in range(NPROCS)]
    for r, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, "rank %d failed:\n%s" % (
            r, err.decode()[-4000:])
    out = {}
    for mode in MODES:
        out[mode] = []
        for r in range(NPROCS):
            got, i = [], 0
            while os.path.exists("%s.%s.%d.%d.jpg" % (outpref, mode, r, i)):
                with open("%s.%s.%d.%d.jpg" % (outpref, mode, r, i),
                          "rb") as f:
                    got.append(f.read())
                i += 1
            out[mode].append(got)
    return out


def _mesh():
    return pbatch.make_mesh(["cpu"] * NPROCS * ENTRIES)


def test_batch_multihost(worker_outputs):
    """Four images a process, one an entry: the tables of the whole
    batch, each process's own images back."""
    got = worker_outputs["batch"][0] + worker_outputs["batch"][1]
    assert got == pbatch.encode_batch(BATCH, 75.0, _mesh())


def test_batch_hostlocal(worker_outputs):
    got = worker_outputs["hostlocal"][0] + worker_outputs["hostlocal"][1]
    assert got == mjt.encode_many(list(BATCH), mjt.EncoderConfig(quality=75),
                                  device="cpu")


@pytest.mark.parametrize("mode", ROW_MODES)
def test_rows_multihost(worker_outputs, mode):
    """Both processes return the one-process encoder's complete JPEG of
    the uneven-height image."""
    fn = {"rows": prows.encode_row_sharded,
          "trellis": prows.encode_row_sharded_trellis,
          "progressive": prows.encode_row_sharded_progressive,
          "scanopt": prows.encode_row_sharded_scanopt}[mode]
    want = fn(IMAGE, 75.0, _mesh(), restart_rows=1)
    assert worker_outputs[mode] == [[want], [want]]


def test_rows_multihost_process_without_shards(worker_outputs):
    """Four iMCU rows shrink the rows mesh to process 0's four entries;
    process 1 still joins every sum and byte gather and returns the same
    JPEG."""
    want = prows.encode_row_sharded_scanopt(SMALL, 75.0, _mesh(),
                                            restart_rows=1)
    assert prows._rows_mesh(_mesh(), 4).size == 4
    assert worker_outputs["idle"] == [[want], [want]]
