"""Entry points of a dry run: the single-device forward step, and the
multi-device encoders on a small mesh.

Port of the JAX package's __graft_entry__.py (entry and
dryrun_multichip). On one card, a mesh of several "cuda:0" entries runs
each shard on that card, with the same bytes as on as many cards.
"""
from __future__ import annotations

import numpy as np
import torch

from . import batch as pbatch
from . import rows as prows


def entry(device=None):
    """-> (fn, example_args): the device encode step of the main
    configuration for one 256x256 4:2:0 frame (colour conversion,
    downsampling, islow FDCT, quantization, zigzag, the iMCU layout):
    fn(rgb (1, H, W, 3) uint8 on the device, qluma, qchroma) -> per comp
    (1, bh_pad, bw_pad, 64) int16 planes."""
    from ..codec.config import EncoderConfig
    from ..codec.encoder import make_qtables
    from ..codec.pipeline import geometry

    dev = torch.device("cuda" if device is None else device)
    H, W = 256, 256
    geom = geometry(W, H, [(2, 2), (1, 1), (1, 1)])
    qt = make_qtables(EncoderConfig(quality=75).resolved())

    def fn(rgb, qluma, qchroma):
        return pbatch._single_image_planes(rgb, geom, qluma, qchroma)[0]

    rng = np.random.RandomState(0)
    rgb = torch.from_numpy(rng.randint(0, 256, (1, H, W, 3))
                           .astype(np.uint8)).to(dev)
    return fn, (rgb, qt[0], qt[1])


def dryrun_multichip(n_devices: int, device=None) -> None:
    """An n-entry mesh (the first n cards, or `device` n times), then one
    batched step (batch split + histogram sum) and the row-sharded
    baseline, trellis and full-default encoders on tiny shapes, each
    output with SOI and EOI."""
    from ..codec.config import EncoderConfig
    from ..codec.encoder import make_qtables

    if device is not None:
        devices = [torch.device(device)] * n_devices
    else:
        devices = list(pbatch.make_mesh().devices[:n_devices])
    if len(devices) != n_devices:
        raise RuntimeError("need %d devices, have %d"
                           % (n_devices, len(devices)))
    mesh = pbatch.make_mesh(devices)

    H, W = 32, 32
    step, _ = pbatch.make_batch_encode_step(
        mesh, H, W, [(2, 2), (1, 1), (1, 1)])
    qt = make_qtables(EncoderConfig(quality=75).resolved())
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (n_devices * 2, H, W, 3)).astype(np.uint8)
    planes, ac_hist, dc_hist = step(images, qt[0], qt[1])
    if (sum(p[0].shape[0] for p in planes.values()) != n_devices * 2
            or tuple(ac_hist.shape) != (2, 256)):
        raise RuntimeError("the batched step gave the wrong shapes")
    ac_hist.cpu()                       # wait for it

    # one image's iMCU rows over the same mesh: baseline, the full trellis
    # path, and the full mozjpeg default with the scan search
    img = rng.randint(0, 256, (n_devices * 16, 48, 3)).astype(np.uint8)
    for fn in (prows.encode_row_sharded, prows.encode_row_sharded_trellis,
               prows.encode_row_sharded_scanopt):
        data = fn(img, quality=75, mesh=pbatch.make_mesh(devices))
        if not (data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"):
            raise RuntimeError("%s: no SOI/EOI" % fn.__name__)
