"""Multi-device batched encoding over a mesh of devices.

Port of mozjpeg_tpu/parallel/batch.py. The image batch is split over the
mesh's entries, every entry runs the device pipeline (colour
conversion, downsampling, islow FDCT, quantization) on its images, and
the per-scan symbol histograms are summed over the entries (the JAX
psum), so one optimal Huffman table set covers the whole batch: the
distributed analog of the reference's dc_counts / ac_counts gather
(jchuff.c:100-101). The host then emits each image's bitstream with the
shared tables, or packs it on the device (device_entropy).

A Mesh is an ordered tuple of devices. Entries may repeat: the CPU
tests run eight "cpu" entries, as the JAX tests run eight virtual CPU
devices, and one card can hold several entries ("cuda:0" four times),
each a shard of its own with the same results as on four cards. Shards
run stage by stage (every shard's first stage, the sum, every shard's
second stage), so that the launches of different cards can overlap; a
shard's stage does not wait for its device.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..codec import pipeline_t
from ..codec.pipeline import geometry
from ..ops import symbols


def device_count(dev: torch.device) -> int:
    """The devices of dev's kind this process can shard over: the
    visible cards for cuda, one for the CPU."""
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def local_devices(dev: torch.device) -> List[torch.device]:
    """The entries of a default mesh on dev's kind: cuda:0 .. cuda:n-1,
    or the CPU device_count(dev) times."""
    n = device_count(dev)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(n)]
    return [dev] * n


class Mesh:
    """A 1-D mesh: devices, the entries in shard order, along `axis`.

    Across processes (multihost.global_mesh) the devices are every
    process's entries in rank order, ranks gives each entry's process and
    reduce_device is where this process's partial sums meet the others'
    in an all_reduce; in one process every entry is local and
    reduce_device is None."""

    def __init__(self, devices: Sequence, axis: str = "batch",
                 ranks: Optional[Sequence[int]] = None, rank: int = 0,
                 reduce_device: Optional[torch.device] = None):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis = axis
        self.rank = rank
        self.ranks = (tuple(ranks) if ranks is not None
                      else (rank,) * len(self.devices))
        self.reduce_device = reduce_device

    @property
    def size(self) -> int:
        return len(self.devices)

    def take(self, n: int, axis: Optional[str] = None) -> "Mesh":
        """The mesh of the first n entries (the others stay idle)."""
        return Mesh(self.devices[:n], axis or self.axis, self.ranks[:n],
                    self.rank, self.reduce_device)

    def local(self) -> List[int]:
        """The shard indices this process runs."""
        return [s for s, r in enumerate(self.ranks) if r == self.rank]

    def psum(self, parts: Dict[int, torch.Tensor], shape) -> torch.Tensor:
        """The sum over every shard of the mesh of the integer tensors
        parts {local shard: tensor of `shape`}: gathered on the first
        local shard's device in shard order and summed there in int64,
        then, across processes, all-reduced (a process without shards
        adds zeros). Every shard reads this one total."""
        total = None
        for s in sorted(parts):
            p = parts[s].to(self.devices[min(parts)], torch.int64)
            total = p if total is None else total + p
        if self.reduce_device is None:
            return total
        if total is None:
            total = torch.zeros(shape, dtype=torch.int64)
        total = total.to(self.reduce_device)
        dist.all_reduce(total, op=dist.ReduceOp.SUM)
        return total


def make_mesh(devices=None, axis: str = "batch") -> Mesh:
    """A mesh of `devices` (default: every visible card)."""
    if devices is None:
        devices = local_devices(torch.device("cuda"))
    return Mesh(devices, axis)


def _single_image_planes(images: torch.Tensor, geom, qluma, qchroma):
    """The device pipeline for a shard's images (B, H, W, 3) uint8 ->
    (per comp (B, bh_pad, bw_pad, 64) int16 planes with the iMCU dummy
    blocks, ac_hist (2, 256), dc_hist (2, 256) int32 summed over the
    images), the JAX _encode_planes_420 under vmap."""
    mcus_x, mcus_y, comps = geom
    b = images.shape[0]
    planes = pipeline_t.prep_planes(images, geom, "ycbcr")
    qs = [pipeline_t.quantize_comp(p, g, qluma if ci == 0 else qchroma,
                                   False)[0].to(torch.int16)
          for ci, (p, g) in enumerate(zip(planes, comps))]
    q = pipeline_t.planes_t(qs, geom, b)
    ac_h = torch.zeros((2, 256), dtype=torch.int32, device=images.device)
    dc_h = torch.zeros_like(ac_h)
    for ci, g in enumerate(comps):
        slot = 0 if ci == 0 else 1
        ac_h[slot] += symbols.ac_histogram(q[ci].reshape(-1, 64))
        dc_h[slot] += symbols.dc_histogram_interleaved(
            q[ci], g.h, g.v, mcus_x, mcus_y)
    return q, ac_h, dc_h


def make_batch_encode_step(mesh: Mesh, height: int, width: int,
                           samp: List[Tuple[int, int]]):
    """The multi-device step: (B, H, W, 3) uint8 images split over the
    mesh -> ({shard: per comp (B / n, bh_pad, bw_pad, 64) int16 planes
    on its device}, global (2, 256) AC and DC histograms, int64).

    step(images, qluma, qchroma, first=0, total=None): images are the
    batch's images first, first + 1, ... of `total` (default: all of
    them; in a multi-process batch, this process's); each local shard
    takes its total / n. The histogram sum over the shards is what lets
    every process emit bitstreams with the same shared Huffman tables."""
    geom = geometry(width, height, samp)

    def step(images, qluma, qchroma, first: int = 0, total=None):
        total = len(images) if total is None else total
        if total % mesh.size:
            raise ValueError("a batch of %d does not split over %d shards"
                             % (total, mesh.size))
        per = total // mesh.size
        planes, ac, dc = {}, {}, {}
        for s in mesh.local():
            lo = s * per - first
            if not 0 <= lo <= len(images) - per:
                raise ValueError("shard %d's images are not this "
                                 "process's" % s)
            imgs = torch.from_numpy(np.ascontiguousarray(
                images[lo:lo + per])).to(mesh.devices[s])
            planes[s], ac[s], dc[s] = _single_image_planes(
                imgs, geom, qluma, qchroma)
        return planes, mesh.psum(ac, (2, 256)), mesh.psum(dc, (2, 256))

    return step, geom[2]


def _shared_tables(ac_g, dc_g, nt: int = 2):
    """Optimal tables from the global histograms -> (dc_tables,
    ac_tables) {slot: HuffTable}."""
    from ..entropy.encode import gen_optimal_table

    def mk(counts):
        f = np.zeros(257, np.int64)
        f[:256] = np.asarray(counts)
        return gen_optimal_table(f)

    ac_g = ac_g.cpu().numpy()
    dc_g = dc_g.cpu().numpy()
    return ({t: mk(dc_g[t]) for t in range(nt)},
            {t: mk(ac_g[t]) for t in range(nt)})


def _emit_batch(planes, geom, qt, dc_tables, ac_tables,
                restart_interval: int, device_entropy: bool, w: int,
                h: int) -> List[bytes]:
    """Each image of the shards of `planes`, in order, with the shared
    tables: its baseline scan on the host (the native coder) or packed
    on the device (ops/bitpack.encode_scan_bitpar, restart-parallel),
    and its markers."""
    from ..codec.encoder import ScanResult, assemble
    from ..codec.scans import baseline_script
    from ..entropy import encode as entenc
    from ..entropy.huffman import derive_codes
    from ..ops import bitpack

    mcus_x, mcus_y, comps = geom
    tbls = {0: 0, 1: 1, 2: 1}
    scan = baseline_script(3)[0]
    ri = restart_interval
    codes = {k: derive_codes(t) for k, t in dc_tables.items()}
    acodes = {k: derive_codes(t) for k, t in ac_tables.items()}
    out = []
    for s in sorted(planes):
        host = None if device_entropy else [p.cpu().numpy()
                                            for p in planes[s]]
        for i in range(planes[s][0].shape[0]):
            if device_entropy:
                data = bitpack.encode_scan_bitpar(
                    [planes[s][ci][i] for ci in range(3)],
                    [(g.h, g.v) for g in comps], mcus_x, mcus_y, ri,
                    [codes[tbls[ci]] for ci in range(3)],
                    [acodes[tbls[ci]] for ci in range(3)])
            else:
                sg = entenc.ScanGeometry(scan, geom,
                                         [host[ci][i] for ci in range(3)])
                data, _, _ = entenc.encode_scan(sg, tbls, tbls, dc_tables,
                                                ac_tables, ri)
            sr = ScanResult(scan, data, dc_tables, ac_tables, tbls, tbls,
                            ri)
            out.append(assemble(w, h, geom, qt, [sr], False, 3,
                                multi_dqt=False))
    return out


def _batch_config(quality: float):
    """The batch encoders' configuration: FASTEST, sequential, optimal
    tables, no trellis, no deringing -> (cfg, qtables, samp)."""
    from ..codec.config import EncoderConfig, Profile
    from ..codec.encoder import make_qtables
    cfg = EncoderConfig(quality=quality, profile=Profile.FASTEST,
                        progressive=False, optimize_coding=True,
                        optimize_scans=False, trellis_quant=False,
                        overshoot_deringing=False).resolved()
    return cfg, make_qtables(cfg), [cfg.subsampling, (1, 1), (1, 1)]


def encode_batch(images: np.ndarray, quality: float = 75.0,
                 mesh: Mesh = None, restart_interval: int = 0,
                 device_entropy: bool = False) -> List[bytes]:
    """Encode a batch of same-shape RGB images (B, H, W, 3) uint8 with
    shared optimal tables, split over the mesh (default: every visible
    card). Returns per-image baseline JPEG bytes.

    device_entropy=True packs every image's bitstream on its shard's
    device with the restart-parallel packer (ops/bitpack.py): each
    restart segment is an independent bit stream packed in parallel, the
    host only stitches."""
    mesh = mesh or make_mesh()
    b, h, w, _ = images.shape
    cfg, qt, samp = _batch_config(quality)
    step, _ = make_batch_encode_step(mesh, h, w, samp)
    geom = geometry(w, h, samp)
    planes, ac_g, dc_g = step(images, qt[0], qt[1])
    dc_tables, ac_tables = _shared_tables(ac_g, dc_g)
    return _emit_batch(planes, geom, qt, dc_tables, ac_tables,
                       restart_interval, device_entropy, w, h)
