"""Multi-process (N >= 1 ranks) scale-out over torch.distributed.

Port of mozjpeg_tpu/parallel/multihost.py. N processes join one process
group (init), a global mesh spans every process's local devices in rank
order (global_mesh), and the sharded encoders of batch.py and rows.py
run over it: each process runs only its own shards, reading its band or
batch from the same host array, and the histogram sums cross processes
as an all_reduce in int64:

  * encode_batch_multihost: the image batch is split over the global
    mesh; each process passes and gets back only its own images, with
    the tables of the whole batch. Byte-identical to batch.encode_batch
    in one process.
  * encode_row_sharded_multihost and the trellis, progressive and
    scan-search encoders: ONE image's iMCU rows over every device of
    every process; each process packs its shards' restart segments, the
    segments are all-gathered as bytes, and every process returns the
    identical complete JPEG. Byte-identical to rows.py in one process.

The sums run on the rank's card over NCCL where every rank's devices
are cards and no two ranks share one, else on the CPU over gloo (the
CPU tests, and ranks that share a card); the bytes always cross on the
CPU over gloo.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import batch as _batch
from . import rows as _rows
from ..codec.pipeline import geometry


def init(coordinator_address: str, num_processes: int, process_id: int,
         devices=None):
    """Join this process to the process group (idempotent).

    coordinator_address: "host:port" of process 0. devices: this
    process's local devices (default: every visible card). Where they
    are cards the group has NCCL for card tensors beside gloo for CPU
    ones, else gloo alone."""
    if dist.is_initialized():
        if dist.get_world_size() != num_processes:
            raise RuntimeError("already in a group of %d processes, not %d"
                               % (dist.get_world_size(), num_processes))
        return
    local = _batch.make_mesh(devices).devices
    backend = ("cpu:gloo,cuda:nccl"
               if all(d.type == "cuda" for d in local)
               and dist.is_nccl_available() else "gloo")
    dist.init_process_group(backend, init_method="tcp://"
                            + coordinator_address,
                            world_size=num_processes, rank=process_id)


def _card_id(d: torch.device) -> str:
    return (str(torch.cuda.get_device_properties(d).uuid)
            if d.type == "cuda" else "cpu")


def global_mesh(axis: str = "batch", devices=None) -> _batch.Mesh:
    """The 1-D mesh over every device of every process, in rank order
    (devices: this process's, default every visible card). Its sums run
    on this rank's first card where every rank's devices are cards, the
    group has NCCL and no two ranks share a card; else on the CPU."""
    local = _batch.make_mesh(devices).devices
    rank, world = dist.get_rank(), dist.get_world_size()
    mine = ([str(d) for d in local], sorted({_card_id(d) for d in local}))
    every: list = [None] * world
    dist.all_gather_object(every, mine)
    devs, ranks, seen = [], [], []
    for r, (names, ids) in enumerate(every):
        devs += names
        ranks += [r] * len(names)
        seen += ids
    cards = all(n.startswith("cuda") for names, _ in every for n in names)
    nccl = cards and "nccl" in str(dist.get_backend())
    reduce_device = (local[0] if nccl and len(seen) == len(set(seen))
                     else torch.device("cpu"))
    return _batch.Mesh(devs, axis, ranks, rank, reduce_device)


def encode_batch_multihost(local_images: np.ndarray, quality: float = 75.0,
                           restart_interval: int = 0,
                           mesh: Optional[_batch.Mesh] = None
                           ) -> List[bytes]:
    """Encode a batch split over every process; each passes ITS images.

    local_images: (B_local, H, W, 3) uint8, this process's images. The
    global batch is the rank-order concatenation and must split evenly
    over the mesh. Returns the JPEG bytes of the LOCAL images,
    byte-identical to batch.encode_batch on the whole batch."""
    mesh = mesh or global_mesh()
    bl, h, w, _ = local_images.shape
    cfg, qt, samp = _batch._batch_config(quality)
    step, _ = _batch.make_batch_encode_step(mesh, h, w, samp)
    planes, ac_g, dc_g = step(local_images, qt[0], qt[1],
                              first=dist.get_rank() * bl,
                              total=bl * dist.get_world_size())
    dc_tables, ac_tables = _batch._shared_tables(ac_g, dc_g)
    return _batch._emit_batch(planes, geometry(w, h, samp), qt, dc_tables,
                              ac_tables, restart_interval, False, w, h)


def _mh_reduce_sum(a, mesh: _batch.Mesh):
    """Elementwise sum of a process-local int array over every process,
    in int64 on the mesh's reduce device."""
    t = torch.as_tensor(np.asarray(a, np.int64)).to(mesh.reduce_device)
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t.cpu().numpy()


def _mh_sum_scalar(v, mesh: _batch.Mesh) -> int:
    return int(_mh_reduce_sum(np.asarray([v], np.int64), mesh)[0])


def _mh_collect_bytes(parts, nshards: int) -> bytes:
    """Concatenate the per-shard byte strings held across processes, in
    global shard order: lengths and zero-padded payloads all-gathered on
    the CPU."""
    world = dist.get_world_size()
    lens = torch.zeros(nshards, dtype=torch.int64)
    for s, b in parts.items():
        lens[s] = len(b)
    all_lens = [torch.zeros_like(lens) for _ in range(world)]
    dist.all_gather(all_lens, lens)
    lens = torch.stack(all_lens).amax(0)
    payload = torch.zeros((nshards, max(int(lens.max()), 1)),
                          dtype=torch.uint8)
    for s, b in parts.items():
        payload[s, :len(b)] = torch.frombuffer(bytearray(b), dtype=torch.uint8)
    every = [torch.zeros_like(payload) for _ in range(world)]
    dist.all_gather(every, payload)
    payload = torch.stack(every).amax(0).numpy()
    return b"".join(payload[s, :int(lens[s])].tobytes()
                    for s in range(nshards))


def encode_row_sharded_multihost(image: np.ndarray, quality: float = 75.0,
                                 restart_rows: int = 1,
                                 subsampling: Tuple[int, int] = (2, 2),
                                 mesh: Optional[_batch.Mesh] = None
                                 ) -> bytes:
    """Encode ONE image with its iMCU rows sharded across every process.

    Every process passes the SAME full image and reads its bands from it.
    Row bands that do not divide evenly are handled as in one process
    (the rows mesh shrinks to a dividing device count). Each process
    packs its shards' restart segments; the bytes are all-gathered so
    every process returns the identical complete JPEG, byte-identical to
    rows.encode_row_sharded in one process."""
    h, w = image.shape[:2]
    (ndev, rps, geom, qt, ncomp, planes, ac_g,
     dc_g) = _rows._baseline_front(image, quality, mesh or global_mesh(
         "rows"), restart_rows, subsampling)
    return _rows._sequential(
        w, h, geom, qt, ncomp, planes, ac_g, dc_g, ndev, rps, restart_rows,
        False, _mh_collect_bytes)


def _mh_front(image, quality, mesh, restart_rows, subsampling):
    """The sharded trellis front on a global mesh, and the scan codec of
    THIS process's shards with the cross-process sum."""
    (cfg, qt, ncomp, mesh, rps, geom,
     planes) = _rows._trellis_front(image, quality,
                                    mesh or global_mesh("rows"),
                                    restart_rows, subsampling,
                                    progressive=True)
    codec = _rows._ShardScanCodec(
        cfg, ncomp, mesh.size, rps, geom, planes,
        reduce_sum=functools.partial(_mh_reduce_sum, mesh=mesh))
    return cfg, qt, ncomp, mesh, rps, geom, codec


def encode_batch_hostlocal(local_images, quality: float = 75.0,
                           device=None, **overrides) -> List[bytes]:
    """Process-LOCAL corpus sharding with a completion barrier, NOT a
    cross-process encode: every process passes ITS images and gets their
    bytes back through the local encode_many (the full mozjpeg default,
    on `device`), and the only cross-process traffic is the barrier.
    Per-image encoding is independent, so this is the deployment shape
    for corpus jobs; one image's rows over every process's devices is
    encode_row_sharded_scanopt_multihost."""
    from ..codec.config import EncoderConfig
    from ..codec.encoder import encode_many
    outs = encode_many(list(local_images),
                       EncoderConfig(quality=quality, **overrides),
                       device=device)
    dist.barrier()
    return outs


def encode_row_sharded_scanopt_multihost(
        image: np.ndarray, quality: float = 75.0, restart_rows: int = 1,
        subsampling: Tuple[int, int] = (2, 2),
        mesh: Optional[_batch.Mesh] = None) -> bytes:
    """FULL mozjpeg-default encode (progressive + trellis + deringing +
    optimize_scans) of ONE image, iMCU rows sharded over every device of
    every process. Every process passes the same image and returns the
    same complete JPEG."""
    h, w = image.shape[:2]
    cfg, qt, ncomp, mesh, rps, geom, codec = _mh_front(
        image, quality, mesh, restart_rows, subsampling)
    return _rows._scanopt_rows(
        cfg, qt, ncomp, mesh.size, rps, geom, codec, w, h,
        sum_scalar=functools.partial(_mh_sum_scalar, mesh=mesh),
        collect_bytes=_mh_collect_bytes)


def encode_row_sharded_progressive_multihost(
        image: np.ndarray, quality: float = 75.0, restart_rows: int = 1,
        subsampling: Tuple[int, int] = (2, 2),
        mesh: Optional[_batch.Mesh] = None) -> bytes:
    """Progressive + trellis (mozjpeg -fastcrush -restart N) of ONE
    image, rows sharded over every process."""
    h, w = image.shape[:2]
    cfg, qt, ncomp, mesh, rps, geom, codec = _mh_front(
        image, quality, mesh, restart_rows, subsampling)
    return _rows._progressive_rows(
        cfg, qt, ncomp, geom, codec, w, h,
        collect_bytes=_mh_collect_bytes)


def encode_row_sharded_trellis_multihost(
        image: np.ndarray, quality: float = 75.0, restart_rows: int = 1,
        subsampling: Tuple[int, int] = (2, 2),
        mesh: Optional[_batch.Mesh] = None) -> bytes:
    """Sequential-scan trellis encode of ONE image, rows sharded over
    every process (global summed statistics + per-shard device
    bit-pack)."""
    return _rows._trellis_sequential(
        image, quality, mesh or global_mesh("rows"), restart_rows,
        subsampling, collect_bytes=_mh_collect_bytes)


# the JAX package's former name, kept as an alias
encode_batch_multihost_default = encode_batch_hostlocal
