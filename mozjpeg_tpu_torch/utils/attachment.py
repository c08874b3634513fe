"""Attachment probe: how fast does the card hand data back to the host?

Port of mozjpeg_tpu/utils/attachment.py. The device engines (the scan
search of codec/scanopt_dev.py and the bit packers of ops/bitpack.py)
trade device work for host work and transfers. The JAX package turns
them on for a TPU that answers a 4 MB read-back in under 20 ms (a
"local" attachment) and off elsewhere. EncoderConfig's `deployment`
resolves through deployment_local():

  local  -> the device engines on
  remote -> off
  auto   -> MJ_DEPLOYMENT ("local" or "remote") where it is set, else
            off: the JAX package's probe answers "local" only for a TPU,
            and the port keeps that answer until the host-versus-card
            crossover measured on the H100 (chip_smoke.py phase 13,
            ROADMAP.md) calls for the engines.

sync_latency_ms() is the probe's measurement, kept for that crossover.

is_local(dev) is the counterpart of the JAX is_local_tpu, which routes
decode_many: MJ_DEPLOYMENT "local" or "remote" where it is set, else
True for a CUDA device (the card sits on PCIe, the port's reading of a
local attachment) and False for the CPU, which takes the JAX package's
route for a device that is not a local TPU (the host render, or the
packed coefficient route).
"""
from __future__ import annotations

import functools
import os
import time


@functools.lru_cache(maxsize=4)
def sync_latency_ms(device: str = "cuda") -> float:
    """Best of 2 device-to-host copies of a fresh 4 MB tensor, in ms;
    infinity where the device is absent. A bandwidth-sized probe: a tiny
    read-back answers fast over any link."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        return float("inf")
    best = float("inf")
    for i in range(2):
        d = torch.zeros(1 << 20, dtype=torch.int32, device=dev) + i
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        d.cpu()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def deployment_local(deployment: str = "auto") -> bool:
    """Whether `deployment` turns the device engines on (see above)."""
    d = (deployment or "auto").lower()
    if d == "auto":
        d = os.environ.get("MJ_DEPLOYMENT", "").lower()
    return d == "local"


def is_local(dev) -> bool:
    """Whether decode_many treats `dev` as a locally attached device
    (see above)."""
    env = os.environ.get("MJ_DEPLOYMENT", "").lower()
    if env == "local":
        return True
    if env == "remote":
        return False
    import torch
    return torch.device(dev).type == "cuda"
