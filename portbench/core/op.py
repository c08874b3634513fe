"""What every traffic mix's operation shares: the suite, the pool, the
answers of the window and the sample of them the reference checks.

A traffic file (traffic/<name>.json) names its operation under "op":
ops/<op>.py, whose class Op (a subclass of Base) makes the calls and
checks them, so a new operation is a new file. The keys every
operation reads:
  pool_mp, pool_suites_min
                the pool: as many distinct suites (the images of one
                call, from the configuration) as hold pool_mp
                megapixels, and at least pool_suites_min (2 or more, so
                that no call repeats the one before it), made in set-up
                and cycled;
  warm_calls    calls made in set-up before the window;
  check_images  answers the reference checks in full after the window:
                each from another slot of the suite while slots last,
                and from another call while calls last, drawn from the
                seed;
  check_workers processes that check them side by side (0: in this
                one);
  stage_calls   suites driven through the synchronised stage pass of a
                traced run.
"""
from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, Dict, List, Tuple

import numpy as np

from . import images


class Base:
    LIMITS: Dict[str, int] = {}     # number compared -> its limit

    def __init__(self, config: dict, traffic: dict, program, device,
                 control: bool = False):
        self.cfg, self.traffic = config, traffic
        self.mjt, self.device, self.control = program, device, control
        self.shapes = [(s["height"], s["width"]) for s in config["suite"]
                       for _ in range(s["count"])]
        self.suite_mp = sum(h * w for h, w in self.shapes) / 1e6
        self.answers: List[Tuple[int, list]] = []   # (call, its answers)
        self.attempted = 0
        self.failed = 0
        self.notes = ""

    def setup(self, seed: int):
        n = int(max(self.traffic["pool_suites_min"],
                    -(-self.traffic["pool_mp"] // self.suite_mp)))
        self.pool = images.suites(self.shapes, n, seed, self.device)
        # the window goes on cycling where the warm-up stopped
        self.k0 = int(self.traffic["warm_calls"])
        for k in range(self.k0):
            self.run_call(k)
        if str(self.device).startswith("cuda"):
            import torch
            torch.cuda.synchronize()

    def run_call(self, k: int) -> list:
        raise NotImplementedError

    def call(self, k: int) -> Tuple[float, int]:
        """The k-th timed call -> (megapixels, images)."""
        k += self.k0
        self.answers.append((k, self.run_call(k)))
        self.attempted += len(self.shapes)
        return self.suite_mp, len(self.shapes)

    def sample(self, seed: int) -> List[Tuple[int, int]]:
        """(index into answers, slot) of the answers checked in full."""
        rng = np.random.default_rng([seed, 2])
        slots = rng.permutation(len(self.shapes))
        calls = rng.permutation(len(self.answers))
        m = min(int(self.traffic["check_images"]),
                len(self.answers) * len(self.shapes))
        return [(int(calls[j % len(calls)]), int(slots[j % len(slots)]))
                for j in range(m)]

    def run_checks(self, fn: Callable, jobs: List[tuple]) -> list:
        """fn(*job) for every job, in `check_workers` fresh processes."""
        workers = min(int(self.traffic["check_workers"]), len(jobs),
                      max(1, (os.cpu_count() or 2) - 1))
        if workers <= 0:
            return [fn(*j) for j in jobs]
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(workers, mp_context=ctx) as ex:
            return list(ex.map(fn, *zip(*jobs)))

    def check(self, seed: int) -> Dict[str, int]:
        raise NotImplementedError

    def kernel_bytes(self) -> Dict[str, int]:
        return {}

    def stage_pass(self):
        return {}, 0.0, {}
