"""encode_many of one suite of 12-bit grayscale radiographs a call, to
DICOM's lossy 12-bit JPEG (sequential, SOF1).

The suite's images come from core/radiographs.py; the calls, the
encoder's configuration and the stage pass are ops/encode.py's. Besides
the keys of core/op.py the traffic file gives trellis_blocks and
trellis_rows, the blocks and block rows whose trellis the reference
(reference/gray12_ref.py) redoes in each answer it checks in full.

Numbers compared, each exact (limit 0):
  bad_answers   answers of the window that are missing, do not parse,
                or whose frame, quant table or scan is not this
                configuration's: SOF1 at 12 bits, one component, one
                sequential scan with its own DC and AC tables (every
                answer);
  bad_coefs     coefficients outside the 12-bit trellis's candidates
                (every coefficient of an answer checked in full that the
                reference cannot read);
  bad_scan      scans other than the optimal-table coding of their own
                coefficients, byte for byte;
  bad_trellis   sampled blocks and block rows other than the 12-bit
                trellis's.
"""
from __future__ import annotations

from typing import Dict

from portbench.core import geometry, geometry12, radiographs
from portbench.ops import encode
from portbench.reference import gray12_ref

SAMP = [(1, 1)]


class Op(encode.Op):
    LIMITS = {"bad_answers": 0, "bad_coefs": 0, "bad_scan": 0,
              "bad_trellis": 0}

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.samp = SAMP
        self.quality = int(self.cfg["reference"]["quality"])
        self.deringing = bool(self.cfg["reference"]["overshoot_deringing"])

    def setup(self, seed: int):
        n = int(max(self.traffic["pool_suites_min"],
                    -(-self.traffic["pool_mp"] // self.suite_mp)))
        self.pool = radiographs.suites(self.shapes, n, seed, self.device)
        self.k0 = int(self.traffic["warm_calls"])
        for k in range(self.k0):
            self.run_call(k)
        if str(self.device).startswith("cuda"):
            import torch
            torch.cuda.synchronize()

    def check(self, seed: int) -> Dict[str, int]:
        n = len(self.shapes)
        wrong = set()
        for a, (k, outs) in enumerate(self.answers):
            for i in range(n):
                h, w = self.shapes[i]
                if not (i < len(outs) and isinstance(outs[i], bytes)
                        and gray12_ref.header_ok(outs[i], w, h,
                                                 self.quality)):
                    wrong.add((a, i))
        bad_answers = len(wrong)
        jobs, picked = [], self.sample(seed)
        t = self.traffic
        for j, (a, i) in enumerate(picked):
            k, outs = self.answers[a]
            data = outs[i] if i < len(outs) else b""
            jobs.append((data if isinstance(data, bytes) else b"",
                         self.pool[k % len(self.pool)][i], self.quality,
                         self.deringing, [seed, 3, j],
                         int(t["trellis_blocks"]), int(t["trellis_rows"])))
        res = self.run_checks(gray12_ref.check_stream, jobs)
        out = {"bad_answers": bad_answers, "bad_coefs": 0, "bad_scan": 0,
               "bad_trellis": 0}
        unreadable = 0
        for (a, i), r in zip(picked, res):
            unreadable += r["bad_stream"]
            out["bad_coefs"] += (self.units(i) if r["bad_stream"]
                                 else r["bad_coef"])
            out["bad_scan"] += r["bad_scan"]
            out["bad_trellis"] += r["bad_trellis"]
            if r["bad_stream"] or r["bad_coef"] or r["bad_scan"] \
                    or r["bad_trellis"]:
                wrong.add((a, i))
        self.failed = len(wrong)
        self.notes = "%d answers, %d checked in full, %d of them unreadable" \
            % (len(self.answers) * n, len(picked), unreadable)
        return out

    def kernel_bytes(self) -> Dict[str, int]:
        """Bytes bounds of one call's 12-bit kernels."""
        sizes = [(w, h) for h, w in self.shapes]
        return {"p1_blocks12": sum(geometry12.p1_blocks12_bytes(w, h, SAMP)
                                   for w, h in sizes),
                "trellis_ac14": sum(geometry12.trellis_ac14_bytes(w, h,
                                                                  SAMP)
                                    for w, h in sizes)}

    def units(self, i) -> int:
        h, w = self.shapes[i]
        return 64 * sum(geometry.comp_blocks(w, h, SAMP))
