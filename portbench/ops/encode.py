"""encode_many of one suite of RGB images a call.

Besides the keys of core/op.py the traffic file gives trellis_blocks
and trellis_rows, the blocks and block rows of each component whose
trellis the reference redoes in each answer it checks in full.

Numbers compared, each exact (limit 0):
  bad_answers   answers of the window that are missing, do not parse,
                or whose frame, quant tables, sampling or scan list is
                not one this configuration's encoder writes (every
                answer);
  bad_coefs     coefficients outside the trellis's candidates (every
                coefficient of an answer checked in full that the
                reference cannot read);
  bad_scans     scans other than the scan search's, coded with their
                optimal tables, byte for byte;
  bad_trellis   sampled blocks and block rows other than the trellis's.
"""
from __future__ import annotations

from typing import Dict

from portbench.core import geometry
from portbench.core.op import Base
from portbench.reference import encode_ref


class Op(Base):
    LIMITS = {"bad_answers": 0, "bad_coefs": 0, "bad_scans": 0,
              "bad_trellis": 0}

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        ref = self.cfg["reference"]
        h, v = ref["sampling"]
        self.samp = [(h, v), (1, 1), (1, 1)]
        self.form = (int(ref["quality"]), bool(ref["progressive"]), h, v)
        for hh, ww in self.shapes:
            if hh % (8 * v) or ww % (8 * h):
                raise ValueError("the reference holds whole MCUs only")

    def encoder_config(self, **kw):
        return self.mjt.EncoderConfig(**dict(self.cfg["encoder"], **kw))

    def run_call(self, k: int):
        cfg = (self.encoder_config(dct_method=self.mjt.DCTMethod.IFAST)
               if self.control else self.encoder_config())
        return self.mjt.encode_many(self.pool[k % len(self.pool)], cfg,
                                    device=self.device)

    def units(self, i) -> int:
        h, w = self.shapes[i]
        return 64 * sum(geometry.comp_blocks(w, h, self.samp))

    def check(self, seed: int) -> Dict[str, int]:
        n = len(self.shapes)
        wrong = set()
        for a, (k, outs) in enumerate(self.answers):
            for i in range(n):
                h, w = self.shapes[i]
                if not (i < len(outs) and isinstance(outs[i], bytes)
                        and encode_ref.header_ok(outs[i], w, h,
                                                 *self.form)):
                    wrong.add((a, i))
        bad_answers = len(wrong)
        jobs, picked = [], self.sample(seed)
        t = self.traffic
        for j, (a, i) in enumerate(picked):
            k, outs = self.answers[a]
            data = outs[i] if i < len(outs) else b""
            jobs.append((data if isinstance(data, bytes) else b"",
                         self.pool[k % len(self.pool)][i], *self.form,
                         bool(self.cfg["reference"]["overshoot_deringing"]),
                         [seed, 3, j], int(t["trellis_blocks"]),
                         int(t["trellis_rows"])))
        res = self.run_checks(encode_ref.check_stream, jobs)
        out = {"bad_answers": bad_answers, "bad_coefs": 0, "bad_scans": 0,
               "bad_trellis": 0}
        unreadable = 0
        for (a, i), r in zip(picked, res):
            unreadable += r["bad_stream"]
            out["bad_coefs"] += (self.units(i) if r["bad_stream"]
                                 else r["bad_coef"])
            out["bad_scans"] += r["bad_scans"]
            out["bad_trellis"] += r["bad_trellis"]
            if r["bad_stream"] or r["bad_coef"] or r["bad_scans"] \
                    or r["bad_trellis"]:
                wrong.add((a, i))
        self.failed = len(wrong)
        self.notes = "%d answers, %d checked in full, %d of them unreadable" \
            % (len(self.answers) * n, len(picked), unreadable)
        return out

    def kernel_bytes(self) -> Dict[str, int]:
        """Bytes bounds of one call's kernels."""
        sizes = [(w, h) for h, w in self.shapes]
        return {"p1_blocks": sum(geometry.p1_blocks_bytes(w, h, self.samp)
                                 for w, h in sizes),
                "trellis_ac": sum(geometry.trellis_ac_bytes(w, h, self.samp)
                                  for w, h in sizes)}

    def stage_pass(self):
        """Each stage's synchronised seconds over `stage_calls` suites ->
        (stages, megapixels, host spans). The suites go through
        encode_many itself, which groups them; each of its groups runs
        with encode_group's `times`."""
        from mozjpeg_tpu_torch.codec import encoder
        times: Dict[str, float] = {}
        group = encoder.encode_group

        def timed(*a, **kw):
            return group(*a, **dict(kw, times=times))
        n = int(self.traffic["stage_calls"])
        encoder.encode_group = timed
        try:
            for s in range(n):
                encoder.encode_many(self.pool[s % len(self.pool)],
                                    self.encoder_config(),
                                    device=self.device)
        finally:
            encoder.encode_group = group
        return times, n * self.suite_mp, {}
