"""Encoder configuration: the JAX package's parameter surface, field for field.

Port of mozjpeg_tpu/codec/config.py. Defaults follow jpeg_set_defaults
with JCP_MAX_COMPRESSION (mozjpeg jcparam.c:387-518): progressive +
trellis + optimize_scans + optimized Huffman + overshoot deringing +
quant table 3. The device entropy and scan-search engines resolve as in
the JAX package: an explicit flag, else MJ_DEVICE_ENTROPY /
MJ_DEVICE_SCANOPT ("1"/"0"), else `deployment` (utils/attachment.py),
whose "auto" is off in the port. The transfer codecs (sparse and
transport downloads, plane packing) are not ported: their "auto" is off
and an explicit request is refused by the encoder (codec/encoder.py
_check_slice).

Also the per-colorspace component layout (CS_INFO), the quant slot
mapping and the restart-interval conversions of mozjpeg_tpu/codec/
encoder.py, which the encoder and the scan search share.
"""
from __future__ import annotations

import dataclasses
import enum
import os
from typing import Optional, Sequence, Tuple


class Profile(enum.Enum):
    MAX_COMPRESSION = "max"    # mozjpeg default
    FASTEST = "fastest"        # libjpeg-turbo-compatible ("-revert")


def quality_default_subsampling(quality: float) -> Tuple[int, int]:
    """cjpeg -quality subsampling heuristic (rdswitch.c:562-570):
    >=90 -> 4:4:4, >=80 -> 4:2:2, else 4:2:0."""
    if quality >= 90:
        return (1, 1)
    if quality >= 80:
        return (2, 1)
    return (2, 2)


class DCTMethod(enum.Enum):
    ISLOW = "islow"
    IFAST = "ifast"
    FLOAT = "float"


@dataclasses.dataclass
class EncoderConfig:
    quality: object = 75.0
    profile: Profile = Profile.MAX_COMPRESSION
    precision: int = 8

    subsampling: Tuple[int, int] = (2, 2)   # (h, v) for luma; chroma 1x1
    gray_sample: Optional[Tuple[int, int]] = None
    grayscale: bool = False
    colorspace: Optional[str] = None

    progressive: Optional[bool] = None      # None = profile default
    optimize_coding: Optional[bool] = None
    optimize_scans: Optional[bool] = None
    arithmetic: bool = False
    restart_interval: int = 0
    restart_in_rows: int = 0
    icc: Optional[bytes] = None
    dc_scan_opt_mode: int = 0
    density: tuple = (0, 1, 1)
    write_jfif: bool = True

    quant_tbl_idx: Optional[int] = None     # None = profile default (3 or 0)
    force_baseline: bool = False
    smoothing_factor: int = 0
    base_quant_tables: Optional[Sequence] = None
    qslots: Optional[Sequence[int]] = None

    trellis_quant: Optional[bool] = None
    trellis_quant_dc: bool = True
    trellis_eob_opt: bool = False
    trellis_q_opt: bool = False
    use_lambda_weight_tbl: bool = True
    use_scans_in_trellis: bool = False
    trellis_freq_split: int = 8
    trellis_num_loops: int = 1
    trellis_delta_dc_weight: float = 0.0
    lambda_log_scale1: float = 14.75
    lambda_log_scale2: float = 16.5

    overshoot_deringing: Optional[bool] = None

    dct_method: DCTMethod = DCTMethod.ISLOW
    scan_script: Optional[Sequence] = None

    # the device engines: entropy emission with the restart-parallel bit
    # packers (ops/bitpack.py) and the scan search on the device
    # (codec/scanopt_dev.py), byte-identical to the host's. None = the
    # environment, else `deployment`: "local" (on), "remote" (off) or
    # "auto" (MJ_DEPLOYMENT, else off; utils/attachment.py)
    device_entropy: Optional[bool] = None
    device_scanopt: Optional[bool] = None
    deployment: str = "auto"
    # the transfer codecs (ops/sparsepack.py, planepack.py, transport.py):
    # the exact sparse coefficient download, the plane-packed upload and
    # the Huffman transport download, byte-identical to the dense
    # transfers. None = the environment (MJ_SPARSE_DL, MJ_PLANEPACK,
    # MJ_COEF_TRANSPORT), else off (auto_backend_flag)
    sparse_download: Optional[bool] = None
    host_prep: Optional[bool] = None
    plane_pack: Optional[bool] = None
    coef_transport: Optional[bool] = None

    @classmethod
    def from_fields(cls, d: dict) -> "EncoderConfig":
        """Build from dataclasses.asdict() of a JAX EncoderConfig; enum
        fields may come as enum members of either package or as values."""
        kw = dict(d)
        for name, enum_cls in (("profile", Profile),
                               ("dct_method", DCTMethod)):
            if name in kw:
                v = kw[name]
                kw[name] = enum_cls(getattr(v, "value", v))
        return cls(**kw)

    def resolved(self) -> "ResolvedConfig":
        if self.precision not in (8, 12):
            raise ValueError(
                "lossy data precision must be 8 or 12 (16 is lossless-only), "
                "got %r" % (self.precision,))
        maxc = self.profile == Profile.MAX_COMPRESSION
        deep = self.precision > 8

        def pick(v, default):
            return v if v is not None else default

        return ResolvedConfig(
            quality=self.quality,
            precision=self.precision,
            subsampling=tuple(self.subsampling),
            gray_sample=self.gray_sample,
            grayscale=self.grayscale,
            colorspace=self.colorspace,
            progressive=pick(self.progressive, maxc),
            optimize_coding=True if deep else pick(self.optimize_coding,
                                                   maxc),
            optimize_scans=pick(self.optimize_scans, maxc),
            arithmetic=self.arithmetic and not deep,
            restart_interval=self.restart_interval,
            restart_in_rows=self.restart_in_rows,
            icc=self.icc,
            dc_scan_opt_mode=self.dc_scan_opt_mode,
            density=self.density,
            write_jfif=self.write_jfif,
            quant_tbl_idx=pick(self.quant_tbl_idx, 3 if maxc else 0),
            force_baseline=self.force_baseline,
            smoothing_factor=self.smoothing_factor,
            base_quant_tables=self.base_quant_tables,
            qslots=tuple(self.qslots) if self.qslots else None,
            trellis_quant=pick(self.trellis_quant, maxc),
            trellis_quant_dc=self.trellis_quant_dc,
            trellis_eob_opt=self.trellis_eob_opt,
            trellis_q_opt=self.trellis_q_opt,
            use_lambda_weight_tbl=self.use_lambda_weight_tbl,
            use_scans_in_trellis=self.use_scans_in_trellis,
            trellis_freq_split=self.trellis_freq_split,
            trellis_num_loops=self.trellis_num_loops,
            trellis_delta_dc_weight=self.trellis_delta_dc_weight,
            lambda_log_scale1=self.lambda_log_scale1,
            lambda_log_scale2=self.lambda_log_scale2,
            overshoot_deringing=pick(self.overshoot_deringing, maxc),
            dct_method=self.dct_method,
            scan_script=self.scan_script,
            device_entropy=_engine_flag(self.device_entropy,
                                        "MJ_DEVICE_ENTROPY",
                                        self.deployment),
            device_scanopt=_engine_flag(self.device_scanopt,
                                        "MJ_DEVICE_SCANOPT",
                                        self.deployment),
            sparse_download=auto_backend_flag(self.sparse_download,
                                               "MJ_SPARSE_DL"),
            host_prep=pick(self.host_prep, True),
            plane_pack=auto_backend_flag(self.plane_pack, "MJ_PLANEPACK"),
            coef_transport=auto_backend_flag(self.coef_transport,
                                              "MJ_COEF_TRANSPORT"),
        )


def auto_backend_flag(flag, env_name: str) -> bool:
    """A transfer codec's switch (the JAX package's _auto_backend_flag):
    the flag, else the environment variable, else "auto", which the JAX
    package turns on for a TPU backend only and so is off here."""
    if flag is not None:
        return bool(flag)
    env = os.environ.get(env_name, "auto").lower()
    return env in ("1", "true", "on")


def _engine_flag(flag, env_name: str, deployment: str) -> bool:
    """A device engine's switch (the JAX package's _auto_device_entropy
    and _auto_device_scanopt): the flag, else the environment variable,
    else the deployment."""
    if flag is not None:
        return bool(flag)
    env = os.environ.get(env_name, "auto").lower()
    if env in ("0", "false", "off"):
        return False
    if env in ("1", "true", "on"):
        return True
    from ..utils import attachment
    return attachment.deployment_local(deployment)


# per-colorspace component layout: (quant slots, huff table slots, comp IDs)
# (jcparam.c:600-646 jpeg_set_colorspace SET_COMP calls)
CS_INFO = {
    "grayscale": ((0,), (0,), (1,)),
    "ycbcr": ((0, 1, 1), (0, 1, 1), (1, 2, 3)),
    "rgb": ((0, 0, 0), (0, 0, 0), (0x52, 0x47, 0x42)),
    "cmyk": ((0, 0, 0, 0), (0, 0, 0, 0), (0x43, 0x4D, 0x59, 0x4B)),
    "ycck": ((0, 1, 1, 0), (0, 1, 1, 0), (1, 2, 3, 4)),
}


def qt_slots(cfg, cs: str, ncomps: int) -> tuple:
    """Per-component quant slots, with the qslots override (rdswitch.c
    set_quant_slots: the last value replicates)."""
    if cfg.qslots:
        sl = list(cfg.qslots)[:ncomps]
        while len(sl) < ncomps:
            sl.append(sl[-1])
        return tuple(sl)
    return CS_INFO[cs][0][:ncomps]


def scan_restart_interval(cfg, scan, geom) -> int:
    """Per-scan restart interval (jcmaster.c:595-600 per_scan_setup):
    restart_in_rows converts with the scan's MCUs per row, which is the
    component's width in blocks for a non-interleaved scan
    (jcmaster.c:533)."""
    mcus_x, _, comps = geom
    if cfg.restart_in_rows:
        mpr = mcus_x if len(scan.comps) > 1 else comps[scan.comps[0]].bw
        return min(cfg.restart_in_rows * mpr, 65535)
    return cfg.restart_interval


def trellis_ris(cfg, comps):
    """Restart interval per component for the trellis's statistics
    passes, or None: each gather is a single-component pseudo-scan, so
    restart_in_rows converts with that component's width in blocks."""
    if cfg.restart_in_rows:
        return tuple(min(cfg.restart_in_rows * g.bw, 65535) for g in comps)
    if cfg.restart_interval:
        return (cfg.restart_interval,) * len(comps)
    return None


@dataclasses.dataclass
class ResolvedConfig:
    quality: float
    precision: int
    subsampling: Tuple[int, int]
    gray_sample: Optional[Tuple[int, int]]
    grayscale: bool
    colorspace: Optional[str]
    progressive: bool
    optimize_coding: bool
    optimize_scans: bool
    arithmetic: bool
    restart_interval: int
    restart_in_rows: int
    icc: Optional[bytes]
    density: tuple
    write_jfif: bool
    dc_scan_opt_mode: int
    quant_tbl_idx: int
    force_baseline: bool
    smoothing_factor: int
    base_quant_tables: Optional[Sequence]
    qslots: Optional[Tuple[int, ...]]
    trellis_quant: bool
    trellis_quant_dc: bool
    trellis_eob_opt: bool
    trellis_q_opt: bool
    use_lambda_weight_tbl: bool
    use_scans_in_trellis: bool
    trellis_freq_split: int
    trellis_num_loops: int
    trellis_delta_dc_weight: float
    lambda_log_scale1: float
    lambda_log_scale2: float
    overshoot_deringing: bool
    dct_method: DCTMethod
    scan_script: Optional[Sequence]
    device_entropy: bool
    device_scanopt: bool
    sparse_download: bool
    host_prep: bool
    plane_pack: bool
    coef_transport: bool
