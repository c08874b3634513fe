"""Lossless transcoding: read/write coefficient arrays + DCT-domain
transforms (the jpegtran feature set).

Port of mozjpeg_tpu/codec/transcode.py; like it, host-only: the
coefficients are read by the native entropy decoders, moved by numpy and
written by the host entropy stage (encoder.entropy_image: the native scan
search for jpegrescan), with no device step, so nothing here takes a
device.

Parity reference: mozjpeg jdtrans.c (jpeg_read_coefficients), jctrans.c
(jpeg_write_coefficients), transupp.c (do_flip_h/do_flip_v/do_rot_90/
180/270/do_transpose/do_transverse/do_crop). The reference walks block
arrays with nested loops; here each transform is a handful of
whole-plane array ops (reverse, transpose, sign flips).

All transforms operate on zigzag-order coefficient planes (bh, bw, 64) and
are exact (pure permutations + sign flips of coefficients).
"""
from __future__ import annotations

import copy
import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from .. import consts
from . import arith, decoder, encoder, marker
from .config import EncoderConfig
from .pipeline import geometry
from .pipeline_t import add_dummy_blocks_host

# natural-order index grids for sign flips
_NAT_ROW = np.arange(64) // 8
_NAT_COL = np.arange(64) % 8
# zigzag <-> natural converters for (…, 64) zigzag planes
_ZZ = consts.JPEG_ZIGZAG
_ZZ_INV = np.argsort(_ZZ)
# transpose permutation in zigzag space: natural (r,c) -> (c,r)
_TRANSPOSE_NAT = (_NAT_COL * 8 + _NAT_ROW)
_TRANSPOSE_ZZ = _ZZ_INV[_TRANSPOSE_NAT[_ZZ]]
# sign masks in zigzag space
_SIGN_ODD_COL = np.where(_NAT_COL[_ZZ] % 2 == 1, -1, 1).astype(np.int16)
_SIGN_ODD_ROW = np.where(_NAT_ROW[_ZZ] % 2 == 1, -1, 1).astype(np.int16)


@dataclasses.dataclass
class CoefImage:
    """A decoded JPEG held as coefficient planes (lossless workspace)."""
    jp: marker.ParsedJpeg
    planes: List[np.ndarray]          # per comp (bh_pad, bw_pad, 64) zigzag

    @property
    def width(self):
        return self.jp.width

    @property
    def height(self):
        return self.jp.height


def read_coefficients(data: bytes) -> CoefImage:
    jp = marker.parse(data)
    if jp.arithmetic:
        planes = arith.decode_coefficients_arith(jp, data)
    else:
        planes = decoder.decode_coefficients(jp, data)
    return CoefImage(jp, planes)


def _comp_geom(jp, ci):
    c = jp.components[ci]
    max_h, max_v = jp.max_h, jp.max_v
    cw = -(-jp.width * c.h // max_h)
    ch = -(-jp.height * c.v // max_v)
    return c, -(-cw // 8), -(-ch // 8)


def flip_h(ci_img: CoefImage, trim: bool = True) -> CoefImage:
    """Horizontal flip (transupp.c do_flip_h / do_flip_h_no_crop).

    trim=True: the width is trimmed to a full-iMCU multiple, then block
    columns reverse and odd natural columns flip sign. trim=False keeps
    the original width: blocks within the full-MCU area mirror in place
    and partial iMCUs at the right edge are left untouched
    (transupp.c:728-790)."""
    jp = copy.deepcopy(ci_img.jp)
    imcu_w = 8 * jp.max_h
    if trim:
        new_w = (jp.width - jp.width % imcu_w if jp.width % imcu_w
                 else jp.width)
        jp.width = new_w
        out = []
        for ci, c in enumerate(jp.components):
            bw_keep = new_w * c.h // jp.max_h // 8
            p = ci_img.planes[ci][:, :bw_keep]
            q = p[:, ::-1] * _SIGN_ODD_COL[None, None, :]
            out.append(np.ascontiguousarray(q))
        return CoefImage(jp, out)
    out = []
    for ci, c in enumerate(jp.components):
        m = (jp.width // imcu_w) * c.h       # mirrorable width in blocks
        p = ci_img.planes[ci].copy()
        p[:, :m] = p[:, :m][:, ::-1] * _SIGN_ODD_COL[None, None, :]
        out.append(p)
    return CoefImage(jp, out)


def flip_v(ci_img: CoefImage, trim: bool = True) -> CoefImage:
    """Vertical flip (transupp.c do_flip_v). trim=False keeps the full
    height: rows within the full-MCU area mirror with odd-row sign flips;
    partial iMCUs at the bottom edge are copied verbatim
    (transupp.c:858-930)."""
    jp = copy.deepcopy(ci_img.jp)
    imcu_h = 8 * jp.max_v
    if trim:
        new_h = (jp.height - jp.height % imcu_h if jp.height % imcu_h
                 else jp.height)
        jp.height = new_h
        out = []
        for ci, c in enumerate(jp.components):
            bh_keep = new_h * c.v // jp.max_v // 8
            p = ci_img.planes[ci][:bh_keep]
            q = p[::-1] * _SIGN_ODD_ROW[None, None, :]
            out.append(np.ascontiguousarray(q))
        return CoefImage(jp, out)
    out = []
    for ci, c in enumerate(jp.components):
        m = (jp.height // imcu_h) * c.v      # mirrorable height in blocks
        p = ci_img.planes[ci].copy()
        p[:m] = p[:m][::-1] * _SIGN_ODD_ROW[None, None, :]
        out.append(p)
    return CoefImage(jp, out)


def _transpose_planes(ci_img: CoefImage) -> Tuple[marker.ParsedJpeg,
                                                  List[np.ndarray]]:
    jp = copy.deepcopy(ci_img.jp)
    jp.width, jp.height = ci_img.jp.height, ci_img.jp.width
    # quantization tables transpose with the basis
    # (transupp.c transpose_critical_parameters)
    jp.qtables = {k: np.ascontiguousarray(v.T) for k, v in jp.qtables.items()}
    jp.scan_qtables = [{k: np.ascontiguousarray(v.T) for k, v in d.items()}
                       for d in jp.scan_qtables]
    out = []
    for ci, c in enumerate(jp.components):
        c.h, c.v = c.v, c.h
        p = ci_img.planes[ci]
        q = np.transpose(p, (1, 0, 2))[:, :, _TRANSPOSE_ZZ]
        out.append(np.ascontiguousarray(q))
    return jp, out


def transpose(ci_img: CoefImage) -> CoefImage:
    jp, planes = _transpose_planes(ci_img)
    return CoefImage(jp, planes)


def rot90(ci_img: CoefImage, trim: bool = True) -> CoefImage:
    """90 degrees clockwise = transpose + horizontal flip; without trim,
    right-edge partial iMCUs are transposed but not mirrored
    (transupp.c:983-1000)."""
    return flip_h(transpose(ci_img), trim)


def rot270(ci_img: CoefImage, trim: bool = True) -> CoefImage:
    """270 degrees clockwise = transpose + vertical flip; without trim,
    bottom-edge partial iMCUs are transposed but not mirrored."""
    return flip_v(transpose(ci_img), trim)


def rot180(ci_img: CoefImage, trim: bool = True) -> CoefImage:
    """Without trim, right-edge blocks mirror only vertically, bottom
    rows only horizontally, and the corner is copied (transupp.c
    do_rot_180's region split = composing the two no-crop flips)."""
    return flip_v(flip_h(ci_img, trim), trim)


def transverse(ci_img: CoefImage, trim: bool = True) -> CoefImage:
    """Transpose across the anti-diagonal."""
    return flip_v(flip_h(transpose(ci_img), trim), trim)


@dataclasses.dataclass
class CropSpec:
    """Parsed -crop/-wipe/-drop geometry
    (transupp.c jtransform_parse_crop_spec):
    <width>[{fr}]x<height>[{fr}]{+-}<xoffset>{+-}<yoffset>."""
    width: int = 0
    height: int = 0
    xoff: int = 0
    yoff: int = 0
    width_set: str = "unset"      # unset | pos | force | reflect
    height_set: str = "unset"
    xoff_set: str = "unset"       # unset | pos | neg
    yoff_set: str = "unset"


def parse_crop_spec(spec: str) -> CropSpec:
    cs = CropSpec()
    i, n = 0, len(spec)

    def read_int():
        nonlocal i
        j = i
        while i < n and spec[i].isdigit():
            i += 1
        if i == j:
            raise ValueError("bad crop spec %r" % spec)
        return int(spec[j:i])

    if i < n and spec[i].isdigit():
        cs.width = read_int()
        cs.width_set = "pos"
        if i < n and spec[i] in "fF":
            cs.width_set = "force"
            i += 1
        elif i < n and spec[i] in "rR":
            cs.width_set = "reflect"
            i += 1
    if i < n and spec[i] in "xX":
        i += 1
        cs.height = read_int()
        cs.height_set = "pos"
        if i < n and spec[i] in "fF":
            cs.height_set = "force"
            i += 1
        elif i < n and spec[i] in "rR":
            cs.height_set = "reflect"
            i += 1
    if i < n and spec[i] in "+-":
        cs.xoff_set = "neg" if spec[i] == "-" else "pos"
        i += 1
        cs.xoff = read_int()
    if i < n and spec[i] in "+-":
        cs.yoff_set = "neg" if spec[i] == "-" else "pos"
        i += 1
        cs.yoff = read_int()
    if i != n:
        raise ValueError("bad crop spec %r" % spec)
    return cs


def _crop_geometry(jp, cs: CropSpec, op: str = "none"):
    """Resolve a CropSpec against the image (transupp.c
    jtransform_request_workspace crop section): returns (xoffset, yoffset,
    out_w, out_h, x_imcu, y_imcu, drop_w_imcu, drop_h_imcu)."""
    imcu_w, imcu_h = 8 * jp.max_h, 8 * jp.max_v
    src_w, src_h = jp.width, jp.height
    cw = cs.width if cs.width_set != "unset" else None
    ch = cs.height if cs.height_set != "unset" else None
    xo = cs.xoff if cs.xoff_set != "unset" else 0
    yo = cs.yoff if cs.yoff_set != "unset" else 0
    if cw is None:
        if xo >= src_w:
            raise ValueError("bad crop spec")
        cw = src_w - xo
    elif cw > src_w:
        if op != "none" or xo >= cw or xo > cw - src_w:
            raise ValueError("bad crop spec")
    else:
        if xo >= src_w or cw <= 0 or xo > src_w - cw:
            raise ValueError("bad crop spec")
    if ch is None:
        if yo >= src_h:
            raise ValueError("bad crop spec")
        ch = src_h - yo
    elif ch > src_h:
        if op != "none" or yo >= ch or yo > ch - src_h:
            raise ValueError("bad crop spec")
    else:
        if yo >= src_h or ch <= 0 or yo > src_h - ch:
            raise ValueError("bad crop spec")
    # negative offsets measure from the other edge
    if cs.xoff_set == "neg":
        xo = (cw - src_w - xo) if cw > src_w else (src_w - cw - xo)
    if cs.yoff_set == "neg":
        yo = (ch - src_h - yo) if ch > src_h else (src_h - ch - yo)
    drop_w = drop_h = 0
    if op == "drop":
        d = imcu_w - 1 - ((xo + imcu_w - 1) % imcu_w)
        xo += d
        if cw <= d:
            drop_w = 0
        elif xo + cw - d == src_w:
            drop_w = (cw - d + imcu_w - 1) // imcu_w
        else:
            drop_w = (cw - d) // imcu_w
        d = imcu_h - 1 - ((yo + imcu_h - 1) % imcu_h)
        yo += d
        if ch <= d:
            drop_h = 0
        elif yo + ch - d == src_h:
            drop_h = (ch - d + imcu_h - 1) // imcu_h
        else:
            drop_h = (ch - d) // imcu_h
        out_w, out_h = src_w, src_h
    elif op == "wipe":
        drop_w = -(-(cw + xo % imcu_w) // imcu_w)
        drop_h = -(-(ch + yo % imcu_h) // imcu_h)
        out_w, out_h = src_w, src_h
    else:
        out_w = cw if (cs.width_set == "force" or cw > src_w) \
            else cw + xo % imcu_w
        out_h = ch if (cs.height_set == "force" or ch > src_h) \
            else ch + yo % imcu_h
    return xo, yo, out_w, out_h, xo // imcu_w, yo // imcu_h, drop_w, drop_h


def crop(ci_img: CoefImage, x: int, y: int, w: int, h: int) -> CoefImage:
    """iMCU-aligned crop (back-compat wrapper over crop_spec)."""
    cs = CropSpec(w, h, x, y, "pos", "pos", "pos", "pos")
    return crop_spec(ci_img, cs)


def crop_spec(ci_img: CoefImage, cs: CropSpec) -> CoefImage:
    """-crop with the full reference geometry: positional crops cover the
    requested region by iMCU snapping; force/extension crops may exceed
    the source, filling new areas with zero (default), flat DC
    extrapolation (f suffix), or repeated reflections (r suffix)
    (transupp.c do_crop / do_crop_ext_{zero,flat,reflect})."""
    jp = ci_img.jp
    _, _, out_w, out_h, x_imcu, y_imcu, _, _ = _crop_geometry(jp, cs, "none")
    jp2 = copy.deepcopy(jp)
    jp2.width, jp2.height = out_w, out_h
    ext = out_w > jp.width or out_h > jp.height
    style = "zero"
    if ext and cs.width_set == "force":
        style = "flat"
    elif ext and cs.width_set == "reflect":
        style = "reflect"
    out = []
    for ci, c in enumerate(jp.components):
        xb = x_imcu * c.h
        yb = y_imcu * c.v
        src = ci_img.planes[ci]
        dst_bw = -(-(-(-out_w * c.h // jp.max_h)) // 8)
        dst_bh = -(-(-(-out_h * c.v // jp.max_v)) // 8)
        if not ext:
            out.append(np.ascontiguousarray(
                src[yb:yb + dst_bh, xb:xb + dst_bw]))
            continue
        # full-MCU source area; partial source edges are NOT carried over
        # in extension mode (do_crop_ext_*, transupp.c:315-567)
        m_w = (jp.width // (8 * jp.max_h)) * c.h
        m_h = (jp.height // (8 * jp.max_v)) * c.v
        dst = np.zeros((dst_bh, dst_bw, 64), src.dtype)
        if out_h > jp.height:
            r0, nrows = yb, min(m_h, dst_bh - yb)
            srcsel = src[:nrows]
        else:
            r0, nrows = 0, dst_bh
            srcsel = src[yb:yb + dst_bh]
        rows = slice(r0, r0 + nrows)
        if out_w > jp.width:
            body = srcsel[:, :m_w]
            dst[rows, xb:xb + m_w] = body
            if style == "flat":
                if xb > 0:
                    dst[rows, :xb, 0] = body[:, :1, 0]
                if dst_bw > xb + m_w:
                    dst[rows, xb + m_w:, 0] = body[:, m_w - 1:m_w, 0]
            elif style == "reflect":
                refl = body[:, ::-1] * _SIGN_ODD_COL[None, None, :]
                xpos, flip = xb, True
                while xpos > 0:          # repeated reflections leftward
                    take = min(m_w, xpos)
                    dst[rows, xpos - take:xpos] = \
                        (refl if flip else body)[:, m_w - take:]
                    xpos -= take
                    flip = not flip
                xpos, flip = xb + m_w, True
                while xpos < dst_bw:     # and rightward
                    take = min(m_w, dst_bw - xpos)
                    dst[rows, xpos:xpos + take] = \
                        (refl if flip else body)[:, :take]
                    xpos += take
                    flip = not flip
        else:
            dst[rows] = srcsel[:, xb:xb + dst_bw]
        out.append(dst)
    return CoefImage(jp2, out)


def wipe_spec(ci_img: CoefImage, cs: CropSpec) -> CoefImage:
    """jpegtran -wipe: discard the region's contents. Default fills with
    zero (neutral gray); an 'f' width suffix flattens with the average DC
    of horizontally adjacent blocks; an 'r' suffix (full-height region
    touching the left or right edge) fills with repeated reflections
    (transupp.c do_wipe/do_flatten/do_reflect)."""
    jp = ci_img.jp
    xo, yo, _, _, x_imcu, y_imcu, dw, dh = _crop_geometry(jp, cs, "wipe")
    imcu_w, imcu_h = 8 * jp.max_h, 8 * jp.max_v
    total_w_imcu = -(-jp.width // imcu_w)
    total_h_imcu = -(-jp.height // imcu_h)
    use_reflect = (cs.width_set == "reflect" and y_imcu == 0
                   and dh == total_h_imcu
                   and (x_imcu == 0 or x_imcu + dw == total_w_imcu))
    use_flatten = not use_reflect and cs.width_set == "force"
    out = []
    for ci, c in enumerate(jp.components):
        p = ci_img.planes[ci].copy()
        xb, wb = x_imcu * c.h, dw * c.h
        yb, hb = y_imcu * c.v, dh * c.v
        _, bw, _ = _comp_geom(jp, ci)        # real width_in_blocks
        p[yb:yb + hb, xb:xb + wb] = 0
        if use_flatten:
            left = p[yb:yb + hb, xb - 1, 0] if xb > 0 else None
            right = (p[yb:yb + hb, xb + wb, 0]
                     if xb + wb < bw else None)
            if left is not None and right is not None:
                avg = (left.astype(np.int32) + right) >> 1
            elif left is not None:
                avg = left
            elif right is not None:
                avg = right
            else:
                avg = None
            if avg is not None:
                p[yb:yb + hb, xb:xb + wb, 0] = \
                    np.asarray(avg, p.dtype)[:, None]
        elif use_reflect:
            rows = slice(yb, yb + hb)
            if xb > 0:
                # reflect from left: repeated reflections rightward
                # each pass reflects the just-written data leftward of the
                # moving axis (transupp.c:689-706)
                xpos = xb
                while xpos < xb + wb:
                    take = min(xb, xb + wb - xpos)
                    src_seg = p[rows, xpos - take:xpos][:, ::-1] * \
                        _SIGN_ODD_COL[None, None, :]
                    p[rows, xpos:xpos + take] = src_seg
                    xpos += take
            elif bw > xb + wb:
                xpos = xb + wb
                avail = bw - (xb + wb)
                while xpos > xb:
                    take = min(avail, xpos - xb)
                    src_seg = p[rows, xpos:xpos + take][:, ::-1] * \
                        _SIGN_ODD_COL[None, None, :]
                    p[rows, xpos - take:xpos] = src_seg
                    xpos -= take
        out.append(p)
    return CoefImage(jp, out)


def wipe(ci_img: CoefImage, x: int, y: int, w: int, h: int,
         fill: str = "gray") -> CoefImage:
    """Back-compat zero wipe."""
    return wipe_spec(ci_img, CropSpec(w, h, x, y, "pos", "pos",
                                      "pos", "pos"))


def _requant_plane(plane, src_q, dst_q):
    """transupp.c requant_comp: coefficient-domain requantization with
    round-half-away division (entries equal in both tables are kept)."""
    sq = np.asarray(src_q).reshape(64)[_ZZ].astype(np.int64)
    dq = np.asarray(dst_q).reshape(64)[_ZZ].astype(np.int64)
    diff = (sq != dq) & (dq != 0)
    t = plane.astype(np.int64) * sq
    # DIVIDE_BY zeroes only when |t| + (dq>>1) < dq (the rounding bias is
    # added before the compare, transupp.c:150-161) — floor division
    # reproduces that exactly
    mag = (np.abs(t) + (dq >> 1)) // dq
    req = np.where(t < 0, -mag, mag).astype(plane.dtype)
    return np.where(diff[None, None, :], req, plane)


def resolve_drop_offsets(dst_jp, src_jp, cs: CropSpec):
    """Negative drop offsets measure from the far edge minus the drop
    extent (transupp.c:1629-1641 with crop_width = the drop source's
    dims, jpegtran.c drop_request)."""
    xo = cs.xoff if cs.xoff_set != "unset" else 0
    yo = cs.yoff if cs.yoff_set != "unset" else 0
    if cs.xoff_set == "neg":
        if src_jp.width > dst_jp.width:      # crop extension
            xo = src_jp.width - dst_jp.width - xo
        else:
            xo = dst_jp.width - src_jp.width - xo
    if cs.yoff_set == "neg":
        if src_jp.height > dst_jp.height:
            yo = src_jp.height - dst_jp.height - yo
        else:
            yo = dst_jp.height - src_jp.height - yo
    return xo, yo


def drop(dst: CoefImage, src: CoefImage, x: int, y: int,
         trim_requant: bool = True) -> CoefImage:
    """jpegtran -drop +X+Y file: insert src's blocks into dst, offsets
    snapped UP to iMCU boundaries with the effective region shrunk to
    stay inside the requested one (jcmaster.c drop geometry,
    transupp.c do_drop). If quant tables differ: with -trim, the drop
    image is requantized to dst's tables (requant_comp); otherwise both
    images are dequantized to the GCD table, which replaces the output
    quant table (adjust_quant, transupp.c:190-228)."""
    jp = copy.deepcopy(dst.jp)
    cs = CropSpec(src.jp.width, src.jp.height, x, y,
                  "pos", "pos", "pos", "pos")
    _, _, _, _, x_imcu, y_imcu, dw, dh = _crop_geometry(jp, cs, "drop")
    if dw == 0 or dh == 0:
        return CoefImage(jp, [p.copy() for p in dst.planes])
    for ci in range(min(len(jp.components), len(src.jp.components))):
        if (src.jp.components[ci].h * jp.max_h
                != jp.components[ci].h * src.jp.max_h
                or src.jp.components[ci].v * jp.max_v
                != jp.components[ci].v * src.jp.max_v):
            raise ValueError("drop sampling factors do not match")
    # quant table adjustment (adjust_quant); comparisons always use the
    # ORIGINAL latched tables (srcinfo/dropinfo comp quant_table), even
    # when an earlier component already rewrote the shared output slot
    src_planes = [p.copy() for p in src.planes]
    dst_planes = [p.copy() for p in dst.planes]
    orig_dq = {k: np.asarray(v).copy() for k, v in dst.jp.qtables.items()}
    for ci in range(min(len(jp.components), len(src.jp.components))):
        dq = orig_dq[jp.components[ci].quant_tbl]
        sq = src.jp.qtables[src.jp.components[ci].quant_tbl]
        if np.array_equal(np.asarray(dq), np.asarray(sq)):
            continue
        if trim_requant:
            src_planes[ci] = _requant_plane(src_planes[ci], sq, dq)
        else:
            g = np.gcd(np.asarray(dq, np.int64), np.asarray(sq, np.int64))
            newq = np.where(np.asarray(dq) != np.asarray(sq),
                            g, np.asarray(dq)).astype(np.uint16)
            dst_planes[ci] = _dequant_plane(dst_planes[ci], dq, newq)
            src_planes[ci] = _dequant_plane(src_planes[ci], sq, newq)
            slot = jp.components[ci].quant_tbl
            jp.qtables[slot] = newq
            jp.scan_qtables = [
                {k: (newq if k == slot else v) for k, v in d.items()}
                for d in jp.scan_qtables]
    out = []
    for ci, c in enumerate(jp.components):
        p = dst_planes[ci]
        xb, yb = x_imcu * c.h, y_imcu * c.v
        wb, hb = dw * c.h, dh * c.v
        if ci < len(src.jp.components):
            p[yb:yb + hb, xb:xb + wb] = src_planes[ci][:hb, :wb]
        else:
            p[yb:yb + hb, xb:xb + wb] = 0
        out.append(p)
    return CoefImage(jp, out)


def _dequant_plane(plane, old_q, new_q):
    """transupp.c dequant_comp: rescale coefficients exactly when the
    table entry divides the old one (coef * old/new)."""
    oq = np.asarray(old_q).reshape(64)[_ZZ].astype(np.int64)
    nq = np.asarray(new_q).reshape(64)[_ZZ].astype(np.int64)
    scale = np.where(nq != 0, oq // np.where(nq == 0, 1, nq), 1)
    return (plane.astype(np.int64)
            * scale[None, None, :]).astype(plane.dtype)


TRANSFORMS = {
    "none": lambda c, trim=True: c,
    "flip_h": flip_h,
    "flip_v": flip_v,
    "transpose": lambda c, trim=True: transpose(c),
    "transverse": transverse,
    "rot90": rot90,
    "rot180": rot180,
    "rot270": rot270,
}


def to_grayscale(ci_img: CoefImage) -> CoefImage:
    """jpegtran -grayscale (transupp.c:2048-2071): keep only the
    full-resolution Y component and discard chroma coefficients; the Y
    quant slot is preserved. Single-component sources just get their
    sampling factors forced to 1x1 (transupp.c:2072-2079)."""
    jp = copy.deepcopy(ci_img.jp)
    c0 = jp.components[0]
    if not (len(jp.components) in (1, 3)
            and c0.h == jp.max_h and c0.v == jp.max_v):
        raise ValueError("grayscale conversion not implemented for this "
                         "colorspace (JERR_CONVERSION_NOTIMPL)")
    if c0.quant_tbl != 0:
        # the writer emits grayscale with quant slot 0; remap the Y table
        jp.qtables[0] = jp.qtables[c0.quant_tbl]
    c0 = dataclasses.replace(c0, h=1, v=1, quant_tbl=0)
    jp.components = [c0]
    return CoefImage(jp, [ci_img.planes[0]])


def copy_marker_list(jp, option: str = "comments"):
    """Select saved COM/APPn markers per jpegtran -copy semantics
    (transupp.c:2346-2392 jcopy_markers_execute); JFIF APP0 and Adobe
    APP14 duplicates are dropped (the writer regenerates its own)."""
    out = []
    for code, payload in jp.markers:
        is_com = code == 0xFE
        is_app = 0xE0 <= code <= 0xEF
        if not (is_com or is_app):
            continue
        is_icc = code == 0xE2 and payload[:12] == b"ICC_PROFILE\x00"
        if option == "none":
            continue
        if option == "comments" and not is_com:
            continue
        if option == "icc" and not is_icc:
            continue
        if option == "all_except_icc" and is_icc:
            continue
        if code == 0xE0 and payload[:5] == b"JFIF\x00":
            continue          # writer emits its own JFIF
        if code == 0xEE and payload[:5] == b"Adobe":
            continue          # writer emits its own Adobe APP14
        out.append((code, payload))
    return out


def write_coefficients(ci_img: CoefImage,
                       config: Optional[EncoderConfig] = None,
                       copy_markers: str = "comments",
                       icc: Optional[bytes] = None) -> bytes:
    """Entropy-code coefficient planes into a JPEG (jpeg_write_coefficients
    + the jpegtran output stack: optimize_scans over existing coefficients
    is exactly the jpegrescan use case), through the encoder's host
    entropy stage with the source's colourspace, quant slots and tables,
    and its copied markers after any configured ICC profile."""
    jp = ci_img.jp
    if config is None:
        config = EncoderConfig()
    if jp.precision != 8 and config.precision == 8:
        config = dataclasses.replace(config, precision=jp.precision)
    cfg = config.resolved()
    ncomps = len(jp.components)
    samp = [(c.h, c.v) for c in jp.components]
    geom = geometry(jp.width, jp.height, samp)
    # re-pad the planes to the MCU-padded dims with the dummy DC fill
    planes = [add_dummy_blocks_host(np.ascontiguousarray(
        ci_img.planes[ci][:g.bh, :g.bw], np.int16), g)
        for ci, g in enumerate(geom[2])]

    # preserve the source's per-component quant-slot mapping (a legal
    # stream may bind components to any of slots 0..3)
    qt_slots = tuple(c.quant_tbl for c in jp.components)
    nslots = max(qt_slots) + 1
    fallback = jp.qtables.get(0, np.ones((8, 8), np.uint16))
    qtables = [jp.qtables.get(i, fallback) for i in range(max(nslots, 2))]
    extra = copy_marker_list(jp, copy_markers) if copy_markers else []
    if icc:
        # jpegtran.c:754-755: jpeg_write_icc_profile runs after the copied
        # markers, splitting across APP2 chunks (jcicc.c)
        extra = list(extra) + marker.icc_chunks(icc)
    ctx = encoder.GroupCtx(cfg, config.profile, decoder._jpeg_colorspace(jp),
                           ncomps, samp, qtables, slots=qt_slots,
                           extra_markers=tuple(extra))
    return encoder.entropy_image(jp.width, jp.height, geom, planes, ctx)


def perfect_possible(jp, op: str) -> bool:
    """jpegtran -perfect: a transform is lossless-perfect iff no edge
    trimming would occur (transupp.c)."""
    imcu_w, imcu_h = 8 * jp.max_h, 8 * jp.max_v
    w_ok = jp.width % imcu_w == 0
    h_ok = jp.height % imcu_h == 0
    need_w = op in ("flip_h", "rot270", "rot180", "transverse")
    need_h = op in ("flip_v", "rot90", "rot180", "transverse")
    return (w_ok or not need_w) and (h_ok or not need_h)


def transform(data: bytes, op: str = "none",
              config: Optional[EncoderConfig] = None,
              copy_markers: str = "comments",
              perfect: bool = False, trim: bool = True,
              crop: Optional[str] = None,
              drop: Optional[Tuple[str, bytes]] = None) -> bytes:
    """One-call lossless transform: parse -> transform -> re-encode.

    trim=False reproduces jpegtran's default edge-block behavior
    (partial iMCUs preserved untransformed); crop takes an X11-style
    geometry string (with f/r extension suffixes); drop is
    (geometry, jpeg_bytes)."""
    img = read_coefficients(data)
    if perfect and not perfect_possible(img.jp, op):
        raise ValueError("transformation is not perfect")
    if drop is not None:
        cs = parse_crop_spec(drop[0])
        src = read_coefficients(drop[1])
        xo, yo = resolve_drop_offsets(img.jp, src.jp, cs)
        img = globals()["drop"](img, src, xo, yo, trim_requant=trim)
    elif op == "wipe" and crop:
        img = wipe_spec(img, parse_crop_spec(crop))
    elif op.startswith("crop:"):
        x, y, w, h = (int(v) for v in op[5:].split(","))
        cs = CropSpec(w, h, x, y, "pos", "pos", "pos", "pos")
        img = crop_spec(img, cs)
    elif crop and op == "none":
        img = crop_spec(img, parse_crop_spec(crop))
    elif op in TRANSFORMS:
        img = TRANSFORMS[op](img, trim)
        if crop:
            # crop combined with a transform: apply to the transformed
            # image (approximation of the fused reference path)
            img = crop_spec(img, parse_crop_spec(crop))
    else:
        raise ValueError("unknown transform %r" % op)
    return write_coefficients(img, config, copy_markers)
