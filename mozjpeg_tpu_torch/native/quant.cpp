// Color quantization: 2-pass median-cut with optional Floyd-Steinberg
// dithering, numerically identical to the reference decoder's jquant2
// (/root/reference/jquant2.c).  The scaled-RGB distance metric (2/3/1),
// the 5-6-5 histogram, Heckbert's locally-sorted search over 4x8x4 update
// boxes with Thomas' incremental distances, the error-limit transfer
// function, and the serpentine FS traversal all follow that design.
//
// Everything here is 8-bit RGB (djpeg -colors operates post color
// conversion).
#include <cstdint>
#include <cstring>
#include <cstdlib>

namespace {

constexpr int kC0Bits = 5, kC1Bits = 6, kC2Bits = 5;
constexpr int kC0Shift = 8 - kC0Bits, kC1Shift = 8 - kC1Bits,
              kC2Shift = 8 - kC2Bits;
constexpr int kC0 = 1 << kC0Bits, kC1 = 1 << kC1Bits, kC2 = 1 << kC2Bits;
constexpr int kScale0 = 2, kScale1 = 3, kScale2 = 1;  // R/G/B weights
constexpr int kMaxColors = 256;

// update-box geometry: 1/8 of the histogram per axis (4 x 8 x 4 cells)
constexpr int kBoxC0Log = kC0Bits - 3, kBoxC1Log = kC1Bits - 3,
              kBoxC2Log = kC2Bits - 3;
constexpr int kBoxC0 = 1 << kBoxC0Log, kBoxC1 = 1 << kBoxC1Log,
              kBoxC2 = 1 << kBoxC2Log;
constexpr int kBoxC0Shift = kC0Shift + kBoxC0Log;
constexpr int kBoxC1Shift = kC1Shift + kBoxC1Log;
constexpr int kBoxC2Shift = kC2Shift + kBoxC2Log;

struct Box {
  int c0min, c0max, c1min, c1max, c2min, c2max;
  long volume;
  long colorcount;
};

struct Quant2 {
  uint16_t hist[kC0][kC1][kC2];   // pass1: counts; pass2: inverse cmap cache
  uint8_t cmap[3][kMaxColors];
  int ncolors;
};

inline uint16_t *cell(Quant2 *q, int c0, int c1, int c2) {
  return &q->hist[c0][c1][c2];
}

void shrink_box(Quant2 *q, Box *b) {
  int c0min = b->c0min, c0max = b->c0max;
  int c1min = b->c1min, c1max = b->c1max;
  int c2min = b->c2min, c2max = b->c2max;
  // shrink each face inward to the first plane holding a used cell;
  // scan orders match the reference so equal-volume results agree
  if (c0max > c0min)
    for (int c0 = c0min; c0 <= c0max; c0++)
      for (int c1 = c1min; c1 <= c1max; c1++)
        for (int c2 = c2min; c2 <= c2max; c2++)
          if (*cell(q, c0, c1, c2)) {
            b->c0min = c0min = c0;
            goto c0min_done;
          }
c0min_done:
  if (c0max > c0min)
    for (int c0 = c0max; c0 >= c0min; c0--)
      for (int c1 = c1min; c1 <= c1max; c1++)
        for (int c2 = c2min; c2 <= c2max; c2++)
          if (*cell(q, c0, c1, c2)) {
            b->c0max = c0max = c0;
            goto c0max_done;
          }
c0max_done:
  if (c1max > c1min)
    for (int c1 = c1min; c1 <= c1max; c1++)
      for (int c0 = c0min; c0 <= c0max; c0++)
        for (int c2 = c2min; c2 <= c2max; c2++)
          if (*cell(q, c0, c1, c2)) {
            b->c1min = c1min = c1;
            goto c1min_done;
          }
c1min_done:
  if (c1max > c1min)
    for (int c1 = c1max; c1 >= c1min; c1--)
      for (int c0 = c0min; c0 <= c0max; c0++)
        for (int c2 = c2min; c2 <= c2max; c2++)
          if (*cell(q, c0, c1, c2)) {
            b->c1max = c1max = c1;
            goto c1max_done;
          }
c1max_done:
  if (c2max > c2min)
    for (int c2 = c2min; c2 <= c2max; c2++)
      for (int c0 = c0min; c0 <= c0max; c0++)
        for (int c1 = c1min; c1 <= c1max; c1++)
          if (*cell(q, c0, c1, c2)) {
            b->c2min = c2min = c2;
            goto c2min_done;
          }
c2min_done:
  if (c2max > c2min)
    for (int c2 = c2max; c2 >= c2min; c2--)
      for (int c0 = c0min; c0 <= c0max; c0++)
        for (int c1 = c1min; c1 <= c1max; c1++)
          if (*cell(q, c0, c1, c2)) {
            b->c2max = c2max = c2;
            goto c2max_done;
          }
c2max_done:
  // 2-norm of scaled box extents (biases against long thin boxes and
  // makes volume > 0 the splittability test)
  long d0 = ((c0max - c0min) << kC0Shift) * kScale0;
  long d1 = ((c1max - c1min) << kC1Shift) * kScale1;
  long d2 = ((c2max - c2min) << kC2Shift) * kScale2;
  b->volume = d0 * d0 + d1 * d1 + d2 * d2;
  long n = 0;
  for (int c0 = c0min; c0 <= c0max; c0++)
    for (int c1 = c1min; c1 <= c1max; c1++)
      for (int c2 = c2min; c2 <= c2max; c2++)
        if (*cell(q, c0, c1, c2)) n++;
  b->colorcount = n;
}

int median_cut(Quant2 *q, Box *boxes, int nboxes, int desired) {
  while (nboxes < desired) {
    Box *b1 = nullptr;
    if (nboxes * 2 <= desired) {      // first half: split most-populous
      long best = 0;
      for (int i = 0; i < nboxes; i++)
        if (boxes[i].colorcount > best && boxes[i].volume > 0) {
          b1 = &boxes[i];
          best = boxes[i].colorcount;
        }
    } else {                          // then: split biggest scaled volume
      long best = 0;
      for (int i = 0; i < nboxes; i++)
        if (boxes[i].volume > best) {
          b1 = &boxes[i];
          best = boxes[i].volume;
        }
    }
    if (!b1) break;
    Box *b2 = &boxes[nboxes];
    *b2 = *b1;
    // split along the longest scaled axis; ties favor green, red, blue
    int d0 = ((b1->c0max - b1->c0min) << kC0Shift) * kScale0;
    int d1 = ((b1->c1max - b1->c1min) << kC1Shift) * kScale1;
    int d2 = ((b1->c2max - b1->c2min) << kC2Shift) * kScale2;
    int axis = 1, dmax = d1;
    if (d0 > dmax) { dmax = d0; axis = 0; }
    if (d2 > dmax) { axis = 2; }
    switch (axis) {
      case 0: {
        int lb = (b1->c0max + b1->c0min) / 2;
        b1->c0max = lb;
        b2->c0min = lb + 1;
        break;
      }
      case 1: {
        int lb = (b1->c1max + b1->c1min) / 2;
        b1->c1max = lb;
        b2->c1min = lb + 1;
        break;
      }
      default: {
        int lb = (b1->c2max + b1->c2min) / 2;
        b1->c2max = lb;
        b2->c2min = lb + 1;
        break;
      }
    }
    shrink_box(q, b1);
    shrink_box(q, b2);
    nboxes++;
  }
  return nboxes;
}

void box_color(Quant2 *q, const Box *b, int icolor) {
  // pixel-weighted mean over cell centers, rounded
  long total = 0, t0 = 0, t1 = 0, t2 = 0;
  for (int c0 = b->c0min; c0 <= b->c0max; c0++)
    for (int c1 = b->c1min; c1 <= b->c1max; c1++)
      for (int c2 = b->c2min; c2 <= b->c2max; c2++) {
        long count = *cell(q, c0, c1, c2);
        if (count) {
          total += count;
          t0 += ((c0 << kC0Shift) + ((1 << kC0Shift) >> 1)) * count;
          t1 += ((c1 << kC1Shift) + ((1 << kC1Shift) >> 1)) * count;
          t2 += ((c2 << kC2Shift) + ((1 << kC2Shift) >> 1)) * count;
        }
      }
  if (total == 0) return;  // empty histogram (0-pixel image): keep zeros
  q->cmap[0][icolor] = (uint8_t)((t0 + (total >> 1)) / total);
  q->cmap[1][icolor] = (uint8_t)((t1 + (total >> 1)) / total);
  q->cmap[2][icolor] = (uint8_t)((t2 + (total >> 1)) / total);
}

void select_colors(Quant2 *q, int desired) {
  Box boxes[kMaxColors];
  boxes[0] = {0, 255 >> kC0Shift, 0, 255 >> kC1Shift,
              0, 255 >> kC2Shift, 0, 0};
  shrink_box(q, &boxes[0]);
  int nboxes = median_cut(q, boxes, 1, desired);
  for (int i = 0; i < nboxes; i++) box_color(q, &boxes[i], i);
  q->ncolors = nboxes;
}

// ---- inverse colormap: candidate pruning + incremental distances ----

int nearby_colors(Quant2 *q, int minc0, int minc1, int minc2,
                  uint8_t *colorlist) {
  int maxc0 = minc0 + ((1 << kBoxC0Shift) - (1 << kC0Shift));
  int centerc0 = (minc0 + maxc0) >> 1;
  int maxc1 = minc1 + ((1 << kBoxC1Shift) - (1 << kC1Shift));
  int centerc1 = (minc1 + maxc1) >> 1;
  int maxc2 = minc2 + ((1 << kBoxC2Shift) - (1 << kC2Shift));
  int centerc2 = (minc2 + maxc2) >> 1;

  int32_t mindist[kMaxColors];
  int32_t minmax = 0x7FFFFFFF;
  for (int i = 0; i < q->ncolors; i++) {
    int32_t mn, mx, t;
    int x = q->cmap[0][i];
    if (x < minc0) {
      t = (x - minc0) * kScale0; mn = t * t;
      t = (x - maxc0) * kScale0; mx = t * t;
    } else if (x > maxc0) {
      t = (x - maxc0) * kScale0; mn = t * t;
      t = (x - minc0) * kScale0; mx = t * t;
    } else {
      mn = 0;
      t = (x <= centerc0 ? x - maxc0 : x - minc0) * kScale0;
      mx = t * t;
    }
    x = q->cmap[1][i];
    if (x < minc1) {
      t = (x - minc1) * kScale1; mn += t * t;
      t = (x - maxc1) * kScale1; mx += t * t;
    } else if (x > maxc1) {
      t = (x - maxc1) * kScale1; mn += t * t;
      t = (x - minc1) * kScale1; mx += t * t;
    } else {
      t = (x <= centerc1 ? x - maxc1 : x - minc1) * kScale1;
      mx += t * t;
    }
    x = q->cmap[2][i];
    if (x < minc2) {
      t = (x - minc2) * kScale2; mn += t * t;
      t = (x - maxc2) * kScale2; mx += t * t;
    } else if (x > maxc2) {
      t = (x - maxc2) * kScale2; mn += t * t;
      t = (x - minc2) * kScale2; mx += t * t;
    } else {
      t = (x <= centerc2 ? x - maxc2 : x - minc2) * kScale2;
      mx += t * t;
    }
    mindist[i] = mn;
    if (mx < minmax) minmax = mx;
  }
  int n = 0;
  for (int i = 0; i < q->ncolors; i++)
    if (mindist[i] <= minmax) colorlist[n++] = (uint8_t)i;
  return n;
}

void best_colors(Quant2 *q, int minc0, int minc1, int minc2, int ncand,
                 const uint8_t *colorlist, uint8_t *bestcolor) {
  constexpr int kStep0 = (1 << kC0Shift) * kScale0;
  constexpr int kStep1 = (1 << kC1Shift) * kScale1;
  constexpr int kStep2 = (1 << kC2Shift) * kScale2;
  int32_t bestdist[kBoxC0 * kBoxC1 * kBoxC2];
  for (int i = 0; i < kBoxC0 * kBoxC1 * kBoxC2; i++)
    bestdist[i] = 0x7FFFFFFF;

  for (int i = 0; i < ncand; i++) {
    int icolor = colorlist[i];
    int32_t inc0 = (minc0 - q->cmap[0][icolor]) * kScale0;
    int32_t dist0 = inc0 * inc0;
    int32_t inc1 = (minc1 - q->cmap[1][icolor]) * kScale1;
    dist0 += inc1 * inc1;
    int32_t inc2 = (minc2 - q->cmap[2][icolor]) * kScale2;
    dist0 += inc2 * inc2;
    inc0 = inc0 * (2 * kStep0) + kStep0 * kStep0;
    inc1 = inc1 * (2 * kStep1) + kStep1 * kStep1;
    inc2 = inc2 * (2 * kStep2) + kStep2 * kStep2;
    int32_t *bp = bestdist;
    uint8_t *cp = bestcolor;
    int32_t xx0 = inc0;
    for (int ic0 = 0; ic0 < kBoxC0; ic0++) {
      int32_t dist1 = dist0, xx1 = inc1;
      for (int ic1 = 0; ic1 < kBoxC1; ic1++) {
        int32_t dist2 = dist1, xx2 = inc2;
        for (int ic2 = 0; ic2 < kBoxC2; ic2++) {
          if (dist2 < *bp) {
            *bp = dist2;
            *cp = (uint8_t)icolor;
          }
          dist2 += xx2;
          xx2 += 2 * kStep2 * kStep2;
          bp++;
          cp++;
        }
        dist1 += xx1;
        xx1 += 2 * kStep1 * kStep1;
      }
      dist0 += xx0;
      xx0 += 2 * kStep0 * kStep0;
    }
  }
}

void fill_inverse(Quant2 *q, int c0, int c1, int c2) {
  c0 >>= kBoxC0Log;
  c1 >>= kBoxC1Log;
  c2 >>= kBoxC2Log;
  int minc0 = (c0 << kBoxC0Shift) + ((1 << kC0Shift) >> 1);
  int minc1 = (c1 << kBoxC1Shift) + ((1 << kC1Shift) >> 1);
  int minc2 = (c2 << kBoxC2Shift) + ((1 << kC2Shift) >> 1);
  uint8_t colorlist[kMaxColors];
  uint8_t bestcolor[kBoxC0 * kBoxC1 * kBoxC2];
  int ncand = nearby_colors(q, minc0, minc1, minc2, colorlist);
  best_colors(q, minc0, minc1, minc2, ncand, colorlist, bestcolor);
  c0 <<= kBoxC0Log;
  c1 <<= kBoxC1Log;
  c2 <<= kBoxC2Log;
  const uint8_t *cp = bestcolor;
  for (int ic0 = 0; ic0 < kBoxC0; ic0++)
    for (int ic1 = 0; ic1 < kBoxC1; ic1++)
      for (int ic2 = 0; ic2 < kBoxC2; ic2++)
        *cell(q, c0 + ic0, c1 + ic1, c2 + ic2) = (uint16_t)(*cp++ + 1);
}

inline int lookup(Quant2 *q, int r, int g, int b) {
  int c0 = r >> kC0Shift, c1 = g >> kC1Shift, c2 = b >> kC2Shift;
  uint16_t *cp = cell(q, c0, c1, c2);
  if (*cp == 0) fill_inverse(q, c0, c1, c2);
  return *cp - 1;
}

// error-limit transfer function: 1:1 to 16, 1:2 to 48, clamp at 32
void build_error_limit(int *table /* centered at +255 */) {
  int *t = table + 255;
  int out = 0;
  int in = 0;
  for (; in < 16; in++, out++) { t[in] = out; t[-in] = -out; }
  for (; in < 48; in++, out += (in & 1) ? 0 : 1) {
    t[in] = out; t[-in] = -out;
  }
  for (; in <= 255; in++) { t[in] = out; t[-in] = -out; }
}

inline int clamp255(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }

}  // namespace

extern "C" {

// rgb: (h, w, 3) uint8; out_idx: (h, w) uint8; out_cmap: 3*256 uint8.
// dither: 0 = none, 1 = Floyd-Steinberg.  Returns the actual number of
// colormap entries (may be less than requested).
static void run_pass2(Quant2 *q, const uint8_t *rgb, int w, int h,
                      int dither, uint8_t *out_idx) {
  // re-use the histogram as the inverse-cmap cache
  memset(q->hist, 0, sizeof(q->hist));

  if (!dither) {
    for (long i = 0; i < (long)w * h; i++) {
      const uint8_t *p = rgb + i * 3;
      out_idx[i] = (uint8_t)lookup(q, p[0], p[1], p[2]);
    }
  } else {
    // serpentine FS dither, errors stored *16 in an int16 row array
    int errlimit[511];
    build_error_limit(errlimit);
    const int *elim = errlimit + 255;
    int16_t *fserr = (int16_t *)calloc((size_t)(w + 2) * 3,
                                       sizeof(int16_t));
    if (!fserr) return;
    bool odd = false;
    for (int row = 0; row < h; row++) {
      const uint8_t *in = rgb + (size_t)row * w * 3;
      uint8_t *out = out_idx + (size_t)row * w;
      int dir, dir3;
      int16_t *ep;
      if (odd) {
        in += (w - 1) * 3;
        out += w - 1;
        dir = -1;
        dir3 = -3;
        ep = fserr + (size_t)(w + 1) * 3;
      } else {
        dir = 1;
        dir3 = 3;
        ep = fserr;
      }
      odd = !odd;
      int cur0 = 0, cur1 = 0, cur2 = 0;
      int below0 = 0, below1 = 0, below2 = 0;
      int bprev0 = 0, bprev1 = 0, bprev2 = 0;
      for (int col = 0; col < w; col++) {
        cur0 = (cur0 + ep[dir3 + 0] + 8) >> 4;
        cur1 = (cur1 + ep[dir3 + 1] + 8) >> 4;
        cur2 = (cur2 + ep[dir3 + 2] + 8) >> 4;
        cur0 = elim[cur0];
        cur1 = elim[cur1];
        cur2 = elim[cur2];
        cur0 = clamp255(cur0 + in[0]);
        cur1 = clamp255(cur1 + in[1]);
        cur2 = clamp255(cur2 + in[2]);
        int pix = lookup(q, cur0, cur1, cur2);
        *out = (uint8_t)pix;
        cur0 -= q->cmap[0][pix];
        cur1 -= q->cmap[1][pix];
        cur2 -= q->cmap[2][pix];
        int bnext = cur0;
        ep[0] = (int16_t)(bprev0 + cur0 * 3);
        bprev0 = below0 + cur0 * 5;
        below0 = bnext;
        cur0 *= 7;
        bnext = cur1;
        ep[1] = (int16_t)(bprev1 + cur1 * 3);
        bprev1 = below1 + cur1 * 5;
        below1 = bnext;
        cur1 *= 7;
        bnext = cur2;
        ep[2] = (int16_t)(bprev2 + cur2 * 3);
        bprev2 = below2 + cur2 * 5;
        below2 = bnext;
        cur2 *= 7;
        in += dir3;
        out += dir;
        ep += dir3;
      }
      ep[0] = (int16_t)bprev0;
      ep[1] = (int16_t)bprev1;
      ep[2] = (int16_t)bprev2;
    }
    free(fserr);
  }
}

int mj_quantize_colors(const uint8_t *rgb, int w, int h, int desired,
                       int dither, uint8_t *out_idx, uint8_t *out_cmap) {
  if (desired < 1 || desired > kMaxColors) return -1;
  Quant2 *q = (Quant2 *)calloc(1, sizeof(Quant2));
  if (!q) return -1;

  // pass 1: histogram (16-bit cells saturate at 65535)
  for (long i = 0; i < (long)w * h; i++) {
    const uint8_t *p = rgb + i * 3;
    uint16_t *cp = cell(q, p[0] >> kC0Shift, p[1] >> kC1Shift,
                        p[2] >> kC2Shift);
    if ((uint16_t)(*cp + 1) != 0) (*cp)++;
  }
  select_colors(q, desired);

  run_pass2(q, rgb, w, h, dither, out_idx);

  memcpy(out_cmap, q->cmap[0], kMaxColors);
  memcpy(out_cmap + kMaxColors, q->cmap[1], kMaxColors);
  memcpy(out_cmap + 2 * kMaxColors, q->cmap[2], kMaxColors);
  int n = q->ncolors;
  free(q);
  return n;
}


// Quantize to a SUPPLIED colormap (djpeg -map FILE, rdcolmap.c feeding
// jquant2's pass2 machinery: inverse colormap + optional FS dither).
int mj_quantize_to_map(const uint8_t *rgb, int w, int h,
                       const uint8_t *cmap_rgb, int ncolors, int dither,
                       uint8_t *out_idx) {
  if (ncolors < 1 || ncolors > kMaxColors) return -1;
  Quant2 *q = (Quant2 *)calloc(1, sizeof(Quant2));
  if (!q) return -1;
  for (int i = 0; i < ncolors; i++) {
    q->cmap[0][i] = cmap_rgb[i * 3 + 0];
    q->cmap[1][i] = cmap_rgb[i * 3 + 1];
    q->cmap[2][i] = cmap_rgb[i * 3 + 2];
  }
  q->ncolors = ncolors;
  run_pass2(q, rgb, w, h, dither, out_idx);
  free(q);
  return ncolors;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// One-pass quantizer: fixed orthogonal palette with optional ordered or
// Floyd-Steinberg dithering — numerics of /root/reference/jquant1.c
// (select_ncolors division of colors, premultiplied color index tables,
// Bayer order-4 dither matrix scaled per component, serpentine FS).
// ---------------------------------------------------------------------------

namespace {

constexpr int kOD = 16;                    // ordered dither matrix dim
constexpr int kODCells = kOD * kOD;

const uint8_t kBayer[kOD][kOD] = {
  {   0, 192,  48, 240,  12, 204,  60, 252,   3, 195,  51, 243,  15, 207,  63, 255 },
  { 128,  64, 176, 112, 140,  76, 188, 124, 131,  67, 179, 115, 143,  79, 191, 127 },
  {  32, 224,  16, 208,  44, 236,  28, 220,  35, 227,  19, 211,  47, 239,  31, 223 },
  { 160,  96, 144,  80, 172, 108, 156,  92, 163,  99, 147,  83, 175, 111, 159,  95 },
  {   8, 200,  56, 248,   4, 196,  52, 244,  11, 203,  59, 251,   7, 199,  55, 247 },
  { 136,  72, 184, 120, 132,  68, 180, 116, 139,  75, 187, 123, 135,  71, 183, 119 },
  {  40, 232,  24, 216,  36, 228,  20, 212,  43, 235,  27, 219,  39, 231,  23, 215 },
  { 168, 104, 152,  88, 164, 100, 148,  84, 171, 107, 155,  91, 167, 103, 151,  87 },
  {   2, 194,  50, 242,  14, 206,  62, 254,   1, 193,  49, 241,  13, 205,  61, 253 },
  { 130,  66, 178, 114, 142,  78, 190, 126, 129,  65, 177, 113, 141,  77, 189, 125 },
  {  34, 226,  18, 210,  46, 238,  30, 222,  33, 225,  17, 209,  45, 237,  29, 221 },
  { 162,  98, 146,  82, 174, 110, 158,  94, 161,  97, 145,  81, 173, 109, 157,  93 },
  {  10, 202,  58, 250,   6, 198,  54, 246,   9, 201,  57, 249,   5, 197,  53, 245 },
  { 138,  74, 186, 122, 134,  70, 182, 118, 137,  73, 185, 121, 133,  69, 181, 117 },
  {  42, 234,  26, 218,  38, 230,  22, 214,  41, 233,  25, 217,  37, 229,  21, 213 },
  { 170, 106, 154,  90, 166, 102, 150,  86, 169, 105, 153,  89, 165, 101, 149,  85 },
};

int select_ncolors1(int nc, int max_colors, int *Ncolors) {
  // nc'th root, then increment per component in G,R,B priority order
  int iroot = 1;
  long temp;
  do {
    iroot++;
    temp = iroot;
    for (int i = 1; i < nc; i++) temp *= iroot;
  } while (temp <= (long)max_colors);
  iroot--;
  if (iroot < 2) return -1;
  int total = 1;
  for (int i = 0; i < nc; i++) {
    Ncolors[i] = iroot;
    total *= iroot;
  }
  const int order3[3] = {1, 0, 2};         // G, R, B
  bool changed;
  do {
    changed = false;
    for (int i = 0; i < nc; i++) {
      int j = (nc == 3) ? order3[i] : i;
      long t = (long)total / Ncolors[j] * (Ncolors[j] + 1);
      if (t > (long)max_colors) break;
      Ncolors[j]++;
      total = (int)t;
      changed = true;
    }
  } while (changed);
  return total;
}

inline int out_value1(int j, int maxj) {
  return (int)(((long)j * 255 + maxj / 2) / maxj);
}

inline int largest_input1(int j, int maxj) {
  return (int)(((long)(2 * j + 1) * 255 + maxj) / (2 * maxj));
}

}  // namespace

extern "C" {

// One-pass quantization.  dither: 0 = none, 1 = ordered, 2 = FS.
// gray != 0 treats rgb as a single-channel (h, w) buffer.
int mj_quantize_onepass(const uint8_t *rgb, int w, int h, int desired,
                        int dither, int gray, uint8_t *out_idx,
                        uint8_t *out_cmap) {
  int nc = gray ? 1 : 3;
  if (desired < 1 || desired > 256) return -1;  // MAX_Q_COLORS (jquant1.c)
  int Ncolors[3];
  int total = select_ncolors1(nc, desired, Ncolors);
  if (total < 0 || total > 256) return -1;

  // colormap: row-major, rightmost component varies fastest
  uint8_t cmap[3][kMaxColors];
  int blkdist = total;
  for (int i = 0; i < nc; i++) {
    int nci = Ncolors[i];
    int blksize = blkdist / nci;
    for (int j = 0; j < nci; j++) {
      int val = out_value1(j, nci - 1);
      for (int ptr = j * blksize; ptr < total; ptr += blkdist)
        for (int k = 0; k < blksize; k++) cmap[i][ptr + k] = (uint8_t)val;
    }
    blkdist = blksize;
  }

  // premultiplied color index tables, padded +-255 for ordered dither
  static thread_local uint8_t cindex[3][255 + 256 + 511];
  uint8_t *ci[3];
  int blksize = total;
  for (int i = 0; i < nc; i++) {
    int nci = Ncolors[i];
    blksize = blksize / nci;
    ci[i] = cindex[i] + 255;
    int val = 0;
    int k = largest_input1(0, nci - 1);
    for (int j = 0; j <= 255; j++) {
      while (j > k) k = largest_input1(++val, nci - 1);
      ci[i][j] = (uint8_t)(val * blksize);
    }
    for (int j = 1; j <= 255; j++) {
      ci[i][-j] = ci[i][0];
      ci[i][255 + j] = ci[i][255];
    }
  }

  if (dither == 1) {
    // per-component scaled Bayer matrices
    static thread_local int od[3][kOD][kOD];
    for (int i = 0; i < nc; i++) {
      long den = 2L * kODCells * (Ncolors[i] - 1);
      for (int j = 0; j < kOD; j++)
        for (int k = 0; k < kOD; k++) {
          long num = ((long)(kODCells - 1 - 2 * (int)kBayer[j][k])) * 255;
          od[i][j][k] = (int)(num < 0 ? -((-num) / den) : num / den);
        }
    }
    int row_index = 0;
    for (int row = 0; row < h; row++) {
      for (long c = 0; c < w; c++) out_idx[(long)row * w + c] = 0;
      for (int i = 0; i < nc; i++) {
        const uint8_t *in = rgb + (long)row * w * nc + i;
        uint8_t *out = out_idx + (long)row * w;
        const int *dith = od[i][row_index];
        int col_index = 0;
        for (int col = 0; col < w; col++) {
          *out += ci[i][(int)*in + dith[col_index]];
          in += nc;
          out++;
          col_index = (col_index + 1) & (kOD - 1);
        }
      }
      row_index = (row_index + 1) & (kOD - 1);
    }
  } else if (dither == 2) {
    int16_t *fserr = (int16_t *)calloc((size_t)(w + 2) * nc,
                                       sizeof(int16_t));
    if (!fserr) return -1;
    bool odd = false;
    for (int row = 0; row < h; row++) {
      for (long c = 0; c < w; c++) out_idx[(long)row * w + c] = 0;
      for (int i = 0; i < nc; i++) {
        const uint8_t *in = rgb + (long)row * w * nc + i;
        uint8_t *out = out_idx + (long)row * w;
        int16_t *ep = fserr + (size_t)i * (w + 2);
        int dir, dirnc;
        if (odd) {
          in += (long)(w - 1) * nc;
          out += w - 1;
          dir = -1;
          dirnc = -nc;
          ep += w + 1;
        } else {
          dir = 1;
          dirnc = nc;
        }
        int cur = 0, belowerr = 0, bpreverr = 0;
        for (int col = 0; col < w; col++) {
          cur = (cur + ep[dir] + 8) >> 4;
          cur = clamp255(cur + *in);
          int pixcode = ci[i][cur];
          *out += (uint8_t)pixcode;
          cur -= cmap[i][pixcode];
          int bnexterr = cur;
          int delta = cur * 2;
          cur += delta;
          ep[0] = (int16_t)(bpreverr + cur);
          cur += delta;
          bpreverr = belowerr + cur;
          belowerr = bnexterr;
          cur += delta;
          in += dirnc;
          out += dir;
          ep += dir;
        }
        ep[0] = (int16_t)bpreverr;
      }
      odd = !odd;
    }
    free(fserr);
  } else {
    for (long p = 0; p < (long)w * h; p++) {
      const uint8_t *in = rgb + p * nc;
      int code = 0;
      for (int i = 0; i < nc; i++) code += ci[i][in[i]];
      out_idx[p] = (uint8_t)code;
    }
  }

  for (int i = 0; i < 3; i++)
    memcpy(out_cmap + i * kMaxColors, cmap[i < nc ? i : 0], kMaxColors);
  return total;
}

}  // extern "C"
