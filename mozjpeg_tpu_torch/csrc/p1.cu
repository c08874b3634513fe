// p1 of the encoder's islow path as two kernels: the per-block chain
// (deringing, islow FDCT, quantization, the post-dering clamp, zigzag, the
// f32 norm and the within-block AC-first symbols) and the cross-block EOB
// runs of the AC-first histogram.
//
// Neither replaces a Pallas kernel. They replace XLA code of the JAX
// package's p1 that the port first ran as whole-tensor PyTorch ops, about
// 640 launches a component (the 64-step dering scan, the butterflies, the
// zigzag gathers, the 63 serial norm adds, the histogram's cummax and
// bincount chain):
//   - p1_blocks_kernel: mozjpeg_tpu/codec/pipeline_t.py:413-455 (_p1_raw's
//     islow branch) with ops/dering.py dering_t, ops/dct.py fdct_islow_t,
//     ops/quant.py quantize_islow_t, _norm_seq (:80) and the within-block
//     half of ops/symbols.py _ac_first_hist_seg; mozjpeg's
//     preprocess_deringing (jcdctmgr.c:416-498), jpeg_fdct_islow
//     (jfdctint.c) and quantize (jcdctmgr.c:181-230);
//   - p1_eob_hist_kernel: the cross-block half of _ac_first_hist_seg
//     (ops/symbols.py:121-214): the EOB runs of jcphuff.c
//     encode_mcu_AC_first, with the 0x7FFF forced flush and the flush at
//     each restart.
//
// Bound: bytes. A block reads 64 samples (64 B at 8 bits, 256 at 12) and
// writes 64 int16 + 64 int32 coefficients, its norm and a flag byte (389
// B at 8 bits); its arithmetic is a few hundred integer operations and at
// most 64 f32 curve points, far under the card's rates. What the design
// does about it: one thread per 8x8 block, threads of a warp on
// neighbouring blocks of a block row, so that the coefficient-major
// stores (coefficient k of blocks n..n+31 are neighbours) coalesce and
// each sample row is read once; the samples, the FDCT and the quantized
// values stay in registers (every index into them is a compile-time
// constant after unrolling), and only deringing's run walk, whose indices
// are data-dependent, goes through a 64-entry local array, and only for
// the blocks that hold a clipped sample. The symbol counts go to a
// histogram per warp in shared memory (symbol 0x01 is hot: one address
// for the whole CTA would serialise every warp on it), summed and added
// to the image's histogram once per CTA. The EOB kernel reads one flag
// byte a block and is bound by the runs' chain, not by bytes: fixed tiles
// of 256 blocks, a warp each, walk their 8 chunks of 32 with
// __ballot_sync whatever the restart interval, and the last CTA of each
// image joins the tiles' runs in the same launch (a scan of the tiles'
// summaries).
//
// Exactness (the plain versions in ops/p1.py are the spec): int32
// arithmetic that the JAX program lets wrap is computed unsigned, whose
// wrap is defined; C division truncates like the plain version's
// rounding_mode="trunc", and the quantizer's floor division is written
// out; build with -fmad=false, every f32 operation of the dering curve
// and the norm is an explicit _rn intrinsic in the plain version's order,
// and the step 1/(len + 1) is an IEEE division. The run walk rewrites the
// block in place, as hostenc.cpp's does, while the plain version derives
// every run from the samples as they came in; the two agree because only
// a run's f2 edge can read an earlier run's new value, and a new value is
// either >= 127 (then f1 - f2 < 0 < 127 - f1 and the slope is 127 - f1
// either way) or the cap below 127, which every value of the later run
// takes whatever its slope (the curve never falls under 127).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int TPB = 256;             // blocks (threads) per CTA of p1_blocks
constexpr int WARPS = TPB / 32;
static_assert(TPB == 256, "the histogram flush gives each thread one bin");
constexpr int EOB_TILE = 256;        // blocks a warp of the EOB kernel walks
constexpr int EOB_CHUNKS = EOB_TILE / 32;
constexpr int EOB_WARPS = 8;         // tiles (warps) per CTA of the EOB kernel
constexpr int EOB_THREADS = EOB_WARPS * 32;
constexpr int MAXS = 127;            // 255 - CENTERJSAMPLE at every precision
constexpr int CONST_BITS = 13;
constexpr int EOB_MAX = 0x7FFF;      // jcphuff.c's forced EOBRUN flush

// the quant table, natural order, and (q << 3) in zigzag order
struct P1Tables {
  int qv_zz[64];
  int q0;
};

// natural index of zigzag position i (jpeg_natural_order); called with a
// compile-time index after unrolling, so it folds to a constant
__host__ __device__ constexpr int zz_nat(int i) {
  const int t[64] = {
      0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
      12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
      35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
      58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
  return t[i];
}

__device__ __forceinline__ int nbits(int v) {  // JPEG_NBITS for v >= 0
  return v > 0 ? 32 - __clz(v) : 0;
}

// int32 arithmetic with two's complement wrap, as the JAX program's
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}
__device__ __forceinline__ int wshl(int a, int s) {
  return (int)((unsigned)a << s);
}
// C's DESCALE: (x + 2^(n-1)) >> n, an arithmetic shift
__device__ __forceinline__ int descale(int x, int n) {
  return wadd(x, 1 << (n - 1)) >> n;
}

// One 1-D LLM forward pass over d0..d7 (ops/dct.py _fdct_butterfly):
// shift_even >= 0 shifts the even outputs 0/4 left (pass 1), < 0
// descales them by -shift_even (pass 2).
__device__ __forceinline__ void fdct_1d(int& d0, int& d1, int& d2, int& d3,
                                        int& d4, int& d5, int& d6, int& d7,
                                        int shift_even, int descale_n) {
  const int tmp0 = wadd(d0, d7), tmp7 = wsub(d0, d7);
  const int tmp1 = wadd(d1, d6), tmp6 = wsub(d1, d6);
  const int tmp2 = wadd(d2, d5), tmp5 = wsub(d2, d5);
  const int tmp3 = wadd(d3, d4), tmp4 = wsub(d3, d4);
  const int tmp10 = wadd(tmp0, tmp3), tmp13 = wsub(tmp0, tmp3);
  const int tmp11 = wadd(tmp1, tmp2), tmp12 = wsub(tmp1, tmp2);
  if (shift_even >= 0) {
    d0 = wshl(wadd(tmp10, tmp11), shift_even);
    d4 = wshl(wsub(tmp10, tmp11), shift_even);
  } else {
    d0 = descale(wadd(tmp10, tmp11), -shift_even);
    d4 = descale(wsub(tmp10, tmp11), -shift_even);
  }
  int z1 = wmul(wadd(tmp12, tmp13), 4433);                 // FIX_0_541196100
  d2 = descale(wadd(z1, wmul(tmp13, 6270)), descale_n);    // FIX_0_765366865
  d6 = descale(wadd(z1, wmul(tmp12, -15137)), descale_n);  // FIX_1_847759065
  z1 = wadd(tmp4, tmp7);
  int z2 = wadd(tmp5, tmp6);
  int z3 = wadd(tmp4, tmp6);
  int z4 = wadd(tmp5, tmp7);
  const int z5 = wmul(wadd(z3, z4), 9633);                 // FIX_1_175875602
  const int t4 = wmul(tmp4, 2446);                         // FIX_0_298631336
  const int t5 = wmul(tmp5, 16819);                        // FIX_2_053119869
  const int t6 = wmul(tmp6, 25172);                        // FIX_3_072711026
  const int t7 = wmul(tmp7, 12299);                        // FIX_1_501321110
  z1 = wmul(z1, -7373);                                    // FIX_0_899976223
  z2 = wmul(z2, -20995);                                   // FIX_2_562915447
  z3 = wadd(wmul(z3, -16069), z5);                         // FIX_1_961570560
  z4 = wadd(wmul(z4, -3196), z5);                          // FIX_0_390180644
  d7 = descale(wadd(wadd(t4, z1), z3), descale_n);
  d5 = descale(wadd(wadd(t5, z2), z4), descale_n);
  d3 = descale(wadd(wadd(t6, z2), z3), descale_n);
  d1 = descale(wadd(wadd(t7, z1), z4), descale_n);
}

// Overshoot deringing of one block (ops/dering.py dering_t): zz the
// block's 64 centered samples in zigzag order, m its clipped positions
// (bit i: zz[i] >= 127), 0 < cnt < 64 of them, total their sum.
__device__ void dering_zz(int* zz, unsigned long long m, int cnt, int total,
                          int q0) {
  // C's int division truncates toward zero (the numerator can go
  // negative at 12 bits)
  const int headroom = (MAXS * 64 - total) / cnt;
  const int cap0 = 2 * q0 < 31 ? 2 * q0 : 31;
  const int maxover = MAXS + (headroom < cap0 ? headroom : cap0);
  unsigned long long rem = m;
  while (rem) {
    const int a = __ffsll((long long)rem) - 1;
    const unsigned long long open = ~m >> a;   // the unclipped from a on
    const int b = open ? a + __ffsll((long long)open) - 1 : 64;
    rem = b >= 64 ? 0ull : rem & (~0ull << b);
    // edge samples, clamped at the block's ends as the plain version's
    // seeded hold
    const int f1 = a > 0 ? zz[a - 1] : zz[0];
    const int f2 = a >= 2 ? zz[a - 2] : zz[0];
    const int l1 = b < 64 ? zz[b] : zz[63];
    const int l2 = b + 1 < 64 ? zz[b + 1] : zz[63];
    int fslope = f1 - f2 > MAXS - f1 ? f1 - f2 : MAXS - f1;
    int lslope = l1 - l2 > MAXS - l1 ? l1 - l2 : MAXS - l1;
    if (a == 0) fslope = lslope;
    if (b == 64) lslope = fslope;   // a == 0 && b == 64 is cnt == 64
    const int length = b - a;
    const float step = __fdiv_rn(1.0f, (float)(length + 1));
    const float tan1 = (float)(fslope * length);
    const float tan2 = (float)(-lslope * length);
    float t = 0.0f;
    for (int i = a; i < b; ++i) {
      t = i == a ? step : __fadd_rn(t, step);
      const float t2 = __fmul_rn(t, t);
      const float t3 = __fmul_rn(t2, t);
      const float cf1 = __fadd_rn(
          __fsub_rn(__fmul_rn(2.0f, t3), __fmul_rn(3.0f, t2)), 1.0f);
      const float cf2 = __fadd_rn(__fmul_rn(-2.0f, t3), __fmul_rn(3.0f, t2));
      const float cf3 = __fadd_rn(__fsub_rn(t3, __fmul_rn(2.0f, t2)), t);
      const float cf4 = __fsub_rn(t3, t2);
      const float val = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(127.0f, cf1), __fmul_rn(tan1, cf3)),
                    __fmul_rn(127.0f, cf2)),
          __fmul_rn(tan2, cf4));
      const int nv = (int)ceilf(val);
      zz[i] = nv < maxover ? nv : maxover;
    }
  }
}

// Sample value of one plane element, centered.
__device__ __forceinline__ int sample(const uint8_t* p, int center) {
  return (int)*p - center;
}
__device__ __forceinline__ int sample(const int32_t* p, int center) {
  return wsub(*p, center);
}

// One thread per 8x8 block; grid (ceil(n / TPB), B), blockIdx.y the image.
// plane: the image's samples at plane + b*s_img + y*s_row + x*s_col
// (elements). Outputs: q_zz / raw_zz (64, N) zigzag coefficient-major,
// norm (N,), flags (N,) (bit 0: a nonzero AC in [1, 63], bit 1:
// coefficient 63 is zero), and the within-block AC-first symbols added
// into hist (B, 256).
template <typename T>
__global__ void __launch_bounds__(TPB)
p1_blocks_kernel(const T* __restrict__ plane, long long s_img,
                 long long s_row, long long s_col, int bh, int bw,
                 long long N, P1Tables tab, int dering_on, int precision,
                 int16_t* __restrict__ q_zz, int32_t* __restrict__ raw_zz,
                 float* __restrict__ norm, int32_t* __restrict__ hist,
                 uint8_t* __restrict__ flags) {
  __shared__ int hs[WARPS][256];
  for (int i = threadIdx.x; i < WARPS * 256; i += TPB) (&hs[0][0])[i] = 0;
  __syncthreads();
  const int b = blockIdx.y;
  const long long n = (long long)bh * bw;
  const long long i = (long long)blockIdx.x * TPB + threadIdx.x;
  int* h = hs[threadIdx.x >> 5];
  if (i < n) {
    const int br = (int)(i / bw), bc = (int)(i % bw);
    const int center = 1 << (precision - 1);
    const int pass1 = precision == 8 ? 2 : 1;
    const T* src = plane + b * s_img + (long long)br * 8 * s_row
                   + (long long)bc * 8 * s_col;
    int blk[64];                                   // natural order
#pragma unroll
    for (int y = 0; y < 8; ++y)
#pragma unroll
      for (int x = 0; x < 8; ++x)
        blk[y * 8 + x] = sample(src + y * s_row + x * s_col, center);

    if (dering_on) {
      unsigned long long m = 0;
      int cnt = 0, total = 0;
#pragma unroll
      for (int k = 0; k < 64; ++k) {
        const int v = blk[zz_nat(k)];
        total += v;
        const bool c = v >= MAXS;
        cnt += c;
        m |= (unsigned long long)c << k;
      }
      if (cnt > 0 && cnt < 64) {
        int zz[64];
#pragma unroll
        for (int k = 0; k < 64; ++k) zz[k] = blk[zz_nat(k)];
        dering_zz(zz, m, cnt, total, tab.q0);
#pragma unroll
        for (int k = 0; k < 64; ++k) blk[zz_nat(k)] = zz[k];
      }
    }

#pragma unroll
    for (int r = 0; r < 8; ++r) {
      int* d = blk + 8 * r;
      fdct_1d(d[0], d[1], d[2], d[3], d[4], d[5], d[6], d[7], pass1,
              CONST_BITS - pass1);
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      int* d = blk + c;
      fdct_1d(d[0], d[8], d[16], d[24], d[32], d[40], d[48], d[56], -pass1,
              CONST_BITS + pass1);
    }

    // zigzag, quantize (round half away from zero by 8q), the post-dering
    // clamp, and the within-block AC-first symbols of band [1, 63]
    const long long gi = (long long)b * n + i;
    const int maxc = (1 << (precision + 2)) - 1;
    int run = 0, zrl = 0;
    bool any = false;
    int last = 0;
#pragma unroll
    for (int k = 0; k < 64; ++k) {
      const int c = blk[zz_nat(k)];
      const int q = tab.qv_zz[k];
      const int a = c < 0 ? wsub(0, c) : c;
      const int s = wadd(a, q >> 1);
      // floor division (the plain version's //; s < 0 only if a wraps)
      int mag = s / q;
      if ((s % q != 0) && s < 0) mag -= 1;
      int qv = (int)(int16_t)(c < 0 ? wsub(0, mag) : mag);
      if (dering_on) qv = qv < -maxc ? -maxc : (qv > maxc ? maxc : qv);
      q_zz[(long long)k * N + gi] = (int16_t)qv;
      raw_zz[(long long)k * N + gi] = c;
      if (k > 0) {
        if (qv != 0) {
          const int mg = qv < 0 ? -qv : qv;
          atomicAdd(&h[((run & 15) << 4) | nbits(mg)], 1);
          zrl += run >> 4;
          run = 0;
          any = true;
        } else {
          ++run;
        }
      }
      if (k == 63) last = qv;
    }
    if (zrl) atomicAdd(&h[0xF0], zrl);
    flags[gi] = (uint8_t)((any ? 1 : 0) | (last == 0 ? 2 : 0));

    // serial f32 sum of the squares in NATURAL index order 1..63
    float acc = 0.0f;
#pragma unroll
    for (int k = 1; k < 64; ++k) {
      const float rf = (float)blk[k];
      acc = __fadd_rn(acc, __fmul_rn(rf, rf));
    }
    norm[gi] = acc;
  }
  __syncthreads();
  int sum = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) sum += hs[w][threadIdx.x];
  if (sum) atomicAdd(&hist[(long long)b * 256 + threadIdx.x], sum);
}

// One EOB run of `run` blocks into the lane's counts: k = run / 0x7FFF
// forced EOB14 symbols, then EOBn for the remainder.
__device__ __forceinline__ void emit_run(int (&c)[15], int run) {
  c[14] += run / EOB_MAX;
  const int r = run % EOB_MAX;
  if (r > 0) {
    const int cat = nbits(r) - 1;
#pragma unroll
    for (int q = 0; q < 15; ++q) c[q] += cat == q;
  }
}

__device__ __forceinline__ int hi_bit(unsigned m) {  // -1 for no bit
  return 31 - __clz(m);
}

// The run open just before lane `at` of a chunk, from the events below it
// in the chunk: nzb the nonzero blocks, ssb the segment starts (a start
// cuts the run; a nonzero block at p leaves at - p - 1 all-zero blocks
// and its own trailing-zero bit tr); -1 if there is none.
__device__ __forceinline__ int run_below(unsigned nzb, unsigned ssb,
                                         unsigned tr, int at) {
  const int p = hi_bit(nzb), q = hi_bit(ssb);
  if (q > p) return at - q;
  if (p >= 0) return at - p - 1 + (int)((tr >> p) & 1u);
  return -1;
}

// Tiles of EOB_TILE blocks of one image, one warp a tile, EOB_WARPS
// tiles a CTA, `ctas` CTAs an image (blockIdx.x = image * ctas + cta).
// A warp walks its tile 32 blocks at a time with __ballot_sync and
// counts the runs that begin and end inside the tile (a restart segment
// starting inside it cuts the run there and emits the previous segment's
// final run); the run open at the tile's start is not known to it, so it
// writes the tile's summary instead: head, the all-zero blocks from the
// tile's start to its first event (a nonzero block or a segment start),
// whose run the combine emits, or -1 if the tile has no event, and the
// run open at its end (the tile's length if it has no event). The last
// CTA of an image to finish (a counter per image, after __threadfence)
// combines the image's summaries in order: a scan of the associative
// (has an event, open run) operator gives the run open at each tile's
// start, R, and each tile with an event emits R + head; the run open at
// the image's end is its last segment's final run. That CTA sets the
// counter back to 0 for the next launch. Integer arithmetic throughout,
// so the two-level order is exact.
__global__ void __launch_bounds__(EOB_THREADS)
p1_eob_hist_kernel(const uint8_t* __restrict__ flags,
                   int32_t* __restrict__ hist, int n, int ri, int tiles,
                   int ctas, int2* __restrict__ summ,
                   unsigned* __restrict__ done) {
  __shared__ int s_h[15];
  __shared__ int2 s_warp[EOB_WARPS];
  __shared__ int s_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x / ctas;
  const int j = (blockIdx.x % ctas) * EOB_WARPS + warp;
  if (threadIdx.x < 15) s_h[threadIdx.x] = 0;
  int c[15];
#pragma unroll
  for (int q = 0; q < 15; ++q) c[q] = 0;
  int2* sm = summ + (long long)b * tiles;
  if (j < tiles) {                       // the whole warp, or none of it
    const int t0 = j * EOB_TILE;
    const int tn = min(EOB_TILE, n - t0);
    const uint8_t* f = flags + (long long)b * n + t0;
    int fl[EOB_CHUNKS];
#pragma unroll
    for (int u = 0; u < EOB_CHUNKS; ++u) {     // every load first
      const int i = u * 32 + lane;
      fl[u] = i < tn ? f[i] : 0;
    }
    bool seen = false;   // an event so far in the tile
    int carry = 0;       // blocks since the tile's start, or the open run
    int head = -1;
#pragma unroll
    for (int u = 0; u < EOB_CHUNKS; ++u) {
      const int base = u * 32;
      if (base >= tn) break;                   // uniform over the warp
      const int cnt = min(32, tn - base);
      const bool ss = lane < cnt && (t0 + base + lane) % ri == 0;
      const bool nz = fl[u] & 1;
      const unsigned nzm = __ballot_sync(FULL, nz);
      const unsigned trm = __ballot_sync(FULL, fl[u] & 2);
      const unsigned ssm = __ballot_sync(FULL, ss);
      const unsigned below = (1u << lane) - 1u;
      int hv = -1;                             // the tile's head, if here
      if (nz) {          // the run emitted before this block
        int run = run_below(nzm & below, ssm & (below | (1u << lane)), trm,
                            lane);
        if (run < 0) {
          run = carry + lane;
          if (!seen) {
            hv = run;
            run = 0;
          }
        }
        if (run > 0) emit_run(c, run);
      }
      if (ss) {          // the previous segment's final run
        int run = run_below(nzm & below, ssm & below, trm, lane);
        if (run < 0) {
          run = carry + lane;
          if (!seen) {
            hv = run;
            run = 0;
          }
        }
        emit_run(c, run);
      }
      if (nzm | ssm) {
        if (!seen) {
          const unsigned hm = __ballot_sync(FULL, hv >= 0);
          head = __shfl_sync(FULL, hv, __ffs(hm) - 1);
          seen = true;
        }
        const int p = hi_bit(nzm), q = hi_bit(ssm);
        carry = q > p ? cnt - q : cnt - 1 - p + (int)((trm >> p) & 1u);
      } else {
        carry += cnt;
      }
    }
    if (lane == 0) sm[j] = make_int2(head, carry);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(&done[b], 1u) == (unsigned)(ctas - 1);
  __syncthreads();
  if (s_last) {          // the combine, in blocks of EOB_THREADS tiles
    __threadfence();
    int R = 0;           // the run open at the block's first tile
    for (int base = 0; base < tiles; base += EOB_THREADS) {
      const int jj = base + (int)threadIdx.x;
      const int2 s = jj < tiles ? __ldcg(&sm[jj]) : make_int2(-1, 0);
      // a tile as a function of the run open at its start: with an event
      // (ev) the run after it is val, else the run grows by val blocks;
      // the warp's inclusive scan of (ev, val)
      int ev = s.x >= 0, val = s.y;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int oe = __shfl_up_sync(FULL, ev, off);
        const int ov = __shfl_up_sync(FULL, val, off);
        if (lane >= off) {
          if (!ev) val += ov;
          ev |= oe;
        }
      }
      if (lane == 31) s_warp[warp] = make_int2(ev, val);
      int xe = __shfl_up_sync(FULL, ev, 1), xv = __shfl_up_sync(FULL, val, 1);
      if (lane == 0) xe = xv = 0;              // the lanes before this one
      __syncthreads();
      int pe = 0, pv = 0;                      // the warps before this one
      for (int w2 = 0; w2 < EOB_WARPS; ++w2) {
        const int2 x = s_warp[w2];
        if (w2 == warp) {
          const int ce = pe | xe, cv = xe ? xv : pv + xv;
          if (s.x >= 0) emit_run(c, (ce ? cv : R + cv) + s.x);
        }
        if (x.x) {
          pe = 1;
          pv = x.y;
        } else {
          pv += x.y;
        }
      }
      R = pe ? pv : R + pv;                    // after the block's tiles
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      emit_run(c, R);                          // the last segment's final run
      done[b] = 0;
    }
  }
  // the histogram: a warp reduction, the CTA's sums, an atomic a symbol
#pragma unroll
  for (int q = 0; q < 15; ++q) {
    const int v = __reduce_add_sync(FULL, c[q]);
    if (lane == 0 && v) atomicAdd(&s_h[q], v);
  }
  __syncthreads();
  if (threadIdx.x < 15 && s_h[threadIdx.x])
    atomicAdd(&hist[(long long)b * 256 + (threadIdx.x << 4)],
              s_h[threadIdx.x]);
}

}  // namespace

// plane: the first sample of B images of a component, sample_bytes 1
// (uint8) or 4 (int32), strides in elements; bh x bw real blocks an
// image; qtbl the 64 quant values in natural order (host memory, passed
// by value); precision 8 or 12 -> q_zz (64, B*bh*bw) int16, raw_zz (64,
// N) int32, norm (N,) f32, flags (N,) uint8, and hist (B, 256) int32
// (zeroed by the caller) plus the within-block symbols. One launch on
// `stream`; returns cudaGetLastError() (cudaErrorInvalidValue for
// arguments the kernel does not take).
extern "C" int mj_p1_blocks(const void* plane, int sample_bytes,
                            long long s_img, long long s_row, long long s_col,
                            int B, int bh, int bw, const int* qtbl,
                            int dering_on, int precision, void* q_zz,
                            void* raw_zz, void* norm, void* hist, void* flags,
                            void* stream) {
  if (B <= 0 || bh <= 0 || bw <= 0) return 0;
  if (B > 65535 || (precision != 8 && precision != 12)
      || (sample_bytes != 1 && sample_bytes != 4))
    return (int)cudaErrorInvalidValue;
  P1Tables tab;
  for (int k = 0; k < 64; ++k) {
    if (qtbl[k] < 1) return (int)cudaErrorInvalidValue;
    tab.qv_zz[k] = qtbl[zz_nat(k)] << 3;
  }
  tab.q0 = qtbl[0];
  const long long n = (long long)bh * bw;
  const long long N = n * B;
  const dim3 grid((unsigned)((n + TPB - 1) / TPB), (unsigned)B);
  cudaStream_t st = (cudaStream_t)stream;
  if (sample_bytes == 1)
    p1_blocks_kernel<uint8_t><<<grid, TPB, 0, st>>>(
        (const uint8_t*)plane, s_img, s_row, s_col, bh, bw, N, tab,
        dering_on, precision, (int16_t*)q_zz, (int32_t*)raw_zz,
        (float*)norm, (int32_t*)hist, (uint8_t*)flags);
  else
    p1_blocks_kernel<int32_t><<<grid, TPB, 0, st>>>(
        (const int32_t*)plane, s_img, s_row, s_col, bh, bw, N, tab,
        dering_on, precision, (int16_t*)q_zz, (int32_t*)raw_zz,
        (float*)norm, (int32_t*)hist, (uint8_t*)flags);
  return (int)cudaGetLastError();
}

// flags (B*n,) uint8 from mj_p1_blocks -> the EOB runs of each image's
// restart segments of ri blocks (ri <= 0: one segment an image) added into
// hist (B, 256) int32. Scratch: summ, summ_len int2 (at least B *
// ceil(n / 256)), and done, done_len uint32 counters that are 0 on entry
// (at least B; the launch leaves them 0). One launch on `stream`; returns
// cudaGetLastError() (cudaErrorInvalidValue for arguments the kernel does
// not take).
extern "C" int mj_p1_eob_hist(const void* flags, void* hist, int B,
                              long long n, long long ri, void* summ,
                              long long summ_len, void* done,
                              long long done_len, void* stream) {
  if (B <= 0 || n <= 0) return 0;
  if (n > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  if (ri <= 0 || ri > n) ri = n;
  const long long tiles = (n + EOB_TILE - 1) / EOB_TILE;
  const long long ctas = (tiles + EOB_WARPS - 1) / EOB_WARPS;
  if (B * tiles > summ_len || B > done_len || B * ctas > 0x7fffffffll)
    return (int)cudaErrorInvalidValue;
  p1_eob_hist_kernel<<<(unsigned)(B * ctas), EOB_THREADS, 0,
                       (cudaStream_t)stream>>>(
      (const uint8_t*)flags, (int32_t*)hist, (int)n, (int)ri, (int)tiles,
      (int)ctas, (int2*)summ, (unsigned*)done);
  return (int)cudaGetLastError();
}
