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
// Bound: bytes by the roofline. A block reads 64 samples (64 B at 8
// bits, 256 at 12) and writes 64 int16 + 64 int32 coefficients, its norm
// and a flag byte (389 B at 8 bits); its arithmetic is about 1,700 integer
// operations (16 FDCT passes, quantization, zigzag, symbols) and at most
// 64 f32 curve points, three quarters of the bytes' time at the INT32
// rate. The design: eight lanes a block, 32 neighbouring blocks of one
// image a CTA of 256 threads, so that a group's luma is 1,536 CTAs (many
// waves, not one thread's chain a launch). Lane r loads sample row r (one
// 8-byte load at 8 bits, two 16-byte loads at 12, where the plane's
// columns are contiguous and the row aligned; else the element loop, any
// strides), runs the row pass in registers, and the block goes through
// shared memory (rows of 9 ints, free of bank conflicts) to the column
// pass on lane c. Lane c then quantizes its column without a runtime
// division: floor(s / d) is the high word of s * mhi + umulhi(s, mlo) for
// 0 <= s < 2^31, d = 8q and ceil(2^64 / d) = mhi * 2^32 + mlo, exact
// because the product's error s * (M - 2^64/d) / 2^64 < 2^-32 is under
// 1/d; s < 0 (|c| + 4q wrapped int32, which the FDCT's outputs never give:
// its last descale keeps |c| <= 2^30) keeps the division, once a lane,
// outside the loop. The values are staged in shared memory, natural-major
// (strides 36 and 40 keep the lanes' writes on distinct banks), and
// written one zigzag coefficient row of 32 blocks at a time (128 B of raw
// and 64 B of quantized values a warp). The block's 64-bit nonzero mask
// is the OR of the lanes' one-hot bits (three shuffles a half); with a
// sentinel at bit 0, a nonzero at zigzag k >= 1 has run clz64(mask << (64
// - k)) = k - 1 - (its highest nonzero in [1, k - 1], or 0), ZRLs run >>
// 4, and the flag byte comes from the mask. Equal symbols of one warp
// instruction are added once (__match_any_sync, the leader adds the
// popcount) into a histogram per warp, and rows of zeros across the warp
// are skipped. Warp 0 sums each block's squares from the staged raw
// values, a block a lane, in natural order 1..63 (the norm). Deringing's
// clipped count and sum are reduced over the eight lanes, and a block
// with 0 < cnt < 64 runs the run walk on one lane over its samples in
// shared memory (no local array). What bounds it on the card, measured:
// not bytes but latency. A variant that skips the stores, the norm, the
// symbols and the histogram's atomics still takes most of a 12 MP luma
// launch's time; the 8-lane split issues more thread instructions a block
// than one thread a block (the transposes and the staging through shared
// memory, the per-lane table loads, the symbol rounds), and occupancy
// moves it most (MIN_CTAS). Tensor cores are
// not used: the FDCT's integer constants reach 25,172, each pass ends in
// a rounding shift, and int32 wraps exactly. The EOB kernel reads one
// flag byte a block and is bound by the runs' chain, not by bytes: fixed
// tiles of 256 blocks, a warp each, walk their 8 chunks of 32 with
// __ballot_sync whatever the restart interval, and the last CTA of each
// image joins the tiles' runs in the same launch (a scan of the tiles'
// summaries).
//
// Exactness (the plain versions in ops/p1.py are the spec): int32
// arithmetic that the JAX program lets wrap is computed unsigned, whose
// wrap is defined; C division truncates like the plain version's
// rounding_mode="trunc", and the quantizer's floor division is exact in
// both branches; build with -fmad=false, every f32 operation of the dering
// curve and the norm is an explicit _rn intrinsic in the plain version's
// order, and the step 1/(len + 1) is an IEEE division. The run walk
// rewrites the block in place, as hostenc.cpp's does, while the plain
// version derives every run from the samples as they came in; the two
// agree because only a run's f2 edge can read an earlier run's new value,
// and a new value is either >= 127 (then f1 - f2 < 0 < 127 - f1 and the
// slope is 127 - f1 either way) or the cap below 127, which every value of
// the later run takes whatever its slope (the curve never falls under
// 127).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int TPB = 256;             // threads per CTA of p1_blocks
// CTAs of p1_blocks a multiprocessor holds at once: the kernel waits on
// memory and shared-memory round trips more than it issues, and five CTAs
// (48 registers a thread, 34 KB of shared memory each) hide more of that
// than four (63 registers) or six (spills)
constexpr int MIN_CTAS = 5;
constexpr int LPB = 8;               // lanes an 8x8 block
constexpr int GB = TPB / LPB;        // blocks a CTA
constexpr int WARPS = TPB / 32;
static_assert(TPB == 256, "the histogram flush gives each thread one bin");
constexpr int BUF = 72;              // ints of a block's buffer: 8 rows of 9
constexpr int SR = 36;               // raw staging: ints a natural index
constexpr int SQ = 40;               // quantized staging: int16 an index
constexpr int EOB_TILE = 256;        // blocks a warp of the EOB kernel walks
constexpr int EOB_CHUNKS = EOB_TILE / 32;
constexpr int EOB_WARPS = 8;         // tiles (warps) per CTA of the EOB kernel
constexpr int EOB_THREADS = EOB_WARPS * 32;
constexpr int MAXS = 127;            // 255 - CENTERJSAMPLE at every precision
constexpr int CONST_BITS = 13;
constexpr int EOB_MAX = 0x7FFF;      // jcphuff.c's forced EOBRUN flush

// The quantizer of one natural index: d = 8q, ceil(2^64 / d) as its
// 32-bit halves, the index's zigzag position, and that position as a
// one-hot 64-bit mask's halves (two 16-byte loads).
struct __align__(16) QEntry {
  unsigned mlo, mhi;
  int d, zz;
  unsigned blo, bhi, pad0, pad1;
};

// The quantizer by natural index; nat[k] the natural index of zigzag
// position k; q0 the DC quant value (deringing's cap).
struct P1Tables {
  QEntry q[64];
  unsigned char nat[64];
  int q0;
};

// A CTA's shared memory: the tables; each block's 8x9 buffer (the
// samples for deringing, then the transpose between the passes); the raw
// and quantized values natural-major, GB blocks a row; the per-warp
// histograms; the flag bytes.
struct P1Shared {
  QEntry q[64];
  unsigned char nat[64];
  unsigned char off[64];             // zigzag k -> its slot in a buffer
  int buf[GB * BUF];
  int raw[64 * SR];
  short q16[64 * SQ];
  __align__(16) int hs[WARPS][256];
  unsigned char flags[GB];
};

// natural index of zigzag position i (jpeg_natural_order); host only
constexpr int ZZ_NAT[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

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

// A block's samples in zigzag order, read and written in place in its
// shared buffer: zigzag k lives at buf[off[k]].
struct ZzView {
  int* buf;
  const unsigned char* off;
  __device__ __forceinline__ int& operator[](int k) const {
    return buf[off[k]];
  }
};

// Overshoot deringing of one block (ops/dering.py dering_t): zz the
// block's 64 centered samples in zigzag order, m its clipped positions
// (bit i: zz[i] >= 127), 0 < cnt < 64 of them, total their sum.
__device__ void dering_zz(ZzView zz, unsigned long long m, int cnt,
                          int total, int q0) {
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

// Sample row r of a block, centered, into v[0..7]: one 8-byte load where
// the columns are contiguous and the row 8-byte aligned, else 8 loads.
__device__ __forceinline__ void load_row(const uint8_t* p, long long s_col,
                                         int center, int (&v)[8]) {
  if (s_col == 1 && ((uintptr_t)p & 7) == 0) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      v[x] = (int)((w.x >> (8 * x)) & 0xff) - center;
      v[x + 4] = (int)((w.y >> (8 * x)) & 0xff) - center;
    }
  } else {
#pragma unroll
    for (int x = 0; x < 8; ++x) v[x] = (int)p[x * s_col] - center;
  }
}
// int32 samples: two 16-byte loads where contiguous and 16-byte aligned
__device__ __forceinline__ void load_row(const int32_t* p, long long s_col,
                                         int center, int (&v)[8]) {
  if (s_col == 1 && ((uintptr_t)p & 15) == 0) {
    const int4 a = reinterpret_cast<const int4*>(p)[0];
    const int4 b = reinterpret_cast<const int4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int x = 0; x < 8; ++x) v[x] = p[x * s_col];
  }
#pragma unroll
  for (int x = 0; x < 8; ++x) v[x] = wsub(v[x], center);
}

// Eight lanes an 8x8 block, GB blocks of one image a CTA; grid (ceil(n /
// GB), B), blockIdx.y the image. plane: the image's samples at plane +
// b*s_img + y*s_row + x*s_col (elements); mbw = ceil(2^64 / bw) (0 for bw
// = 1) splits a block index into its row and column. Outputs: q_zz /
// raw_zz (64, N) zigzag coefficient-major, norm (N,), flags (N,) (bit 0: a
// nonzero AC in [1, 63], bit 1: coefficient 63 is zero), and the
// within-block AC-first symbols added into hist (B, 256).
//   1. lane r loads sample row r; with deringing the eight lanes reduce
//      the clipped count and the sum, and a block with 0 < cnt < 64 runs
//      the run walk on its lane 0 over its shared buffer;
//   2. the row pass on lane r, the buffer, the column pass on lane c;
//   3. lane c quantizes its column (natural index 8y + c), stages the raw
//      and quantized values;
//   4. the nonzero mask (OR over the lanes), each nonzero's symbol from
//      it, added per warp instruction once a bin, the ZRLs, the flag byte;
//   5. the CTA's rows of q_zz and raw_zz a warp at a time, warp 0's lane
//      g the norm of block g, the flag bytes, and the histogram.
template <typename T>
__global__ void __launch_bounds__(TPB, MIN_CTAS)
p1_blocks_kernel(const T* __restrict__ plane, long long s_img,
                 long long s_row, long long s_col, int bh, int bw,
                 unsigned long long mbw, long long N,
                 const __grid_constant__ P1Tables tab, int dering_on,
                 int precision, int16_t* __restrict__ q_zz,
                 int32_t* __restrict__ raw_zz, float* __restrict__ norm,
                 int32_t* __restrict__ hist, uint8_t* __restrict__ flags) {
  __shared__ __align__(16) P1Shared sh;
  const int t = threadIdx.x;
  if (t < 64) {
    sh.q[t] = tab.q[t];
    const int nat = tab.nat[t];
    sh.nat[t] = (unsigned char)nat;
    sh.off[t] = (unsigned char)((nat >> 3) * 9 + (nat & 7));
  }
#pragma unroll
  for (int i = t; i < WARPS * 64; i += TPB)
    reinterpret_cast<int4*>(&sh.hs[0][0])[i] = make_int4(0, 0, 0, 0);
  __syncthreads();
  const int lane = t & 31, warp = t >> 5;
  const int g = t >> 3;                  // the CTA's block
  const int r = t & 7;                   // sample row, then column
  const int b = blockIdx.y;
  const long long n = (long long)bh * bw;
  const long long i0 = (long long)blockIdx.x * GB;
  const long long i = i0 + g;
  const bool valid = i < n;
  int* buf = sh.buf + g * BUF;
  const int center = 1 << (precision - 1);

  // 1. the samples, and deringing
  int v[8];
  if (valid) {
    const unsigned iu = (unsigned)i;
    const int br = bw == 1 ? (int)iu : (int)__umul64hi(iu, mbw);
    const int bc = (int)iu - br * bw;
    load_row(plane + b * s_img + ((long long)br * 8 + r) * s_row
                 + (long long)bc * 8 * s_col,
             s_col, center, v);
  } else {
#pragma unroll
    for (int x = 0; x < 8; ++x) v[x] = 0;
  }
  if (dering_on) {
    int cnt = 0, total = 0;
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      total += v[x];
      cnt += v[x] >= MAXS;
    }
#pragma unroll
    for (int o = 1; o < LPB; o <<= 1) {
      cnt += __shfl_xor_sync(FULL, cnt, o);
      total += __shfl_xor_sync(FULL, total, o);
    }
    const bool dr = valid && cnt > 0 && cnt < 64;
    if (__any_sync(FULL, dr)) {
      if (dr) {
#pragma unroll
        for (int x = 0; x < 8; ++x) buf[r * 9 + x] = v[x];
      }
      __syncwarp();
      if (dr && r == 0) {
        const ZzView zz{buf, sh.off};
        unsigned long long m = 0;
        for (int k = 0; k < 64; ++k)
          m |= (unsigned long long)(zz[k] >= MAXS) << k;
        dering_zz(zz, m, cnt, total, tab.q0);
      }
      __syncwarp();
      if (dr) {
#pragma unroll
        for (int x = 0; x < 8; ++x) v[x] = buf[r * 9 + x];
      }
    }
  }

  // 2. the islow FDCT: rows on lane r, columns on lane c = r
  const int pass1 = precision == 8 ? 2 : 1;
  fdct_1d(v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], pass1,
          CONST_BITS - pass1);
#pragma unroll
  for (int x = 0; x < 8; ++x) buf[r * 9 + x] = v[x];
  __syncwarp();
  int c[8];
#pragma unroll
  for (int y = 0; y < 8; ++y) c[y] = buf[y * 9 + r];
  fdct_1d(c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], -pass1,
          CONST_BITS + pass1);

  // 3. quantize (round half away from zero by d = 8q: floor(s / d) is
  // the high word of s * mhi + umulhi(s, mlo) for 0 <= s < 2^31), the
  // post-dering clamp, the staging, the lane's nonzero bits
  const int maxc = (1 << (precision + 2)) - 1;
  int qv[8];
  bool wrapped = false;
#pragma unroll
  for (int y = 0; y < 8; ++y) {
    const QEntry e = sh.q[8 * y + r];
    const int cv = c[y];
    const int s = wadd(cv < 0 ? wsub(0, cv) : cv, e.d >> 1);
    wrapped |= s < 0;
    const unsigned long long p =
        (unsigned long long)(unsigned)s * e.mhi + __umulhi(s, e.mlo);
    const int mag = (int)(p >> 32);
    qv[y] = (int)(int16_t)(cv < 0 ? wsub(0, mag) : mag);
  }
  if (wrapped) {         // |c| + 4q wrapped int32: floor division, as the
#pragma unroll           // plain version's //
    for (int y = 0; y < 8; ++y) {
      const int d = sh.q[8 * y + r].d;
      const int cv = c[y];
      const int s = wadd(cv < 0 ? wsub(0, cv) : cv, d >> 1);
      if (s < 0) {
        int mag = s / d;
        if (s % d != 0) mag -= 1;
        qv[y] = (int)(int16_t)(cv < 0 ? wsub(0, mag) : mag);
      }
    }
  }
  unsigned lo = 0, hi = 0;               // nonzeros at zigzag 0-31, 32-63
#pragma unroll
  for (int y = 0; y < 8; ++y) {
    const int nat = 8 * y + r;
    int q = qv[y];
    if (dering_on) q = q < -maxc ? -maxc : (q > maxc ? maxc : q);
    qv[y] = q;
    sh.raw[nat * SR + g] = c[y];
    sh.q16[nat * SQ + g] = (short)q;
    lo |= q != 0 ? sh.q[nat].blo : 0u;
    hi |= q != 0 ? sh.q[nat].bhi : 0u;
  }

  // 4. the symbols of band [1, 63] from the block's nonzero mask: with a
  // sentinel at bit 0, the run before zigzag k is the count of leading
  // zeros of the mask shifted left by 64 - k
#pragma unroll
  for (int o = 1; o < LPB; o <<= 1) {
    lo |= __shfl_xor_sync(FULL, lo, o);
    hi |= __shfl_xor_sync(FULL, hi, o);
  }
  const unsigned long long ms = ((unsigned long long)hi << 32) | lo | 1ull;
  int zrl = 0;
#pragma unroll
  for (int y = 0; y < 8; ++y) {
    const bool nz = qv[y] != 0 && (y | r) != 0;
    if (__any_sync(FULL, nz)) {          // a row of zeros adds nothing
      const int k = sh.q[8 * y + r].zz;
      const int run = __clzll((long long)(ms << ((64 - k) & 63)));
      const int mg = qv[y] < 0 ? -qv[y] : qv[y];
      const int sym = nz ? ((run & 15) << 4) | (32 - __clz(mg)) : -1;
      zrl += nz ? run >> 4 : 0;
      const unsigned same = __match_any_sync(FULL, sym);
      if (nz && lane == __ffs(same) - 1)
        atomicAdd(&sh.hs[warp][sym], __popc(same));
    }
  }
  zrl = __reduce_add_sync(FULL, zrl);
  if (lane == 0 && zrl) atomicAdd(&sh.hs[warp][0xF0], zrl);
  if (r == 0)
    sh.flags[g] = (uint8_t)(((lo & ~1u) | hi ? 1 : 0) | (hi >> 31 ? 0 : 2));
  __syncthreads();

  // 5. the CTA's outputs: a zigzag row of GB blocks a warp at a time
  const long long gi0 = (long long)b * n + i0;
  const int cnt = (int)(n - i0 < GB ? n - i0 : GB);
#pragma unroll
  for (int p = 0; p < 64 / WARPS; ++p) {
    const int k = p * WARPS + warp;
    const int nat = sh.nat[k];
    if (lane < cnt) {
      raw_zz[(long long)k * N + gi0 + lane] = sh.raw[nat * SR + lane];
      q_zz[(long long)k * N + gi0 + lane] = sh.q16[nat * SQ + lane];
    }
  }
  if (warp == 0) {       // the norm: block `lane`'s serial f32 sum of the
    float acc = 0.0f;    // squares in NATURAL index order 1..63
#pragma unroll
    for (int k = 1; k < 64; ++k) {
      const float rf = (float)sh.raw[k * SR + lane];
      acc = __fadd_rn(acc, __fmul_rn(rf, rf));
    }
    if (lane < cnt) {
      norm[gi0 + lane] = acc;
      flags[gi0 + lane] = sh.flags[lane];
    }
  }
  int sum = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) sum += sh.hs[w][t];
  if (sum) atomicAdd(&hist[(long long)b * 256 + t], sum);
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
    const int nat = ZZ_NAT[k];
    if (qtbl[nat] < 1 || qtbl[nat] > 65535) return (int)cudaErrorInvalidValue;
    const unsigned long long d = (unsigned long long)qtbl[nat] << 3;
    const unsigned long long m = ~0ull / d + 1;   // ceil(2^64 / d), d > 1
    tab.q[nat] = QEntry{(unsigned)m, (unsigned)(m >> 32), (int)d, k,
                        k < 32 ? 1u << k : 0u, k < 32 ? 0u : 1u << (k - 32),
                        0u, 0u};
    tab.nat[k] = (unsigned char)nat;
  }
  tab.q0 = qtbl[0];
  const long long n = (long long)bh * bw;
  if (n > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  const long long N = n * B;
  const unsigned long long mbw = bw > 1 ? ~0ull / (unsigned)bw + 1 : 0;
  const dim3 grid((unsigned)((n + GB - 1) / GB), (unsigned)B);
  cudaStream_t st = (cudaStream_t)stream;
  if (sample_bytes == 1)
    p1_blocks_kernel<uint8_t><<<grid, TPB, 0, st>>>(
        (const uint8_t*)plane, s_img, s_row, s_col, bh, bw, mbw, N, tab,
        dering_on, precision, (int16_t*)q_zz, (int32_t*)raw_zz,
        (float*)norm, (int32_t*)hist, (uint8_t*)flags);
  else
    p1_blocks_kernel<int32_t><<<grid, TPB, 0, st>>>(
        (const int32_t*)plane, s_img, s_row, s_col, bh, bw, mbw, N, tab,
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
