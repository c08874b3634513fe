// AC trellis quantization of one spectral band for every 8x8 block.
//
// Replaces mozjpeg_tpu/ops/pallas_trellis.py::trellis_ac_dp_pallas (the
// JAX package's only Pallas kernel): mozjpeg's quantize_trellis
// (jcdctmgr.c:936-1329) on band [Ss, Se] -- round-nearest qval, the
// serial f32 prefix of zero-distortion terms (azd), the Viterbi over
// position i, previous nonzero j and bit length k, end selection with the
// EOB code length from rate-LUT row 127, the path walk and the keep mask.
// Outputs: new_band (64, N) int32 signed kept values (0 elsewhere) and
// ei (8, N) f32 rows [czero, skip, has_eob, 0...] for the EOB-run DP.
//
// One template on (KMAX, MAXQ), the bit lengths k < KMAX of a quantized
// value and its clamp: <10, 1023> for 8-bit samples (the Pallas kernel's
// own constants) and <14, 16383> for 12-bit ones (where the JAX package
// runs codec/trellis.py::_trellis_ac_t at kmax 14 / maxq 16383).
// mj_trellis_ac picks the instantiation from the data precision.
//
// Bound: bytes. Each block reads its 64 raw words and lambda and writes
// 64 + 8 words, 548 bytes a block (40.6 MB for one group of eight
// 768x512 images, 12 us at 3.35 TB/s). The operations are data
// dependent: only nonzero quantized positions are DP states, and on
// quantized 8-bit photos most AC positions are zero (about 65 candidate
// operations a block on the smoke corpus), so the arithmetic is far
// below the bytes unless blocks are dense. At 12 bits the samples grow
// 16x against the same quant tables, so blocks are dense (about 50
// nonzero AC coefficients) and the O(nnz^2 * KMAX) DP sets the time.
//
// Design: a CTA takes a tile of TB consecutive blocks of one image (the
// grid is image x tile, so one rate LUT serves the CTA; the ragged last
// tile of an image masks its idle blocks) and gives each block a group of
// L lanes of one warp. The tile moves through shared memory row by row:
// row p of the (64, N) arrays holds TB contiguous words, so the raw load
// and the new_band and ei stores are whole coalesced rows. Per-block
// state (raw, azd, acc, rs | bv << 6) is laid out [position][block] with
// a row stride of TB + 1 words, so the lanes of a block, which read
// different positions, hit different banks.
//
// The DP visits nonzero positions only. A 64-bit mask holds the in-band
// positions with qval != 0, and step i walks the predecessors Ss-1 and
// the set bits below i. Lane l takes the predecessors j with j % L == l
// in ascending order, folding k ascending with strict '<' from BIG; a
// shuffle over the L lanes then takes the lexicographic minimum of
// (cost, j). Together that is the first minimum in flat (j, k) order, as
// the Pallas kernel's argmin, and (j 0, cand 0) with acc BIG when nothing
// beats BIG. Skipping zero positions is exact: in the full DP a zero i
// gets acc BIG, rs 0 and bv 0, it is never a valid predecessor (validity
// needs qval != 0), and its end cost is BIG, which the end selection
// accounts for with the first such position. The path walk takes at most
// popcount steps, since rs[i] < i. Why L lanes and not one thread per
// block: a launch's time follows its heaviest blocks (20-35 nonzero
// coefficients on photo-like input, an O(nnz^2) DP), and one thread per
// block ran them serially and measured slower than the warp-per-block
// kernel this one replaces; L lanes split each step's predecessors.
//
// Exactness: build with -fmad=false and without --use_fast_math; every f32
// product feeding an add is also an explicit __fmul_rn, so it rounds
// before the add like the C reference. The squares |raw|^2 and delta^2
// are int32 products in the JAX program and wrap there once |raw| passes
// 46,341 (12-bit strong edges); here they multiply as unsigned, whose
// wrap is defined, and convert back to int, the same two's complement
// value (signed overflow would be undefined, and nvcc may assume it away). 1/q^2 comes from the host IEEE
// table (ltbl); nothing is divided in floating point on the device.
// Integer division only sees non-negative operands. The azd prefix is the
// serial C-order sum over [Ss, Se] on one lane: positions outside the band
// add +0.0, which leaves the sum unchanged. Cost order: (rate + cdist) +
// tail with tail = (azd[i-1] - azd[j]) + acc[j]; end cost
// ((acc + azd_Se) - azd[j]) + eobl.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RR_K = 16;        // row width of the run-indexed rate LUT
constexpr int LUT_ROWS = 64;    // rows staged: 64-i+j lies in [1, 63]
constexpr float BIGF = 1e38f;
constexpr int L = 8;            // lanes per 8x8 block
constexpr int TB = 16;          // blocks per CTA (one tile)
constexpr int NT = TB * L;      // threads per CTA
constexpr int LD = TB + 1;      // row stride of the [position][block] arrays
constexpr int ROWS = NT / TB;   // tile rows one pass of the CTA moves
static_assert(32 % L == 0 && L <= 8, "a block's lanes share one warp");
static_assert(NT >= 64, "one thread stages each of the 64 table entries");

__device__ __forceinline__ int nbits(int v) {
  return v > 0 ? 32 - __clz(v) : 0;
}

__device__ __forceinline__ int low_bit(unsigned long long m) {
  return __ffsll((long long)m) - 1;
}

// a * b - c in int32 with two's complement wrap (the JAX program's int32
// arithmetic), computed unsigned so that no signed overflow occurs
__device__ __forceinline__ int wrap_mad(int a, int b, int c) {
  return (int)((unsigned)a * (unsigned)b - (unsigned)c);
}

// Lexicographic (cost, j) minimum over the L lanes of a block (gm names
// them), carrying one payload.
template <typename P>
__device__ __forceinline__ void group_argmin(unsigned gm, float& c, int& j,
                                             P& pay) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) {
    const float oc = __shfl_xor_sync(gm, c, off);
    const int oj = __shfl_xor_sync(gm, j, off);
    const P op = __shfl_xor_sync(gm, pay, off);
    if (oc < c || (oc == c && oj < j)) {
      c = oc;
      j = oj;
      pay = op;
    }
  }
}

template <int KMAX, int MAXQ>
__global__ void __launch_bounds__(NT, 4)
trellis_ac_kernel(const int32_t* __restrict__ raw,
                  const int32_t* __restrict__ qtbl,
                  const float* __restrict__ ltbl,
                  const float* __restrict__ luts,
                  const float* __restrict__ lam,
                  int32_t* __restrict__ nb_out, float* __restrict__ ei_out,
                  long long N, long long n_img, long long tiles, int Ss,
                  int Se) {
  __shared__ int s_raw[64 * LD];      // raw, then the new band values
  __shared__ float s_azd[64 * LD];
  __shared__ float s_acc[64 * LD];
  __shared__ int s_rb[64 * LD];       // qval, then rs | bv << 6
  __shared__ float s_ei[8 * LD];
  constexpr int LUT_LD = KMAX | 1;  // odd shared row stride >= KMAX:
                                    // rows spread over the banks
  static_assert(KMAX <= RR_K && MAXQ < (1 << KMAX), "a LUT row holds k");
  __shared__ float s_lut[LUT_ROWS * LUT_LD];
  __shared__ int s_q8[64];
  __shared__ float s_lt[64];
  __shared__ float s_lam[TB];
  __shared__ float s_eobl;

  const int tid = threadIdx.x;
  const long long img = blockIdx.x / tiles;
  const long long first = (blockIdx.x % tiles) * TB;   // within the image
  const long long n0 = img * n_img + first;
  const int width = (int)(n_img - first < TB ? n_img - first : TB);
  const float* lut = luts + img * 128 * RR_K;
  const int col = tid % TB;

  // stage the band's rows of the raw tile, lambda and the tables, every
  // load in flight at once
#pragma unroll
  for (int m = 0; m < (64 + ROWS - 1) / ROWS; ++m) {
    const int p = Ss + tid / TB + m * ROWS;
    if (p <= Se && col < width) s_raw[p * LD + col] = raw[p * N + n0 + col];
  }
#pragma unroll
  for (int m = 0; m < (LUT_ROWS * KMAX + NT - 1) / NT; ++m) {
    const int w = tid + m * NT, r = w / KMAX, k = w - r * KMAX;
    if (w < LUT_ROWS * KMAX) s_lut[r * LUT_LD + k] = lut[r * RR_K + k];
  }
  if (tid < 64) {
    s_q8[tid] = qtbl[tid] << 3;
    s_lt[tid] = ltbl[tid];
  }
  if (tid < width) s_lam[tid] = lam[n0 + tid];
  if (tid == 0) s_eobl = lut[127 * RR_K];           // EOB code length
  __syncthreads();

  const int b = tid / L, lane = tid % L;
  if (b < width) {
    const unsigned gm = ((1u << L) - 1) << ((tid & 31) & ~(L - 1));
    const unsigned long long mine = (~0ull / ((1ull << L) - 1)) << lane;
    const unsigned long long band =
        (Se == 63 ? ~0ull : (1ull << (Se + 1)) - 1) & ~((1ull << Ss) - 1);
    const float lam_n = s_lam[b];
    const float eobl = s_eobl;
    int* rawb = s_raw + b;                          // word p*LD of the block
    float* azd = s_azd + b;
    float* acc = s_acc + b;
    int* rb = s_rb + b;

    // zero-distortion terms, the nonzero mask and qval, lanes over
    // positions
    unsigned long long mask = 0;
    for (unsigned long long todo = band & mine; todo; todo &= todo - 1) {
      const int p = low_bit(todo);
      const int r = rawb[p * LD];
      const int xa = r < 0 ? -r : r;
      const int q8 = s_q8[p];
      azd[p * LD] =
          __fmul_rn(__fmul_rn((float)wrap_mad(xa, xa, 0), lam_n), s_lt[p]);
      if (xa >= q8 - (q8 >> 1)) {                   // qval != 0
        mask |= 1ull << p;
        const int q = (xa + (q8 >> 1)) / q8;
        rb[p * LD] = q > MAXQ ? MAXQ : q;
      }
    }
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1)
      mask |= __shfl_xor_sync(gm, mask, off);
    __syncwarp(gm);
    if (lane == 0) {                  // serial f32 prefix, C order
      float run = 0.0f;
      azd[(Ss - 1) * LD] = 0.0f;      // the start state Ss-1
      acc[(Ss - 1) * LD] = 0.0f;
      for (int p0 = Ss; p0 <= Se; p0 += 16) {      // 16 loads in flight
        float z[16];
#pragma unroll
        for (int u = 0; u < 16; ++u)
          z[u] = p0 + u <= Se ? azd[(p0 + u) * LD] : 0.0f;
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          if (p0 + u <= Se) {
            run = run + z[u];
            azd[(p0 + u) * LD] = run;
          }
        }
      }
    }
    __syncwarp(gm);
    const float azd_Se = azd[Se * LD];

    for (unsigned long long todo = mask; todo; todo &= todo - 1) {
      const int i = low_bit(todo);
      const int r = rawb[i * LD];
      const int x_i = r < 0 ? -r : r;
      const int q8_i = s_q8[i];
      const int qval_i = rb[i * LD];
      const int nc_i = nbits(qval_i);
      const float ltbl_i = s_lt[i];
      const float azd_im1 = azd[(i - 1) * LD];
      float cdist[KMAX];              // k < nc_i only: no larger k is read
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        if (k >= nc_i) break;
        const int c = (nc_i == k + 1) ? qval_i : (2 << k) - 1;
        const int d = wrap_mad(c, q8_i, x_i);
        cdist[k] = __fmul_rn(__fmul_rn((float)wrap_mad(d, d, 0), lam_n),
                             ltbl_i);
      }
      float best = BIGF;
      int bj = 0, bk = -1;
      const unsigned long long pred =
          ((mask & ((1ull << i) - 1)) | (1ull << (Ss - 1))) & mine;
      for (unsigned long long js = pred; js; js &= js - 1) {
        const int j = low_bit(js);
        const float tail = (azd_im1 - azd[j * LD]) + acc[j * LD];
        const float* rrow = s_lut + (64 - i + j) * LUT_LD;  // run i-1-j
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
          if (k >= nc_i) break;
          const float rate = rrow[k];
          const float cost = (rate + cdist[k]) + tail;
          if (rate < BIGF && cost < best) {
            best = cost;
            bj = j;
            bk = k;
          }
        }
      }
      int bcand = bk < 0 ? 0 : (bk == nc_i - 1 ? qval_i : (2 << bk) - 1);
      group_argmin(gm, best, bj, bcand);
      if (lane == 0) {
        acc[i * LD] = best;
        rb[i * LD] = bj | (bcand << 6);
      }
      __syncwarp(gm);
    }

    // end selection: the lexicographic minimum of (end cost, j) over
    // j = 0..63, carrying the cost without EOB (the eob-info "skip").
    // Lane 0 holds the start state Ss-1 and the first position that is
    // neither Ss-1 nor nonzero, whose end cost is BIG; the lanes split
    // the nonzero positions as in the DP.
    float ebest = __int_as_float(0x7f800000);       // +inf
    int last = 64;
    float skip = 0.0f;
    if (lane == 0) {
      ebest = azd_Se + eobl;
      last = Ss - 1;
      skip = azd_Se;
      const unsigned long long valid = mask | (1ull << (Ss - 1));
      if (~valid) {
        const int z = low_bit(~valid);
        if (BIGF < ebest || (BIGF == ebest && z < last)) {
          // acc is BIG there; azd is 0 below the band, azd_Se above it
          const float azd_z =
              z < Ss ? 0.0f : (z > Se ? azd_Se : azd[z * LD]);
          ebest = BIGF;
          last = z;
          skip = (BIGF + azd_Se) - azd_z;
        }
      }
    }
    for (unsigned long long js = mask & mine; js; js &= js - 1) {
      const int j = low_bit(js);
      const float end_wo = (acc[j * LD] + azd_Se) - azd[j * LD];
      const float ec = end_wo + (j < Se ? eobl : 0.0f);
      if (ec < ebest || (ec == ebest && j < last)) {
        ebest = ec;
        last = j;
        skip = end_wo;
      }
    }
    group_argmin(gm, ebest, last, skip);

    unsigned long long keep = 0;      // path walk, on every lane
    for (int cur = last; cur >= Ss && cur < 64 && ((mask >> cur) & 1ull);
         cur = rb[cur * LD] & 63)
      keep |= 1ull << cur;

    for (int p = lane; p < 64; p += L) {
      int v = 0;
      if ((keep >> p) & 1ull) {
        v = (rb[p * LD] >> 6) & MAXQ;             // rs | bv << 6
        if (rawb[p * LD] < 0) v = -v;
      }
      rawb[p * LD] = v;
    }
    const float has_eob = (float)(last < Se) + (float)(last == Ss - 1);
    for (int r = lane; r < 8; r += L)
      s_ei[r * LD + b] =
          r == 0 ? azd_Se : (r == 1 ? skip : (r == 2 ? has_eob : 0.0f));
  }
  __syncthreads();

  // write the tile back row by row: 64 rows of new_band, 8 of ei
  if (col < width) {
#pragma unroll 4
    for (int p = tid / TB; p < 64; p += ROWS)
      nb_out[p * N + n0 + col] = s_raw[p * LD + col];
    for (int r = tid / TB; r < 8; r += ROWS)
      ei_out[r * N + n0 + col] = s_ei[r * LD + col];
  }
}

template <int KMAX, int MAXQ>
int launch(const void* raw, const void* qtbl, const void* ltbl,
           const void* luts, const void* lam, void* nb, void* ei,
           long long N, long long n_img, int Ss, int Se, void* stream) {
  const long long tiles = (n_img + TB - 1) / TB;
  const long long grid = tiles * (N / n_img);
  trellis_ac_kernel<KMAX, MAXQ>
      <<<(unsigned)grid, NT, 0, (cudaStream_t)stream>>>(
          (const int32_t*)raw, (const int32_t*)qtbl, (const float*)ltbl,
          (const float*)luts, (const float*)lam, (int32_t*)nb, (float*)ei,
          N, n_img, tiles, Ss, Se);
  return (int)cudaGetLastError();
}

}  // namespace

// raw (64, N) int32, qtbl (64,) int32, ltbl (64,) f32, luts (B, 128, 16)
// f32, lam (N,) f32 -> nb (64, N) int32, ei (8, N) f32; N = B * n_img,
// image-major; precision 8 launches <10, 1023>, 12 <14, 16383>. Launches
// on `stream` and returns cudaGetLastError() (cudaErrorInvalidValue for
// another precision).
extern "C" int mj_trellis_ac(const void* raw, const void* qtbl,
                             const void* ltbl, const void* luts,
                             const void* lam, void* nb, void* ei,
                             long long N, long long n_img, int Ss, int Se,
                             int precision, void* stream) {
  if (N <= 0 || n_img <= 0) return 0;
  if (precision == 8)
    return launch<10, 1023>(raw, qtbl, ltbl, luts, lam, nb, ei, N, n_img,
                            Ss, Se, stream);
  if (precision == 12)
    return launch<14, 16383>(raw, qtbl, ltbl, luts, lam, nb, ei, N, n_img,
                             Ss, Se, stream);
  return (int)cudaErrorInvalidValue;
}
