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
// Bound: operations on dense blocks. A block with every coefficient
// nonzero evaluates sum_i i*10 ~ 20k (j, k) candidate costs of a few f32
// operations each, against 64 raw values read and 72 words written. Only
// nonzero positions are candidates, though, so on typical quantized
// photos the candidates shrink by orders of magnitude and the bytes set
// the floor; what the kernel then waits on is each block's serial chain
// (prefix, 63 DP steps, path walk), which is why blocks map to warps.
//
// Design: one warp per block. Lane l owns j in {l, l+32}: acc[j] lives in
// the owning lane's registers, and for each i the lane folds k = 0..9 with
// strict '<' (the smallest k wins ties) over its two j's (the smaller j
// wins ties), then a shuffle reduction takes the lexicographic minimum of
// (cost, j). Together that is the first-minimum flat-index (j*KMAX + k)
// tie-break of the Pallas kernel. One warp per block keeps the card full
// (the main path's ~74k blocks per group give ~74k warps, where one thread
// per block would leave ~17 warps per SM). The azd prefix is a serial
// 64-step sum on one lane, as are the end selection's path walk.
//
// Exactness: build with -fmad=false and without --use_fast_math; every f32
// product feeding an add is also an explicit __fmul_rn, so it rounds
// before the add like the C reference. 1/q^2 comes from the host IEEE
// table (ltbl); nothing is divided in floating point on the device.
// Integer division only sees non-negative operands. Loads and stores of
// the column-major (64, N) arrays are strided; coalescing them is later
// work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KMAX = 10;        // NBITS(1023)
constexpr int RR_K = 16;        // row width of the run-indexed rate LUT
constexpr float BIGF = 1e38f;
constexpr int WARPS = 4;        // warps (= 8x8 blocks) per thread block
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int nbits(int v) {
  return v > 0 ? 32 - __clz(v) : 0;
}

// Lexicographic (cost, j) minimum across the warp, carrying one payload.
template <typename T>
__device__ __forceinline__ void warp_argmin(float& c, int& j, T& pay) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float oc = __shfl_xor_sync(FULL, c, off);
    const int oj = __shfl_xor_sync(FULL, j, off);
    const T op = __shfl_xor_sync(FULL, pay, off);
    if (oc < c || (oc == c && oj < j)) {
      c = oc;
      j = oj;
      pay = op;
    }
  }
}

__global__ void __launch_bounds__(WARPS * 32)
trellis_ac_kernel(const int32_t* __restrict__ raw,
                  const int32_t* __restrict__ qtbl,
                  const float* __restrict__ ltbl,
                  const float* __restrict__ luts,
                  const float* __restrict__ lam,
                  int32_t* __restrict__ nb_out, float* __restrict__ ei_out,
                  long long N, long long n_img, int Ss, int Se) {
  __shared__ int s_x[WARPS][64];
  __shared__ int s_qval[WARPS][64];
  __shared__ float s_azd[WARPS][64];
  __shared__ int s_rs[WARPS][64];
  __shared__ int s_bv[WARPS][64];

  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long n = (long long)blockIdx.x * WARPS + w;
  if (n >= N) return;                       // uniform across the warp

  int* x = s_x[w];
  int* qv = s_qval[w];
  float* azd = s_azd[w];
  int* rs = s_rs[w];
  int* bv = s_bv[w];
  const float* lut = luts + (size_t)(n / n_img) * 128 * RR_K;
  const float lam_n = lam[n];

  int raw_p[2];
  bool nzj[2];
  float acc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = lane + 32 * h;
    const int r = raw[(long long)p * N + n];
    const int xa = r < 0 ? -r : r;
    const int q8 = qtbl[p] << 3;
    int q = (xa + (q8 >> 1)) / q8;
    if (q > 1023) q = 1023;
    const bool in_band = p >= Ss && p <= Se;
    raw_p[h] = r;
    x[p] = xa;
    qv[p] = q;
    const float zd = __fmul_rn(__fmul_rn((float)(xa * xa), lam_n), ltbl[p]);
    azd[p] = in_band ? zd : 0.0f;           // zterm; prefix-summed below
    nzj[h] = in_band && q != 0;
    acc[h] = (p == Ss - 1) ? 0.0f : BIGF;
    rs[p] = 0;
    bv[p] = 0;
  }
  __syncwarp();
  if (lane == 0) {                          // serial f32 prefix, C order
    float run = azd[0];
    for (int p = 1; p < 64; ++p) {
      run = run + azd[p];
      azd[p] = run;
    }
  }
  __syncwarp();

  for (int i = Ss; i <= Se; ++i) {
    const int qval_i = qv[i];
    float minval = BIGF;
    int win_j = 0, win_cand = 0;
    if (qval_i != 0) {
      const int x_i = x[i];
      const int q8_i = qtbl[i] << 3;
      const int nc_i = nbits(qval_i);
      const float ltbl_i = ltbl[i];
      const float azd_im1 = azd[i - 1];
      float cdist[KMAX];
      int cand[KMAX];
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        const int c = (nc_i == k + 1) ? qval_i : (2 << k) - 1;
        const int d = c * q8_i - x_i;
        cand[k] = c;
        cdist[k] = __fmul_rn(__fmul_rn((float)(d * d), lam_n), ltbl_i);
      }
      float bc = BIGF;
      int bj = 0, bcand = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = lane + 32 * h;
        if ((nzj[h] || j == Ss - 1) && j < i) {
          const float tail = (azd_im1 - azd[j]) + acc[h];
          const float* rrow = lut + (64 - i + j) * RR_K;  // rate(run=i-1-j)
          float cj = BIGF;
          int candj = 0;
#pragma unroll
          for (int k = 0; k < KMAX; ++k) {
            const float rate = rrow[k];
            float cost = (rate + cdist[k]) + tail;
            if (!(k < nc_i && rate < BIGF)) cost = BIGF;
            if (cost < cj) {
              cj = cost;
              candj = cand[k];
            }
          }
          if (cj < bc) {
            bc = cj;
            bj = j;
            bcand = candj;
          }
        }
      }
      warp_argmin(bc, bj, bcand);
      minval = bc;
      win_j = bj;
      win_cand = bcand;
    }
    if (lane == (i & 31)) {
      if (i < 32) acc[0] = minval; else acc[1] = minval;
    }
    if (lane == 0) {
      rs[i] = win_j;
      bv[i] = win_cand;
    }
    __syncwarp();
  }

  // end selection: first minimum of the end costs, carrying the cost
  // without EOB (the eob-info "skip")
  const float azd_Se = azd[Se];
  const float eobl = lut[127 * RR_K];       // EOB code length
  float ec_best = BIGF;
  int last = 64;
  float skip = 0.0f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = lane + 32 * h;
    const float end_wo = (acc[h] + azd_Se) - azd[j];
    float ec = end_wo + (j < Se ? eobl : 0.0f);
    if (!nzj[h]) ec = BIGF;
    float wo = end_wo;
    if (j == Ss - 1) {
      ec = azd_Se + eobl;
      wo = azd_Se;
    }
    if (ec < ec_best || (ec == ec_best && j < last)) {
      ec_best = ec;
      last = j;
      skip = wo;
    }
  }
  warp_argmin(ec_best, last, skip);

  unsigned long long keep = 0;
  if (lane == 0) {                          // path walk
    int cur = last;
    for (int s = 0; s <= Se - Ss; ++s) {
      if (cur >= Ss) {
        keep |= 1ull << cur;
        cur = rs[cur];
      } else {
        cur = Ss - 1;
      }
    }
  }
  keep = __shfl_sync(FULL, keep, 0);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = lane + 32 * h;
    const bool kept = ((keep >> p) & 1ull) && nzj[h];
    const int v = bv[p];
    nb_out[(long long)p * N + n] = kept ? (raw_p[h] < 0 ? -v : v) : 0;
  }
  if (lane < 8) {
    float e = 0.0f;
    if (lane == 0) e = azd_Se;
    if (lane == 1) e = skip;
    if (lane == 2) e = (float)(last < Se) + (float)(last == Ss - 1);
    ei_out[(long long)lane * N + n] = e;
  }
}

}  // namespace

// raw (64, N) int32, qtbl (64,) int32, ltbl (64,) f32, luts (B, 128, 16)
// f32, lam (N,) f32 -> nb (64, N) int32, ei (8, N) f32; N = B * n_img,
// image-major. Launches on `stream` and returns cudaGetLastError().
extern "C" int mj_trellis_ac(const void* raw, const void* qtbl,
                             const void* ltbl, const void* luts,
                             const void* lam, void* nb, void* ei,
                             long long N, long long n_img, int Ss, int Se,
                             void* stream) {
  if (N <= 0) return 0;
  const long long grid = (N + WARPS - 1) / WARPS;
  trellis_ac_kernel<<<(unsigned)grid, WARPS * 32, 0,
                      (cudaStream_t)stream>>>(
      (const int32_t*)raw, (const int32_t*)qtbl, (const float*)ltbl,
      (const float*)luts, (const float*)lam, (int32_t*)nb, (float*)ei, N,
      n_img, Ss, Se);
  return (int)cudaGetLastError();
}
