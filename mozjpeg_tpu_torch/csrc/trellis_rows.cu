// The trellis program's two row scans: the DC trellis and the EOB-run DP.
//
// Neither replaces a Pallas kernel. They replace XLA code of the JAX
// package's trellis program that the port first ran as Python loops of a
// few small launches per block column:
//   - trellis_dc_kernel: mozjpeg_tpu/codec/trellis.py:89-156
//     (trellis_dc_rows, a lax.scan over block columns and a walk back),
//     run per phase by make_trellis_all_t (:500-537); mozjpeg's DC trellis
//     (jcdctmgr.c:1040-1120, 1300-1328) with lastDC chained through the v
//     block rows of an iMCU row and reset at each (jccoefct.c:417-419);
//   - eob_dp_kernel: mozjpeg_tpu/codec/trellis.py:319-380 (_eob_block_dp,
//     trellis_eob_opt's block-level DP, jcdctmgr.c:1224-1297).
//
// Bound: neither bytes nor operations, but the serial chain. The DC
// trellis reads 8 bytes and writes 4 a block (about 12 B, 0.9 MB for a
// group of eight 768x512 4:2:0 images: 0.3 us at 3.35 TB/s) and does nc^2
// <= 81 candidate pairs a block (a few tens of ns at the f32 rate); the
// EOB DP reads 12 bytes and writes 1 a block and does about L/2 candidate
// costs a block. But step t of a row needs step t-1's costs, and a DC
// chain runs v rows in turn, so one chain is v*bw dependent steps (1,008
// for a 12 MP luma iMCU row), and a row of the EOB DP is L dependent
// steps. What the design does about it: one warp per chain (per row for
// the EOB DP), all chains of a component in one launch, so the card runs
// 189-512 chains side by side and each chain's step is as short as it can
// be: predecessors come from registers by __shfl_sync, back-pointers and
// row state stay in shared memory, the next column's inputs load one step
// ahead, and nothing returns to the host between steps.
//
// Exactness (the plain versions in ops/trellis_rows.py are the spec):
// build with -fmad=false, and every f32 operation that feeds another is an
// explicit __fadd_rn / __fsub_rn / __fmul_rn in the plain version's order.
// int32 products and differences that the JAX program lets wrap (12-bit
// DC squares, cand * q8 with 16-bit quant tables) are computed unsigned,
// whose wrap is defined, and converted back. First-minimum ties as
// torch.argmin: a strict '<' fold in ascending index, then a warp
// reduction on the lexicographic (value, index).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;            // chains (rows) per CTA at most
constexpr int DC_NC_MAX = 9;        // DC_TRELLIS_MAX_CANDIDATES
constexpr int DC_SI_N = 17;         // DC code lengths by category 0..16
// dynamic shared memory a CTA may take (the H100's 227 KB less the static
// arrays and some slack)
constexpr int SMEM_MAX = 227 * 1024 - 1024;
constexpr int SMEM_DEFAULT = 48 * 1024;
constexpr float BIGF = 1e38f;       // the EOB DP's "invalid" cost

struct DcTable {
  int si[DC_SI_N];
};

__device__ __forceinline__ int nbits(int v) {
  return v > 0 ? 32 - __clz(v) : 0;
}

// int32 arithmetic with two's complement wrap, as the JAX program's
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

// Lexicographic (value, index) minimum over the warp: every lane ends
// with the first minimum of all lanes' (value, index) pairs.
__device__ __forceinline__ void warp_first_min(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(FULL, v, off);
    const int oi = __shfl_xor_sync(FULL, i, off);
    if (ov < v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

__host__ __device__ __forceinline__ int align16(long long b) {
  return (int)((b + 15) & ~15ll);
}

// ---------------------------------------------------------------------------
// DC trellis
// ---------------------------------------------------------------------------

// Candidate k's magnitude (before the sign) at a block of raw DC r.
__device__ __forceinline__ int dc_mag(int r, int q8, int half, int k,
                                      int maxq) {
  const int x = r < 0 ? -r : r;
  const int m = (x + (q8 >> 1)) / q8 - half + k;
  return m < -maxq ? -maxq : (m > maxq ? maxq : m);
}

// trans(d) = nbits(|d|) + dc_si[nbits(|d|)], exact in f32
__device__ __forceinline__ float dc_trans(const int* si, int d) {
  const int b = nbits(d < 0 ? -d : d);
  return (float)(b + si[b]);
}

// One warp per chain: the rows i*v .. i*v + v - 1 (< bh) of one image's
// iMCU row i, in turn. Lane k < nc holds candidate k: its signed value
// and accumulated cost; the predecessors' come by shuffle. Lanes nc..31
// shadow candidate nc - 1 and are never read. Per warp in shared memory:
// the chosen DC of the row above (bw ints; the vertical gradient's
// above_dc) and the back-pointers of the current row (bw x nc bytes),
// whose column t is overwritten by the walk back with the chosen index.
__global__ void __launch_bounds__(WARPS * 32)
trellis_dc_kernel(const int32_t* __restrict__ raw,
                  const float* __restrict__ lam, int32_t* __restrict__ out,
                  int bh, int bw, int v, long long chains, int per_img,
                  int q0, float ltbl0, DcTable tab, int nc, int grad_on,
                  float w, int maxq, int warp_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_si[DC_SI_N];
  if (threadIdx.x < DC_SI_N) s_si[threadIdx.x] = tab.si[threadIdx.x];
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long chain = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (chain >= chains) return;
  const long long img = chain / per_img;
  const int r0 = (int)(chain % per_img) * v;
  int* s_dc = (int*)(smem + (size_t)warp * warp_bytes);
  uint8_t* bts = (uint8_t*)(s_dc + bw);
  const int q8 = q0 * 8, half = nc / 2;
  const int k = lane < nc ? lane : nc - 1;
  int last = 0;                                 // lastDC, 0 at the chain
  for (int p = 0; p < v && r0 + p < bh; ++p) {
    const long long row = (img * bh + r0 + p) * (long long)bw;
    const int32_t* rr = raw + row;
    const float* lr = lam + row;
    const bool grad = grad_on && p > 0;         // the row above: r0+p-1
    int r_n = rr[0], ar_n = grad ? rr[0 - bw] : 0;
    float l_n = lr[0];
    float acc = 0.0f;
    int pc = 0;
    for (int t = 0; t < bw; ++t) {
      const int r = r_n, a_raw = ar_n;
      const float lm = l_n;
      if (t + 1 < bw) {                         // the next column, early
        r_n = rr[t + 1];
        l_n = lr[t + 1];
        if (grad) ar_n = rr[t + 1 - bw];
      }
      const int x = r < 0 ? -r : r;
      const int cm = dc_mag(r, q8, half, k, maxq);
      const int c = r < 0 ? -cm : cm;
      const float lam_dc = __fmul_rn(lm, ltbl0);
      const int d = wsub(wmul(cm, q8), x);
      float dist = __fmul_rn((float)wmul(d, d), lam_dc);
      if (grad) {
        const int vd = wsub(wsub(a_raw, r),
                            wsub(wmul(s_dc[t], q8), wmul(c, q8)));
        const float vdist = __fmul_rn((float)wmul(vd, vd), lam_dc);
        dist = __fadd_rn(dist, __fmul_rn(w, __fsub_rn(vdist, dist)));
      }
      if (t == 0) {
        acc = __fadd_rn(dc_trans(s_si, c - last), dist);
      } else {
        float best = 0.0f;
        int bl = 0;
#pragma unroll
        for (int l = 0; l < DC_NC_MAX; ++l) {
          if (l >= nc) break;                   // uniform over the warp
          const float al = __shfl_sync(FULL, acc, l);
          const int cl = __shfl_sync(FULL, pc, l);
          const float cost =
              __fadd_rn(__fadd_rn(dc_trans(s_si, c - cl), dist), al);
          if (l == 0 || cost < best) {
            best = cost;
            bl = l;
          }
        }
        if (lane < nc) bts[t * nc + lane] = (uint8_t)bl;
        acc = best;
      }
      pc = c;
    }
    // the final choice: the first minimum of the nc accumulated costs
    float fv = lane < nc ? acc : __int_as_float(0x7f800000);
    int fi = lane;
    warp_first_min(fv, fi);
    __syncwarp();
    if (lane == 0) {                            // the walk back
      int cur = fi;
      for (int t = bw - 1; t > 0; --t) {
        const int nxt = bts[t * nc + cur];
        bts[t * nc] = (uint8_t)cur;
        cur = nxt;
      }
      bts[0] = (uint8_t)cur;
    }
    __syncwarp();
    for (int t = lane; t < bw; t += 32) {
      const int r = rr[t];
      const int cm = dc_mag(r, q8, half, bts[t * nc], maxq);
      const int c = r < 0 ? -cm : cm;
      out[row + t] = c;
      s_dc[t] = c;                              // the next row's above_dc
    }
    __syncwarp();
    last = s_dc[bw - 1];
  }
}

// ---------------------------------------------------------------------------
// EOB-run DP
// ---------------------------------------------------------------------------

// One warp per block row of L blocks. Before the DP the warp stages the
// row's skip costs and req = [0, has_eob...] and the serial prefix azbc of
// the all-zero costs (lane 0, C order), and each row's EOBn cost by run
// bit length, nb + ac_si[img][16 * nb]. Step b of the DP then takes the
// first minimum over i in [0, b + 1] (index b + 1 and every later one are
// BIG in the plain version, so no later index can be its first minimum):
// lanes fold i = lane, lane + 32, ... and the warp reduces.
__global__ void __launch_bounds__(WARPS * 32)
eob_dp_kernel(const float* __restrict__ ei, const int32_t* __restrict__ ac_si,
              uint8_t* __restrict__ kept, long long N, long long R, int L,
              int bh, int warp_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long r = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (r >= R) return;
  float* s_rate = (float*)(smem + (size_t)warp * warp_bytes);   // 16
  float* azbc = s_rate + 16;                                    // L + 1
  float* abc = azbc + (L + 1);                                  // L + 1
  float* skip = abc + (L + 1);                                  // L
  int16_t* brs = (int16_t*)(skip + L);                          // L
  int8_t* req = (int8_t*)(brs + L);                             // L + 1
  const long long o = r * L;
  const int32_t* si = ac_si + (r / bh) * 256;
  if (lane < 16)
    s_rate[lane] = __fadd_rn((float)lane, (float)si[16 * lane]);
  for (int b = lane; b < L; b += 32) {
    azbc[b + 1] = ei[o + b];                    // czero, summed below
    skip[b] = ei[N + o + b];
    req[b + 1] = (int8_t)(int)ei[2 * N + o + b];
  }
  if (lane == 0) {
    req[0] = 0;
    abc[0] = 0.0f;
    azbc[0] = 0.0f;
  }
  __syncwarp();
  if (lane == 0) {                              // azbc[b+1] = azbc[b] + czero[b]
    float a = 0.0f;
    for (int b = 1; b <= L; ++b) {
      a = __fadd_rn(a, azbc[b]);
      azbc[b] = a;
    }
  }
  __syncwarp();
  const float inf = __int_as_float(0x7f800000);
  for (int b = 0; b < L; ++b) {
    float bv = BIGF;
    int bi = 0;
    if (req[b + 1] != 2) {                      // the block is not all zero
      const float base = __fadd_rn(skip[b], azbc[b]);
      bv = inf;
      bi = 1 << 30;
      for (int i0 = 0; i0 <= b + 1; i0 += 32) {
        const int i = i0 + lane;
        if (i > b + 1) break;
        float c = BIGF;
        const int rq = req[i];
        if (i <= b && rq != 2)
          c = __fadd_rn(__fadd_rn(__fsub_rn(base, azbc[i]), abc[i]),
                        s_rate[nbits(b - i + rq)]);
        if (c < bv) {
          bv = c;
          bi = i;
        }
      }
      warp_first_min(bv, bi);
    }
    if (lane == 0) {
      abc[b + 1] = bv;
      brs[b] = (int16_t)bi;
    }
    __syncwarp();
  }
  // the final EOB run to the end of the row, over i in [0, L]
  const float az_l = azbc[L];
  float fv = inf;
  int fi = 1 << 30;
  for (int i = lane; i <= L; i += 32) {
    const int rq = req[i];
    const float c = rq != 2 ? __fadd_rn(__fsub_rn(az_l, azbc[i]),
                                        s_rate[nbits(L - i + rq)])
                            : BIGF;
    if (c < fv) {
      fv = c;
      fi = i;
    }
  }
  warp_first_min(fv, fi);
  if (lane == 0) {                              // the walk back
    int lastb = fi - 1;
    for (int b = L - 1; b >= 0; --b) {
      const bool k = lastb == b;
      kept[o + b] = k;
      if (k) lastb = brs[b] - 1;
    }
  }
}

// warps per CTA for a per-warp shared size, or 0 if one warp does not fit
int warps_for(int warp_bytes) {
  if (warp_bytes > SMEM_MAX) return 0;
  const int w = SMEM_MAX / warp_bytes;
  return w < WARPS ? w : WARPS;
}

template <typename K>
int prepare(K kernel, size_t smem) {
  if (smem <= (size_t)SMEM_DEFAULT) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// raw (B, bh, bw) int32 (row 0 of a component's raw plane), lam (B, bh,
// bw) f32 -> out (B, bh, bw) int32, the chosen DC of every block. q0 the
// DC quant value, ltbl0 = 1/(q0*q0) as the host IEEE table has it, dc_si
// the 17 DC code lengths (host memory, passed by value), nc <= 9
// candidates, v block rows per iMCU row, grad_on with delta_w the
// vertical-gradient weight, maxq the candidates' clamp. One launch on
// `stream`; returns cudaGetLastError() (cudaErrorInvalidValue for
// arguments the kernel does not take).
extern "C" int mj_trellis_dc(const void* raw, const void* lam, void* out,
                             int B, int bh, int bw, int v, int q0,
                             float ltbl0, const int* dc_si, int nc,
                             int grad_on, float delta_w, int maxq,
                             void* stream) {
  if (B <= 0 || bh <= 0 || bw <= 0) return 0;
  if (nc < 1 || nc > DC_NC_MAX || v < 1 || q0 < 1)
    return (int)cudaErrorInvalidValue;
  DcTable tab;
  for (int i = 0; i < DC_SI_N; ++i) tab.si[i] = dc_si[i];
  const int per_img = (bh + v - 1) / v;
  const long long chains = (long long)B * per_img;
  const int warp_bytes = align16((long long)bw * 4 + (long long)bw * nc);
  const int warps = warps_for(warp_bytes);
  if (!warps) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)warps * warp_bytes;
  int rc = prepare(trellis_dc_kernel, smem);
  if (rc) return rc;
  const long long grid = (chains + warps - 1) / warps;
  trellis_dc_kernel<<<(unsigned)grid, warps * 32, smem,
                      (cudaStream_t)stream>>>(
      (const int32_t*)raw, (const float*)lam, (int32_t*)out, bh, bw, v,
      chains, per_img, q0, ltbl0, tab, nc, grad_on, delta_w, maxq,
      warp_bytes);
  return (int)cudaGetLastError();
}

// ei (8, N) f32, the AC kernel's strip (rows czero, skip, has_eob), ac_si
// (B, 256) int32 -> kept (R, L) bool with R = N / L block rows of bh per
// image. One launch on `stream`; returns cudaGetLastError().
extern "C" int mj_eob_dp(const void* ei, const void* ac_si, void* kept,
                         long long N, int L, int bh, void* stream) {
  if (N <= 0) return 0;
  if (L <= 0 || L >= 32768 || bh <= 0 || N % L)
    return (int)cudaErrorInvalidValue;
  const long long R = N / L;
  const int warp_bytes =
      align16(16 * 4 + 4 * (3ll * L + 2) + 2ll * L + (L + 1));
  const int warps = warps_for(warp_bytes);
  if (!warps) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)warps * warp_bytes;
  int rc = prepare(eob_dp_kernel, smem);
  if (rc) return rc;
  const long long grid = (R + warps - 1) / warps;
  eob_dp_kernel<<<(unsigned)grid, warps * 32, smem, (cudaStream_t)stream>>>(
      (const float*)ei, (const int32_t*)ac_si, (uint8_t*)kept, N, R, L, bh,
      warp_bytes);
  return (int)cudaGetLastError();
}
