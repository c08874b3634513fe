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
// 189-512 chains side by side, and each chain's step is as short as it
// can be. The DC trellis takes everything but the min-plus step off the
// chain: before a row's chain the lanes write every column's candidates
// and distortions to shared memory (one division a column), the next
// column's nc pair costs are formed while the current column's dependent
// part runs, and that part is nc independent shuffles of the
// predecessors' costs, nc adds and a first-minimum tree of depth
// ceil(log2 nc); the walk back runs in up to 32 segments side by side.
// The EOB DP runs in push order: only candidate t of step t depends on
// step t - 1, so each lane folds every candidate into the later steps it
// owns as soon as that candidate's cost is final, and a step's chain is
// one shuffle and about seven dependent operations (two adds, a compare,
// selects, a max and a min); measured on the H100, a step still costs
// 0.1-0.2 us of one warp's dependent issue, so the DP stays chain-bound;
// the running states stay in registers up to EOB_REG_L steps a row, the
// row's inputs arrive in coalesced loads, the walk back follows the
// back-pointers alone and the kept bytes leave in coalesced stores.
// Nothing returns to the host between steps.
//
// Exactness (the plain versions in ops/trellis_rows.py are the spec):
// build with -fmad=false, and every f32 operation that feeds another is an
// explicit __fadd_rn / __fsub_rn / __fmul_rn in the plain version's order.
// int32 products and differences that the JAX program lets wrap (12-bit
// DC squares, cand * q8 with 16-bit quant tables) are computed unsigned,
// whose wrap is defined, and converted back. First-minimum ties as
// torch.argmin: the lexicographic (value, index) minimum, by a tree over
// a lane's candidates (the DC trellis), a strict '<' fold in ascending
// index (each EOB-DP step on its owner lane; the final run's lanes), and
// across lanes a warp reduction (the DC trellis's final choice, the EOB
// DP's final run).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;            // chains (rows) per CTA at most
constexpr int DC_NC_MAX = 9;        // DC_TRELLIS_MAX_CANDIDATES
constexpr int DC_SI_N = 17;         // DC code lengths by category 0..16
// the candidates' clamp at most: |c - c'| <= 2 * maxq < 2^16 keeps every
// DC difference inside the 17 categories the code lengths cover
constexpr int DC_MAXQ_MAX = 32767;
constexpr int DC_TC = 256;          // columns a tile of the per-row pass
constexpr int DC_PER = DC_TC / 32;  // columns a lane takes in that pass
// dynamic shared memory a CTA may take (the H100's 227 KB less the static
// arrays and some slack)
constexpr int SMEM_MAX = 227 * 1024 - 1024;
constexpr int SMEM_DEFAULT = 48 * 1024;
constexpr float BIGF = 1e38f;       // the EOB DP's "invalid" cost
// steps of an EOB-DP row whose running states stay in registers (16 a
// lane; a 12 MP luma row is 504)
constexpr int EOB_REG_L = 512;

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

// trans(d) = nbits(|d|) + dc_si[nbits(|d|)], exact in f32, from the
// table by nbits (|d| < 2^16); nbits(v) = 32 - __clz(v), also at v = 0,
// with no select on the chain step's issue path
__device__ __forceinline__ float dc_trans(const float* tf, int d) {
  return tf[32 - __clz(d < 0 ? -d : d)];
}

// The first minimum of v[0..NC) as a tree of depth ceil(log2 NC): each
// node keeps its left (lower-index) child unless the right one is
// strictly smaller, so that the result is the lexicographic (value,
// index) minimum, as torch.argmin's first index and the strict ascending
// fold give it. The result is in v[0], ix[0].
template <int NC>
__device__ __forceinline__ void first_min_tree(float (&v)[NC],
                                               int (&ix)[NC]) {
#pragma unroll
  for (int s = 1; s < NC; s *= 2)
#pragma unroll
    for (int j = 0; j + s < NC; j += 2 * s)
      if (v[j + s] < v[j]) {
        v[j] = v[j + s];
        ix[j] = ix[j + s];
      }
}

// Candidate k's nc pair costs at tile column i: trans(c[i][k] - c[i-1][l])
// + dist[i][k] for every predecessor l, from the tile's slots (tc slot i
// is column i - 1, td slot i column i). Nothing here depends on the chain.
template <int NC>
__device__ __forceinline__ void dc_pairs(const int* tc, const float* td,
                                         const float* tf, int i, int k,
                                         float (&pr)[NC]) {
  const int ck = tc[(i + 1) * NC + k];
  const float dk = td[i * NC + k];
#pragma unroll
  for (int l = 0; l < NC; ++l)
    pr[l] = __fadd_rn(dc_trans(tf, ck - tc[i * NC + l]), dk);
}

// One warp per chain: the rows i*v .. i*v + v - 1 (< bh) of one image's
// iMCU row i, in turn, lastDC starting at 0. Per row:
//   1. per tile of tw columns, the lanes stride over the columns (one
//      division a column) and write every candidate c[t][k] and its
//      distortion dist[t][k] (with the vertical gradient against the row
//      above's chosen DC) to shared memory;
//   2. the chain over the tile: lane k < NC holds candidate k's
//      accumulated cost; the next column's NC pair costs are formed while
//      the current column's dependent part runs (software-pipelined one
//      step ahead), so that a step's dependent path is NC independent
//      shuffles of acc, NC adds and the first-minimum tree;
//   3. the walk back in at most 32 segments of S columns: lane j follows
//      the back-pointers through its segment from each of the NC end
//      states at once, the segments' maps are chained from the last
//      segment down (at most 31 shared loads), then lane j writes its
//      segment's chosen indices;
//   4. the chosen DC of every column (coalesced), which is the next
//      row's above_dc.
// Lanes NC..31 shadow candidate NC - 1 and are never read. With CLOCKS,
// lane 0 of each chain adds the SM cycles of steps 1-4 into clocks[chain
// * 4 + step] (the measurement's instantiation; the wrapper's has none).
// Per warp in
// shared memory: the row above's chosen DC (bw ints), the tile's
// candidates (tw + 1 slots of NC ints, slot 0 the column before the
// tile; reused by the walk back's segment maps) and distortions (tw x NC
// floats), and the row's back-pointers (bw x NC bytes, column t's first
// overwritten by the walk back with the chosen index).
template <int NC, bool CLOCKS>
__global__ void __launch_bounds__(WARPS * 32)
trellis_dc_kernel(const int32_t* __restrict__ raw,
                  const float* __restrict__ lam, int32_t* __restrict__ out,
                  int bh, int bw, int v, long long chains, int per_img,
                  int q0, float ltbl0, DcTable tab, int grad_on, float w,
                  int maxq, int tw, int warp_bytes,
                  long long* __restrict__ clocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_tf[DC_SI_N];   // trans by nbits(|d|)
  if (threadIdx.x < DC_SI_N)
    s_tf[threadIdx.x] = (float)((int)threadIdx.x + tab.si[threadIdx.x]);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long chain = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (chain >= chains) return;
  const long long img = chain / per_img;
  const int r0 = (int)(chain % per_img) * v;
  int* s_dc = (int*)(smem + (size_t)warp * warp_bytes);
  int* tc = s_dc + bw;
  float* td = (float*)(tc + (tw + 1) * NC);
  uint8_t* bts = (uint8_t*)(td + tw * NC);
  const int q8 = q0 * 8, half = NC / 2;
  const int k = lane < NC ? lane : NC - 1;
  const int S = (bw + 31) / 32, nseg = (bw + S - 1) / S;
  const int t0 = lane * S, t1 = min(t0 + S, bw) - 1;   // lane's segment
  long long cyc[4] = {0, 0, 0, 0};
  long long tick = CLOCKS ? clock64() : 0;
  auto lap = [&](int step) {
    if (CLOCKS) {
      __syncwarp();
      const long long now = clock64();
      cyc[step] += now - tick;
      tick = now;
    }
  };
  int last = 0;                                 // lastDC, 0 at the chain
  for (int p = 0; p < v && r0 + p < bh; ++p) {
    const long long row = (img * bh + r0 + p) * (long long)bw;
    const int32_t* rr = raw + row;
    const float* lr = lam + row;
    const bool grad = grad_on && p > 0;         // the row above: r0+p-1
    float acc = 0.0f;
    for (int ts = 0; ts < bw; ts += tw) {
      const int tn = min(tw, bw - ts);
      // 1. the tile's candidates and distortions
      __syncwarp();
      if (ts > 0 && lane < NC) tc[lane] = tc[tw * NC + lane];
      __syncwarp();
      int r_[DC_PER], a_[DC_PER];
      float l_[DC_PER];
#pragma unroll
      for (int u = 0; u < DC_PER; ++u) {        // every load first
        const int i = lane + 32 * u;
        r_[u] = a_[u] = 0;
        l_[u] = 0.0f;
        if (i < tn) {
          r_[u] = rr[ts + i];
          l_[u] = lr[ts + i];
          if (grad) a_[u] = rr[ts + i - bw];
        }
      }
#pragma unroll
      for (int u = 0; u < DC_PER; ++u) {
        const int i = lane + 32 * u;
        if (i < tn) {
          const int r = r_[u];
          const int x = r < 0 ? -r : r;
          const int base = (x + (q8 >> 1)) / q8 - half;
          const float lam_dc = __fmul_rn(l_[u], ltbl0);
          const int above = grad ? s_dc[ts + i] : 0;
#pragma unroll
          for (int kk = 0; kk < NC; ++kk) {
            const int m = base + kk;
            const int cm = m < -maxq ? -maxq : (m > maxq ? maxq : m);
            const int c = r < 0 ? -cm : cm;
            const int d = wsub(wmul(cm, q8), x);
            float dist = __fmul_rn((float)wmul(d, d), lam_dc);
            if (grad) {
              const int vd = wsub(wsub(a_[u], r),
                                  wsub(wmul(above, q8), wmul(c, q8)));
              const float vdist = __fmul_rn((float)wmul(vd, vd), lam_dc);
              dist = __fadd_rn(dist, __fmul_rn(w, __fsub_rn(vdist, dist)));
            }
            tc[(i + 1) * NC + kk] = c;
            td[i * NC + kk] = dist;
          }
        }
      }
      __syncwarp();
      lap(0);
      // 2. the chain over the tile
      int i = 0;
      if (ts == 0) {                            // column 0, from lastDC
        acc = __fadd_rn(dc_trans(s_tf, tc[NC + k] - last), td[k]);
        i = 1;
      }
      if (i < tn) {
        float pn[NC];
        dc_pairs<NC>(tc, td, s_tf, i, k, pn);
#pragma unroll 2
        for (; i < tn; ++i) {
          float cost[NC];
          int ix[NC];
#pragma unroll
          for (int l = 0; l < NC; ++l) {
            cost[l] = pn[l];
            ix[l] = l;
          }
          // the next column's pair costs, off the dependent path (the
          // last column recomputes its own)
          dc_pairs<NC>(tc, td, s_tf, min(i + 1, tn - 1), k, pn);
#pragma unroll
          for (int l = 0; l < NC; ++l)
            cost[l] = __fadd_rn(cost[l], __shfl_sync(FULL, acc, l));
          first_min_tree<NC>(cost, ix);
          if (lane < NC) bts[(ts + i) * NC + lane] = (uint8_t)ix[0];
          acc = cost[0];
        }
      }
      lap(1);
    }
    // the final choice: the first minimum of the NC accumulated costs
    float fv = lane < NC ? acc : __int_as_float(0x7f800000);
    int fi = lane;
    warp_first_min(fv, fi);
    // 3. the walk back. Segment j's map: each end state e at column t1
    // -> the state at column t0 - 1 (the end state of segment j - 1),
    // into the free tile buffer
    __syncwarp();
    int* seg = tc;
    if (lane < nseg) {
      int cur[NC];
#pragma unroll
      for (int e = 0; e < NC; ++e) cur[e] = e;
      for (int t = t1; t > t0; --t)
#pragma unroll
        for (int e = 0; e < NC; ++e) cur[e] = bts[t * NC + cur[e]];
      if (lane > 0)
#pragma unroll
        for (int e = 0; e < NC; ++e) seg[lane * NC + e] = bts[t0 * NC + cur[e]];
    }
    __syncwarp();
    if (lane < nseg) {
      int cur = fi;                             // the state at column bw-1
      for (int j = nseg - 1; j > lane; --j) cur = seg[j * NC + cur];
      for (int t = t1; t > t0; --t) {
        const int nxt = bts[t * NC + cur];
        bts[t * NC] = (uint8_t)cur;
        cur = nxt;
      }
      bts[t0 * NC] = (uint8_t)cur;
    }
    __syncwarp();
    lap(2);
    // 4. the chosen DC of every column
    for (int t = lane; t < bw; t += 32) {
      const int r = rr[t];
      const int cm = dc_mag(r, q8, half, bts[t * NC], maxq);
      const int c = r < 0 ? -cm : cm;
      out[row + t] = c;
      s_dc[t] = c;                              // the next row's above_dc
    }
    __syncwarp();
    last = s_dc[bw - 1];
    lap(3);
  }
  if (CLOCKS && lane == 0)
    for (int i = 0; i < 4; ++i) clocks[chain * 4 + i] = cyc[i];
}

// ---------------------------------------------------------------------------
// EOB-run DP
// ---------------------------------------------------------------------------

// One warp per block row of L blocks, in push order. Before the DP the
// warp stages the row's czero (coalesced, then summed on one lane in C
// order into the prefix azbc), base[b] = skip[b] + azbc[b], req = [0,
// has_eob...] and the row's EOBn cost by run bit length, nb +
// ac_si[img][16 * nb]. Step b takes the first minimum over candidates i
// in [0, b + 1] of (((base[b] - azbc[i]) + abc[i]) + rate(b - i +
// req[i])), BIG where req[i] is 2 or i = b + 1 (every later index is BIG
// too in the plain version, so none can be its first minimum). Lane l
// owns steps l, l + 32, ... and keeps each one's running (cost, index).
// When abc[t] is final, every lane folds candidate t into its steps b >=
// t with a strict '<' (candidates come in ascending order, so the first
// minimum survives, as torch.argmin's); step t's owner then folds the
// BIG candidate t + 1, or takes (BIG, 0) if block t is all zero, and one
// shuffle hands abc[t + 1] to every lane. The chain of a step is that
// shuffle, two dependent adds (the owner's own candidate has the run
// req[t], 0 or 1, so its rate is one of two registers), a compare and a
// select, and the close as a max and a min: every other candidate of a
// step was known a step or more earlier, the other steps' folds issue
// beside the chain, and nothing on it branches or waits on shared memory.
// Up to EOB_REG_L steps the running states live in registers (SLOTS steps
// a lane, a compile-time count); longer rows keep them in shared memory.
template <int SLOTS>
__device__ __forceinline__ void eob_push_regs(
    const float* s_rate, const float* azbc, const float* base_s,
    const int8_t* req, int16_t* brs, int L, int lane) {
  float bv[SLOTS], base[SLOTS];
  int bi[SLOTS];
  unsigned zero = 0;                 // bit j: block 32j + lane is all zero
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int b = 32 * j + lane;
    base[j] = b < L ? base_s[b] : 0.0f;
    bv[j] = __int_as_float(0x7f800000);
    bi[j] = 0;
    if (b < L && req[b + 1] == 2) zero |= 1u << j;
  }
  float abc = 0.0f;                  // abc[t], the same in every lane
  // step t's own candidate t has the run req[t], 0 or 1: its rate
  const float r0 = s_rate[0], r1 = s_rate[1];
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    if (32 * j >= L) break;
    const int tn = min(32, L - 32 * j);
    // step t's close on its owner: (BIG, 0) for an all-zero block, else
    // the BIG candidate t + 1: min(max(cost, floor), BIG) with the floor
    // BIG or -inf
    const float floor_j = (zero >> j) & 1u ? BIGF
                                           : -__int_as_float(0x7f800000);
    float az = azbc[32 * j];
    int rq = req[32 * j];
    for (int tt = 0; tt < tn; ++tt) {
      const int t = 32 * j + tt;
      const float az_n = azbc[t + 1];            // the next step's, ahead
      const int rq_n = req[t + 1];
      const bool live = rq != 2;
      const float x = __fsub_rn(base[j], az);
      // the chain: candidate t on its owner lane tt, the close, one
      // shuffle
      const float co = __fadd_rn(__fadd_rn(x, abc), rq == 1 ? r1 : r0);
      const float cvo = live ? co : BIGF;
      const bool updo = cvo < bv[j];
      const float bvo = updo ? cvo : bv[j];
      const float fin = fminf(fmaxf(bvo, floor_j), BIGF);
      const float abc_n = __shfl_sync(FULL, fin, tt);
      // beside the chain: the owner's index, and candidate t on the
      // lanes > tt of chunk j and on every later chunk
      const int bio = (zero >> j) & 1u ? 0
                      : (BIGF < bvo ? t + 1 : (updo ? t : bi[j]));
      const int d0 = lane - t + rq;              // run of slot 0 minus 32 jj
      {
        const float c = __fadd_rn(__fadd_rn(x, abc),
                                  s_rate[(32 - __clz(32 * j + d0)) & 31]);
        const float cv = live ? c : BIGF;
        const bool upd = (lane > tt) & (cv < bv[j]);
        bv[j] = upd ? cv : bv[j];
        bi[j] = lane == tt ? bio : (upd ? t : bi[j]);
      }
#pragma unroll
      for (int jj = j + 1; jj < SLOTS; ++jj) {
        const float c2 = __fadd_rn(__fadd_rn(__fsub_rn(base[jj], az), abc),
                                   s_rate[(32 - __clz(32 * jj + d0)) & 31]);
        const float cv2 = live ? c2 : BIGF;
        const bool upd2 = cv2 < bv[jj];
        bv[jj] = upd2 ? cv2 : bv[jj];
        bi[jj] = upd2 ? t : bi[jj];
      }
      abc = abc_n;
      az = az_n;
      rq = rq_n;
    }
  }
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int b = 32 * j + lane;
    if (b < L) brs[b] = (int16_t)bi[j];
  }
}

// The same push order with the running states in shared memory (bv, and
// the running index in brs), for rows longer than EOB_REG_L.
__device__ __forceinline__ void eob_push_smem(
    const float* s_rate, const float* azbc, const float* base_s,
    const int8_t* req, float* bv, int16_t* brs, int L, int lane) {
  for (int b = lane; b < L; b += 32) {
    bv[b] = __int_as_float(0x7f800000);
    brs[b] = 0;
  }
  __syncwarp();
  float abc = 0.0f;
  for (int t = 0; t < L; ++t) {
    const float az = azbc[t];
    const int rq = req[t];
    const int j = t >> 5, tt = t & 31;
    float fin = 0.0f;
    {                                            // the owner's chunk
      const int b = 32 * j + lane;
      if (lane >= tt && b < L) {
        float v = bv[b];
        int bi = brs[b];
        const float c = rq != 2
            ? __fadd_rn(__fadd_rn(__fsub_rn(base_s[b], az), abc),
                        s_rate[nbits(b - t + rq)])
            : BIGF;
        if (c < v) {
          v = c;
          bi = t;
        }
        if (lane == tt) {                        // close step t
          const bool z = req[t + 1] == 2;
          const bool big = BIGF < v;
          fin = z ? BIGF : (big ? BIGF : v);
          bi = z ? 0 : (big ? t + 1 : bi);
        }
        bv[b] = v;
        brs[b] = (int16_t)bi;
      }
    }
    const float abc_n = __shfl_sync(FULL, fin, tt);
    for (int b = 32 * (j + 1) + lane; b < L; b += 32) {
      const float c = rq != 2
          ? __fadd_rn(__fadd_rn(__fsub_rn(base_s[b], az), abc),
                      s_rate[nbits(b - t + rq)])
          : BIGF;
      if (c < bv[b]) {
        bv[b] = c;
        brs[b] = (int16_t)t;
      }
    }
    abc = abc_n;
  }
  __syncwarp();
}

// A warp's shared memory: s_rate (32 f32, the EOBn costs by bit length
// and padding), azbc (L + 1 f32), base (L f32), for SLOTS = 0 the running
// costs (L f32), brs (L int16), req (L + 1 int8, then the kept marks).
template <int SLOTS>
__global__ void __launch_bounds__(WARPS * 32)
eob_dp_kernel(const float* __restrict__ ei, const int32_t* __restrict__ ac_si,
              uint8_t* __restrict__ kept, long long N, long long R, int L,
              int bh, int warp_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long r = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (r >= R) return;
  float* s_rate = (float*)(smem + (size_t)warp * warp_bytes);   // 32
  float* azbc = s_rate + 32;                                    // L + 1
  float* base = azbc + (L + 1);                                 // L
  float* bv = base + L;                                         // L or 0
  int16_t* brs = (int16_t*)(bv + (SLOTS ? 0 : L));              // L
  int8_t* req = (int8_t*)(brs + L);                             // L + 1
  const long long o = r * L;
  const int32_t* si = ac_si + (r / bh) * 256;
  s_rate[lane] = lane < 16 ? __fadd_rn((float)lane, (float)si[16 * lane])
                           : 0.0f;
  for (int b = lane; b < L; b += 32) {
    azbc[b + 1] = ei[o + b];                    // czero, summed below
    base[b] = ei[N + o + b];                    // skip, azbc added below
    req[b + 1] = (int8_t)(int)ei[2 * N + o + b];
  }
  if (lane == 0) {
    req[0] = 0;
    azbc[0] = 0.0f;
  }
  __syncwarp();
  if (lane == 0) {                              // azbc[b+1] = azbc[b] + czero[b]
    float a = 0.0f;
#pragma unroll 8
    for (int b = 1; b <= L; ++b) {
      a = __fadd_rn(a, azbc[b]);
      azbc[b] = a;
    }
  }
  __syncwarp();
  for (int b = lane; b < L; b += 32) base[b] = __fadd_rn(base[b], azbc[b]);
  __syncwarp();
  if (SLOTS)
    eob_push_regs<SLOTS ? SLOTS : 1>(s_rate, azbc, base, req, brs, L, lane);
  else
    eob_push_smem(s_rate, azbc, base, req, bv, brs, L, lane);
  __syncwarp();
  // the final EOB run to the end of the row, over i in [0, L]
  const float inf = __int_as_float(0x7f800000);
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
  // the walk back: lane 0 marks the kept blocks, then coalesced stores
  uint8_t* keep = (uint8_t*)req;
  __syncwarp();
  for (int b = lane; b < L; b += 32) keep[b] = 0;
  __syncwarp();
  if (lane == 0) {
    int last = fi - 1;
    while (last >= 0 && last < L) {
      keep[last] = 1;
      const int nxt = brs[last] - 1;
      if (nxt >= last) break;
      last = nxt;
    }
  }
  __syncwarp();
  for (int b = lane; b < L; b += 32) kept[o + b] = keep[b];
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

struct DcArgs {
  const int32_t* raw;
  const float* lam;
  int32_t* out;
  int bh, bw, v;
  long long chains;
  int per_img, q0;
  float ltbl0;
  DcTable tab;
  int grad_on;
  float w;
  int maxq, tw, warp_bytes, warps;
  cudaStream_t stream;
  long long* clocks;
};

template <int NC, bool CLOCKS>
int launch_dc(const DcArgs& a) {
  const size_t smem = (size_t)a.warps * a.warp_bytes;
  const int rc = prepare(trellis_dc_kernel<NC, CLOCKS>, smem);
  if (rc) return rc;
  const long long grid = (a.chains + a.warps - 1) / a.warps;
  trellis_dc_kernel<NC, CLOCKS>
      <<<(unsigned)grid, a.warps * 32, smem, a.stream>>>(
          a.raw, a.lam, a.out, a.bh, a.bw, a.v, a.chains, a.per_img, a.q0,
          a.ltbl0, a.tab, a.grad_on, a.w, a.maxq, a.tw, a.warp_bytes,
          a.clocks);
  return (int)cudaGetLastError();
}

template <bool CLOCKS>
int launch_dc_nc(int nc, const DcArgs& a) {
  switch (nc) {
    case 1: return launch_dc<1, CLOCKS>(a);
    case 2: return launch_dc<2, CLOCKS>(a);
    case 3: return launch_dc<3, CLOCKS>(a);
    case 4: return launch_dc<4, CLOCKS>(a);
    case 5: return launch_dc<5, CLOCKS>(a);
    case 6: return launch_dc<6, CLOCKS>(a);
    case 7: return launch_dc<7, CLOCKS>(a);
    case 8: return launch_dc<8, CLOCKS>(a);
    default: return launch_dc<9, CLOCKS>(a);
  }
}

__global__ void empty_kernel() {}

}  // namespace

// raw (B, bh, bw) int32 (row 0 of a component's raw plane), lam (B, bh,
// bw) f32 -> out (B, bh, bw) int32, the chosen DC of every block. q0 the
// DC quant value, ltbl0 = 1/(q0*q0) as the host IEEE table has it, dc_si
// the 17 DC code lengths (host memory, passed by value), nc <= 9
// candidates, v block rows per iMCU row, grad_on with delta_w the
// vertical-gradient weight, maxq <= 32767 the candidates' clamp. One
// launch on `stream`; returns cudaGetLastError() (cudaErrorInvalidValue
// for arguments the kernel does not take).
namespace {

// mj_trellis_dc and mj_trellis_dc_clocks: the checks and one launch
int trellis_dc_launch(const void* raw, const void* lam, void* out, int B,
                      int bh, int bw, int v, int q0, float ltbl0,
                      const int* dc_si, int nc, int grad_on, float delta_w,
                      int maxq, void* stream, long long* clocks) {
  if (B <= 0 || bh <= 0 || bw <= 0) return 0;
  if (nc < 1 || nc > DC_NC_MAX || v < 1 || q0 < 1 || maxq < 0
      || maxq > DC_MAXQ_MAX)
    return (int)cudaErrorInvalidValue;
  DcTable tab;
  for (int i = 0; i < DC_SI_N; ++i) tab.si[i] = dc_si[i];
  const int per_img = (bh + v - 1) / v;
  const long long chains = (long long)B * per_img;
  const int tw = bw < DC_TC ? bw : DC_TC;
  const int warp_bytes = align16((long long)bw * 4
                                 + (2ll * tw + 1) * nc * 4
                                 + (long long)bw * nc);
  const int warps = warps_for(warp_bytes);
  if (!warps) return (int)cudaErrorInvalidValue;
  const DcArgs a{(const int32_t*)raw, (const float*)lam, (int32_t*)out, bh,
                 bw, v, chains, per_img, q0, ltbl0, tab, grad_on, delta_w,
                 maxq, tw, warp_bytes, warps, (cudaStream_t)stream, clocks};
  return clocks ? launch_dc_nc<true>(nc, a) : launch_dc_nc<false>(nc, a);
}

}  // namespace

extern "C" int mj_trellis_dc(const void* raw, const void* lam, void* out,
                             int B, int bh, int bw, int v, int q0,
                             float ltbl0, const int* dc_si, int nc,
                             int grad_on, float delta_w, int maxq,
                             void* stream) {
  return trellis_dc_launch(raw, lam, out, B, bh, bw, v, q0, ltbl0, dc_si,
                           nc, grad_on, delta_w, maxq, stream, nullptr);
}

// mj_trellis_dc's launch with each chain's SM cycles by step into clocks
// (B * ceil(bh / v) * 4 int64: the per-row pass, the chain, the walk
// back, the output), for the measurement of where the kernel's time goes.
extern "C" int mj_trellis_dc_clocks(const void* raw, const void* lam,
                                    void* out, int B, int bh, int bw, int v,
                                    int q0, float ltbl0, const int* dc_si,
                                    int nc, int grad_on, float delta_w,
                                    int maxq, void* clocks, void* stream) {
  if (!clocks) return (int)cudaErrorInvalidValue;
  return trellis_dc_launch(raw, lam, out, B, bh, bw, v, q0, ltbl0, dc_si,
                           nc, grad_on, delta_w, maxq, stream,
                           (long long*)clocks);
}

// A kernel that does nothing, one launch on `stream`: the launch floor
// beside the kernels' bounds.
extern "C" int mj_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

namespace {

template <int SLOTS>
int launch_eob(const void* ei, const void* ac_si, void* kept, long long N,
               long long R, int L, int bh, cudaStream_t stream) {
  const int warp_bytes = align16(32 * 4 + 4 * (L + 1) + 4ll * L
                                 + (SLOTS ? 0 : 4ll * L) + 2ll * L
                                 + (L + 1));
  const int warps = warps_for(warp_bytes);
  if (!warps) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)warps * warp_bytes;
  const int rc = prepare(eob_dp_kernel<SLOTS>, smem);
  if (rc) return rc;
  const long long grid = (R + warps - 1) / warps;
  eob_dp_kernel<SLOTS><<<(unsigned)grid, warps * 32, smem, stream>>>(
      (const float*)ei, (const int32_t*)ac_si, (uint8_t*)kept, N, R, L, bh,
      warp_bytes);
  return (int)cudaGetLastError();
}

}  // namespace

// ei (8, N) f32, the AC kernel's strip (rows czero, skip, has_eob), ac_si
// (B, 256) int32 -> kept (R, L) bool with R = N / L block rows of bh per
// image. One launch on `stream`: the instantiation whose registers hold
// ceil(L / 32) running states a lane (the next count it has), or, past
// EOB_REG_L, the one that keeps them in shared memory. Returns
// cudaGetLastError() (cudaErrorInvalidValue for a row whose shared memory
// does not fit).
extern "C" int mj_eob_dp(const void* ei, const void* ac_si, void* kept,
                         long long N, int L, int bh, void* stream) {
  if (N <= 0) return 0;
  if (L <= 0 || L >= 32768 || bh <= 0 || N % L)
    return (int)cudaErrorInvalidValue;
  const long long R = N / L;
  cudaStream_t st = (cudaStream_t)stream;
  const int slots = (L + 31) / 32;
  if (slots <= 1) return launch_eob<1>(ei, ac_si, kept, N, R, L, bh, st);
  if (slots <= 2) return launch_eob<2>(ei, ac_si, kept, N, R, L, bh, st);
  if (slots <= 3) return launch_eob<3>(ei, ac_si, kept, N, R, L, bh, st);
  if (slots <= 4) return launch_eob<4>(ei, ac_si, kept, N, R, L, bh, st);
  if (slots <= 6) return launch_eob<6>(ei, ac_si, kept, N, R, L, bh, st);
  if (slots <= 8) return launch_eob<8>(ei, ac_si, kept, N, R, L, bh, st);
  if (slots <= 12) return launch_eob<12>(ei, ac_si, kept, N, R, L, bh, st);
  static_assert(EOB_REG_L == 16 * 32, "the largest register instantiation");
  if (slots <= 16) return launch_eob<16>(ei, ac_si, kept, N, R, L, bh, st);
  return launch_eob<0>(ei, ac_si, kept, N, R, L, bh, st);
}
