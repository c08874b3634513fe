// Optimal Huffman tables (JPEG Annex K.2) for a batch of histograms.
//
// Replaces mozjpeg_tpu/ops/tablegen.py:30-115 (_gen_one and
// gen_optimal_tables_t), which is XLA code, not a pallas_call: a
// while_loop of up to 256 merge steps of about 12 ops each, then a
// length-limiting fori_loop of 16 x 129 steps. Run eagerly in PyTorch
// that is some 20,000 launches for one call; here it is one launch for
// every table of the call. Its plain twin is
// mozjpeg_tpu_torch/ops/tablegen.py gen_optimal_tables_plain.
//
// What bounds it: latency, not bytes or operations. One table is an
// integer-serial chain of up to 256 dependent merge steps over 257
// counts (about 1 KB in, 1.2 KB out), so the design keeps each step's
// latency short: one warp per table, each lane holding its 9 of the 257
// (count, group id, code size) triples in registers, every step two
// warp butterflies (the minimum, the last index among equal minima,
// first for c1 and then for c2 with c1 excluded) and a register update.
// The sort of the values (a rank by (code size, symbol) over shared
// memory) and the derived code lengths are warp-parallel; the length
// limiting (a short serial loop on 33 counts) runs on lane 0.
//
// Exactness: the same int32 arithmetic as the reference; BIG = 1 << 30
// marks absent and merged entries and merged counts stay int32 (two
// entries below BIG sum below 2^31); ties take the LAST index, as the
// reference's ascending <= scan leaves it.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kSym = 257;           // 256 symbols + the pseudo-symbol
constexpr int kSlots = 9;           // ceil(257 / 32) symbols a lane
constexpr int kBig = 1 << 30;
constexpr int kWarps = 4;           // tables per block
constexpr unsigned kFull = 0xffffffffu;

// Lexicographic warp reduction: the smaller value wins, and among equal
// values the larger index. Every lane ends with the result.
__device__ __forceinline__ void min_last(int& v, int& c) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int v2 = __shfl_xor_sync(kFull, v, o);
    const int c2 = __shfl_xor_sync(kFull, c, o);
    if (v2 < v || (v2 == v && c2 > c)) {
      v = v2;
      c = c2;
    }
  }
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Register slot k of the lane that holds symbol s, read by every lane.
__device__ __forceinline__ int read_slot(const int (&r)[kSlots], int s) {
  int mine = 0;
#pragma unroll
  for (int k = 0; k < kSlots; ++k)
    if (k == (s >> 5)) mine = r[k];
  return __shfl_sync(kFull, mine, s & 31);
}

__global__ void __launch_bounds__(32 * kWarps)
tablegen_kernel(const int32_t* __restrict__ freqs, int n_tables,
                int32_t* __restrict__ bits_out,
                int32_t* __restrict__ vals_out,
                uint8_t* __restrict__ ok_out,
                int32_t* __restrict__ si_out) {
  __shared__ int s_key[kWarps][kSym];
  __shared__ int s_vals[kWarps][256];
  __shared__ int s_si[kWarps][256];
  __shared__ int s_bits[kWarps][33];

  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarps + w;
  if (t >= n_tables) return;        // whole warps leave together
  const int32_t* f = freqs + static_cast<long long>(t) * kSym;

  int fw[kSlots], grp[kSlots], cs[kSlots];
  bool pres[kSlots];
  int n_present = 0;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int s = lane + 32 * k;
    const bool valid = s < kSym;
    const int v = !valid ? 0 : (s == 256 ? 1 : f[s]);
    pres[k] = valid && v > 0;
    fw[k] = !valid ? INT_MAX : (pres[k] ? v : kBig);
    grp[k] = valid ? s : -1;
    cs[k] = 0;
    n_present += pres[k];
  }
  n_present = warp_sum(n_present);

  // Huffman merges: each step joins the two least frequent live roots
  int live = n_present;
  for (int it = 0; it < 256 && live >= 2; ++it) {
    int v1 = INT_MAX, c1 = -1;
#pragma unroll
    for (int k = 0; k < kSlots; ++k)
      if (fw[k] < v1 || (fw[k] == v1 && fw[k] != INT_MAX)) {
        v1 = fw[k];
        c1 = lane + 32 * k;
      }
    min_last(v1, c1);
    int v2 = INT_MAX, c2 = -1;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int s = lane + 32 * k;
      const int x = s == c1 ? kBig : fw[k];
      if (x < v2 || (x == v2 && x != INT_MAX)) {
        v2 = x;
        c2 = s;
      }
    }
    min_last(v2, c2);
    const int g1 = read_slot(grp, c1);
    const int g2 = read_slot(grp, c2);
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int s = lane + 32 * k;
      if (grp[k] == g1 || grp[k] == g2) cs[k] += 1;
      if (grp[k] == g2) grp[k] = g1;
      if (s == c1) fw[k] = v1 + v2;
      if (s == c2) fw[k] = kBig;
    }
    live -= 1 + (v1 + v2 >= kBig ? 1 : 0);
  }

  // ok, the length histogram, and the keys of the value order: present
  // symbols by (code size, symbol), then the absent ones by symbol
  int too_long = 0;
  for (int l = lane; l < 33; l += 32) s_bits[w][l] = 0;
  __syncwarp();
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int s = lane + 32 * k;
    if (s < kSym) {
      s_key[w][s] = pres[k] ? cs[k] * 512 + s : (1 << 24) + s;
      if (pres[k]) {
        too_long |= cs[k] > 32;
        atomicAdd(&s_bits[w][min(max(cs[k], 0), 32)], 1);
      }
    }
  }
  const bool ok = n_present >= 2 && !__any_sync(kFull, too_long);
  __syncwarp();

  // each symbol's rank in that order; the first 256 ranks are the values
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int s = lane + 32 * k;
    if (s < kSym) {
      const int key = s_key[w][s];
      int rank = 0;
      for (int u = 0; u < kSym; ++u) rank += s_key[w][u] < key;
      if (rank < 256) s_vals[w][rank] = s == 256 ? 0 : s;
    }
  }

  if (lane == 0) {
    int* b = s_bits[w];
    b[0] = 0;
    // length limiting (jchuff.c:1053-1069), at most 129 steps a level
    for (int i = 32; i > 16; --i) {
      for (int step = 0; step < 129 && b[i] > 0; ++step) {
        int j = 0;
        for (int l = i - 2; l >= 0; --l)
          if (b[l] > 0) {
            j = l;
            break;
          }
        b[i] -= 2;
        b[i - 1] += 1;
        b[j + 1] += 2;
        b[j] -= 1;
      }
    }
    // the pseudo-symbol leaves the largest length <= 16 in use
    int last = 0;
    for (int l = 16; l >= 0; --l)
      if (b[l] > 0) {
        last = l;
        break;
      }
    if (ok) b[last] -= 1;
  }
  __syncwarp();

  if (lane < 17) bits_out[t * 17 + lane] = s_bits[w][lane];
  for (int p = lane; p < 256; p += 32) vals_out[t * 256 + p] = s_vals[w][p];
  if (lane == 0) ok_out[t] = ok ? 1 : 0;
  if (si_out == nullptr) return;

  // code lengths by symbol (derive_codes_t): rank p < nsym has the
  // smallest length l whose cumulative count passes p
  int cum[16];
  int acc = 0;
#pragma unroll
  for (int l = 0; l < 16; ++l) {
    acc += s_bits[w][l + 1];
    cum[l] = acc;
  }
  for (int p = lane; p < 256; p += 32) s_si[w][p] = 0;
  __syncwarp();
  for (int p = lane; p < 256; p += 32) {
    if (p < acc) {
      int len = 1;
#pragma unroll
      for (int l = 0; l < 16; ++l) len += p >= cum[l];
      atomicAdd(&s_si[w][min(max(s_vals[w][p], 0), 255)], len);
    }
  }
  __syncwarp();
  for (int p = lane; p < 256; p += 32) si_out[t * 256 + p] = s_si[w][p];
}

}  // namespace

// freqs (T, 257) int32 -> bits (T, 17) int32, vals (T, 256) int32,
// ok (T,) bytes, and, when si is not null, the code lengths by symbol
// (T, 256) int32. One launch on `stream`; returns the launch's CUDA error.
extern "C" int mj_tablegen(const int32_t* freqs, int n_tables,
                           int32_t* bits, int32_t* vals, uint8_t* ok,
                           int32_t* si, cudaStream_t stream) {
  const int blocks = (n_tables + kWarps - 1) / kWarps;
  tablegen_kernel<<<blocks, 32 * kWarps, 0, stream>>>(freqs, n_tables, bits,
                                                      vals, ok, si);
  return static_cast<int>(cudaGetLastError());
}
