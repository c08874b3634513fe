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
// chain short. One warp a table; each lane holds 9 of the 257 entries
// as keys in registers, count << 9 | (511 - symbol), so that the least
// key is the least count and, among equal counts, the LAST symbol (the
// reference's ascending <= scan). A merge step is two warp minima by
// redux.sync: c1 over the lanes' least keys, then c2 over the same
// with c1's lane offering its second least. Only the lanes that own c1
// (its count becomes v1 + v2) and c2 (now dead) see their keys change,
// so every other lane's two least stay valid; the lanes recompute them
// in lockstep, the least as a depth-4 min tree before the next step's
// first minimum, the second least while that minimum is in flight.
// Each entry's code size follows its root's symbol (a merged root keeps
// c1's), a relabel that the next step's minima do not wait for.
//
// The key is chosen once a table. When its live counts sum below 2^23,
// one 32-bit word: merged counts never pass the sum, and while two
// roots live each is below it, so no live key reaches the dead key
// 0xffffffff and one __reduce_min_sync gives c1 with its tie broken.
// Otherwise a 64-bit key whose minimum is taken in two stages (the
// counts, then 511 - symbol among the lanes on that count). Above that,
// the reference's int32 semantics hold: counts of 2^30 (BIG) or more
// are not live, and a merge that reaches BIG leaves no live root.
//
// After the merges the value order comes from counting ranks: a
// present symbol's rank is the number of present symbols of smaller
// code size (an exclusive prefix over the size histogram) plus those of
// its size and smaller symbol (one __match_any_sync and __popc per
// round of 32 symbols); the absent ones follow in symbol order. The
// length limiting (a short serial loop on 33 counts) runs on lane 0.
//
// TG_WARPS, the tables a block, is the launch shape that
// scripts/torch_tablegen_ab.py measures against one warp a block.
#include <cstdint>

#include <cuda_runtime.h>

#ifndef TG_WARPS
#define TG_WARPS 4
#endif

namespace {

constexpr int kSym = 257;           // 256 symbols + the pseudo-symbol
constexpr int kSlots = 9;           // ceil(257 / 32) symbols a lane
constexpr unsigned kBig = 1u << 30;
constexpr unsigned kPackedBelow = 1u << 23;
constexpr int kWarps = TG_WARPS;    // tables per block
constexpr unsigned kFull = 0xffffffffu;

// The two key widths. make(count, symbol); warp_min gives every lane the
// least key of the warp.
template <typename K>
struct Key;

template <>
struct Key<uint32_t> {
  static constexpr uint32_t kDead = 0xffffffffu;
  __device__ static uint32_t make(unsigned c, int s) {
    return c << 9 | static_cast<unsigned>(511 - s);
  }
  __device__ static uint32_t warp_min(uint32_t k) {
    return __reduce_min_sync(kFull, k);
  }
};

template <>
struct Key<unsigned long long> {
  static constexpr unsigned long long kDead = ~0ull;
  __device__ static unsigned long long make(unsigned c, int s) {
    return static_cast<unsigned long long>(c) << 9
           | static_cast<unsigned>(511 - s);
  }
  __device__ static unsigned long long warp_min(unsigned long long k) {
    const unsigned c = static_cast<unsigned>(k >> 9);  // dead: 0xffffffff
    const unsigned m = __reduce_min_sync(kFull, c);
    const unsigned t = __reduce_min_sync(
        kFull, c == m ? static_cast<unsigned>(k & 511) : 511u);
    return static_cast<unsigned long long>(m) << 9 | t;
  }
};

template <typename K>
__device__ __forceinline__ K lo(K a, K b) {
  return a < b ? a : b;
}

// The least of a lane's keys, a tree of depth 4.
template <typename K>
__device__ __forceinline__ K least(const K (&x)[kSlots]) {
  return lo(lo(lo(x[0], x[1]), lo(x[2], x[3])),
            lo(lo(x[4], x[5]), lo(lo(x[6], x[7]), x[8])));
}

// The least of a lane's keys but b1, its least (live keys are distinct).
template <typename K>
__device__ __forceinline__ K second(const K (&x)[kSlots], K b1) {
  K y[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) y[k] = x[k] == b1 ? Key<K>::kDead : x[k];
  return least(y);
}

// The Huffman merges of one table: each step joins the two least live
// roots. cnt: the lane's counts (live where `live`); cs: the code sizes
// (depths in the merge tree) it leaves.
template <typename K>
__device__ __forceinline__ void huffman_merges(
    const unsigned (&cnt)[kSlots], const bool (&live)[kSlots], int n_live,
    int lane, int (&cs)[kSlots]) {
  K key[kSlots];
  int grp[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int s = lane + 32 * k;
    key[k] = live[k] ? Key<K>::make(cnt[k], s) : Key<K>::kDead;
    grp[k] = s;
    cs[k] = 0;
  }
  K b1 = least(key);
  for (int it = 0; it < 256 && n_live >= 2; ++it) {
    const K m1 = Key<K>::warp_min(b1);
    const K b2 = second(key, b1);     // in the shadow of the minimum
    const int c1 = 511 - static_cast<int>(m1 & 511);
    const K m2 = Key<K>::warp_min(lane == (c1 & 31) ? b2 : b1);
    const int c2 = 511 - static_cast<int>(m2 & 511);
    const unsigned v = static_cast<unsigned>(m1 >> 9)
                       + static_cast<unsigned>(m2 >> 9);
    const bool gone = v >= kBig;    // the merged root is not live
    const K merged = gone ? Key<K>::kDead : Key<K>::make(v, c1);
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int s = lane + 32 * k;
      if (s == c1) key[k] = merged;
      if (s == c2) key[k] = Key<K>::kDead;
    }
    b1 = least(key);
    // off the chain: every member of the two roots goes one level down
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const bool in1 = grp[k] == c1, in2 = grp[k] == c2;
      cs[k] += in1 | in2;
      grp[k] = in2 ? c1 : grp[k];
    }
    n_live -= 1 + gone;
  }
}

__global__ void __launch_bounds__(32 * kWarps)
tablegen_kernel(const int32_t* __restrict__ freqs, int n_tables,
                int32_t* __restrict__ bits_out,
                int32_t* __restrict__ vals_out,
                uint8_t* __restrict__ ok_out,
                int32_t* __restrict__ si_out) {
  __shared__ int s_hist[kWarps][kSym];
  __shared__ int s_vals[kWarps][256];
  __shared__ int s_si[kWarps][256];
  __shared__ int s_bits[kWarps][33];

  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarps + w;
  if (t >= n_tables) return;        // whole warps leave together
  const int32_t* f = freqs + static_cast<long long>(t) * kSym;

  // present: a count above 0 (the pseudo-symbol always); live: present
  // and below BIG, as the reference's fw < BIG
  unsigned cnt[kSlots];
  bool pres[kSlots], live[kSlots];
  int n_present = 0, n_live = 0;
  unsigned long long sum = 0;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int s = lane + 32 * k;
    const int v = s >= kSym ? 0 : (s == 256 ? 1 : f[s]);
    pres[k] = v > 0;
    live[k] = pres[k] && static_cast<unsigned>(v) < kBig;
    cnt[k] = live[k] ? static_cast<unsigned>(v) : 0u;
    n_present += pres[k];
    n_live += live[k];
    sum += cnt[k];
  }
  n_present = static_cast<int>(__reduce_add_sync(kFull, n_present));
  n_live = static_cast<int>(__reduce_add_sync(kFull, n_live));
  // the live sum, each lane's capped at 2^23 so that the warp's cannot
  // wrap; below 2^23 the 32-bit keys
  const unsigned total = __reduce_add_sync(
      kFull, static_cast<unsigned>(sum < kPackedBelow ? sum : kPackedBelow));

  int cs[kSlots];
  if (total < kPackedBelow)
    huffman_merges<uint32_t>(cnt, live, n_live, lane, cs);
  else
    huffman_merges<unsigned long long>(cnt, live, n_live, lane, cs);

  // the code-size histogram, and each symbol's place: among the present
  // symbols of its size, or among the absent ones, in symbol order
  int* const hist = s_hist[w];
  for (int l = lane; l < kSym; l += 32) hist[l] = 0;
  __syncwarp();
  const unsigned below_me = (1u << lane) - 1;
  int pos[kSlots];
  int absent_before = 0;
  bool too_long = false;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int s = lane + 32 * k;
    const bool p = pres[k];
    const unsigned same = __match_any_sync(kFull, p ? cs[k] : -1);
    const int seen = p ? hist[cs[k]] : 0;
    __syncwarp();
    if (p && (same & below_me) == 0) hist[cs[k]] = seen + __popc(same);
    __syncwarp();
    const unsigned absent = __ballot_sync(kFull, s < kSym && !p);
    pos[k] = p ? seen + __popc(same & below_me)
               : absent_before + __popc(absent & below_me);
    absent_before += __popc(absent);
    too_long |= p && cs[k] > 32;
  }
  const bool ok = n_present >= 2 && !__any_sync(kFull, too_long);

  // the length counts (sizes past 32 counted at 32, where ok is false)
  // and, in place, the histogram's exclusive prefix; lane l owns the
  // bins 9l .. 9l + 8
  int h[kSlots];
  int own = 0, past32 = 0;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int b = kSlots * lane + j;
    h[j] = b < kSym ? hist[b] : 0;
    own += h[j];
    past32 += b >= 32 ? h[j] : 0;
  }
  int run = own;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, run, o);
    if (lane >= o) run += y;
  }
  run -= own;
  const int at32 = static_cast<int>(__reduce_add_sync(kFull, past32));
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int b = kSlots * lane + j;
    if (b <= 32) s_bits[w][b] = b < 32 ? h[j] : at32;
    if (b < kSym) hist[b] = run;
    run += h[j];
  }
  __syncwarp();

  // each symbol's rank; the first 256 ranks are the values
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int s = lane + 32 * k;
    if (s < kSym) {
      const int rank = pres[k] ? hist[cs[k]] + pos[k] : n_present + pos[k];
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
