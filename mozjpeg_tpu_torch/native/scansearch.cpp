// Whole-image jpegrescan scan search in one native call.
//
// The Python orchestration of the search (codec/scanopt.py) costs ~0.4 ms
// of interpreter time per candidate — ~28 ms per image across the 64-scan
// script — and holds the GIL, so batched encodes stopped scaling across
// host threads. This runs the complete search — candidate gather, optimal
// table generation, emission, the greedy selection state machine with its
// skip-ahead early exits, and the display-order stitch — as one
// GIL-releasing call, reusing the byte-exact encoders in entropy.cpp.
//
// The candidates are coded by a set of worker threads (Workers) that every
// search in flight shares. Each search keeps its own selection and offers
// the workers the one candidate it needs next; a worker takes the next
// such candidate of any search, oldest search first. Only a worker that
// finds none codes ahead, from the restart-free search with the most
// selection left: the next candidate its selection will read whatever the
// early exits decide, or where no search has one, the next it may read.
// A candidate's bytes depend only on its scan and the image's planes, so
// the order of coding changes no output; with restart intervals the DRI
// markers follow the coding order, so such a search is coded in selection
// order alone.
//
// Semantics mirror /root/reference/jcmaster.c:773-962 (select_scans),
// jcparam.c:734-852 (jpeg_search_progression) and are kept in lockstep
// with codec/scanopt.py (tests/test_scansearch_native.py pins parity).

#include <algorithm>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

struct CompPlane {
  const int16_t* coef;
  int32_t bw, bh, stride;
  int32_t h, v;
  int32_t dc_tbl, ac_tbl;
};

extern "C" {
long mj_encode_dc_first(const CompPlane*, int, int, int, int, int,
                        const uint32_t*, const uint8_t*, uint8_t*, long,
                        int64_t*, int);
long mj_encode_ac_first(const CompPlane*, int, int, int, int,
                        const uint32_t*, const uint8_t*, uint8_t*, long,
                        int64_t*, int, int64_t*);
long mj_encode_ac_refine(const CompPlane*, int, int, int, int,
                         const uint32_t*, const uint8_t*, uint8_t*, long,
                         int64_t*, int, int64_t*);
long mj_gen_optimal_table(int64_t*, uint8_t*, uint8_t*);
}

namespace {

struct SScan {
  int comps[3];
  int nc;
  int Ss, Se, Ah, Al;
};

constexpr int FREQ_SPLITS[5] = {2, 8, 5, 12, 18};
constexpr int AL_MAX_LUMA = 3;
constexpr int AL_MAX_CHROMA = 2;

static int build_script(int ncomps, int dc_mode, SScan* s) {
  // mirrors codec/scans.py search_progression
  int n = 0;
  auto one = [&](int ci, int Ss, int Se, int Ah, int Al) {
    s[n].comps[0] = ci; s[n].nc = 1;
    s[n].Ss = Ss; s[n].Se = Se; s[n].Ah = Ah; s[n].Al = Al; n++;
  };
  if (dc_mode == 0) {
    for (int i = 0; i < ncomps; i++) s[n].comps[i] = i;
    s[n].nc = ncomps; s[n].Ss = 0; s[n].Se = 0; s[n].Ah = 0; s[n].Al = 0;
    n++;
  } else {
    one(0, 0, 0, 0, 0);
  }
  one(0, 1, 8, 0, 0); one(0, 9, 63, 0, 0);
  for (int Al = 0; Al < AL_MAX_LUMA; Al++) {
    one(0, 1, 63, Al + 1, Al);
    one(0, 1, 8, 0, Al + 1); one(0, 9, 63, 0, Al + 1);
  }
  one(0, 1, 63, 0, 0);
  for (int f : FREQ_SPLITS) { one(0, 1, f, 0, 0); one(0, f + 1, 63, 0, 0); }
  if (ncomps == 3) {
    s[n].comps[0] = 1; s[n].comps[1] = 2; s[n].nc = 2;
    s[n].Ss = 0; s[n].Se = 0; s[n].Ah = 0; s[n].Al = 0; n++;
    one(1, 0, 0, 0, 0); one(2, 0, 0, 0, 0);
    one(1, 1, 8, 0, 0); one(1, 9, 63, 0, 0);
    one(2, 1, 8, 0, 0); one(2, 9, 63, 0, 0);
    for (int Al = 0; Al < AL_MAX_CHROMA; Al++) {
      one(1, 1, 63, Al + 1, Al); one(2, 1, 63, Al + 1, Al);
      one(1, 1, 8, 0, Al + 1); one(1, 9, 63, 0, Al + 1);
      one(2, 1, 8, 0, Al + 1); one(2, 9, 63, 0, Al + 1);
    }
    one(1, 1, 63, 0, 0); one(2, 1, 63, 0, 0);
    for (int f : FREQ_SPLITS) {
      one(1, 1, f, 0, 0); one(1, f + 1, 63, 0, 0);
      one(2, 1, f, 0, 0); one(2, f + 1, 63, 0, 0);
    }
  }
  return n;
}

// canonical codes from a (bits, vals) table (jpeg_make_c_derived_tbl)
static void derive_codes(const uint8_t bits[17], const uint8_t* vals,
                         uint32_t* co, uint8_t* si) {
  memset(co, 0, 256 * sizeof(uint32_t));
  memset(si, 0, 256);
  uint32_t code = 0;
  int k = 0;
  for (int l = 1; l <= 16; l++) {
    for (int i = 0; i < bits[l]; i++) {
      int sym = vals[k++];
      co[sym] = code++;
      si[sym] = (uint8_t)l;
    }
    code <<= 1;
  }
}

// the clock of the search's counters
static inline int64_t now_ns() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

struct HuffSpec {
  uint8_t bits[17];
  uint8_t vals[256];
  int nvals;
  bool present = false;
};

}  // namespace

struct SearchComp {
  const int16_t* coef;
  int32_t bw, bh, bw_pad, bh_pad, stride;
  int32_t h, v;
};

// stats: null, or SEARCH_STATS int64 counters the search fills in:
// [0] the candidates whose size the selection read, and ns spent in
// [1] the gather passes, [2] building the optimal tables, [3] the
// emission passes with each candidate's DHT/DRI/SOS buffer, [4] ordering
// and stitching the winners; [5] the candidates coded ahead of the
// selection and [6] those of them it never read; [7] the blocks the AC
// candidates' gather and emission passes walked and [8] those of them
// whose band was all zero after the point transform. Times and blocks
// are summed over every candidate coded, on whichever worker coded it.
// With a null pointer no clock is read and no block counted.
enum { ST_CANDIDATES, ST_GATHER, ST_TABLES, ST_EMIT, ST_STITCH, ST_AHEAD,
       ST_AHEAD_UNUSED, ST_BLOCKS, ST_ZERO_BLOCKS, SEARCH_STATS };

namespace {

// One image's search: its planes, each candidate's buffer, and the greedy
// selection (scanopt._run_selection, transcribed) as a state machine that
// moves on as the sizes it reads come in. The Workers' mutex guards every
// field but the inputs and a candidate's buffer, which only the worker
// coding it touches until it reports the candidate done.
struct Search {
  const SearchComp* comps;
  int ncomps, mcus_x, mcus_y;
  const int32_t* restarts;
  SScan script[64];
  // layout constants (codec/scanopt.py SearchLayout)
  int num_scans_luma, num_scans_chroma_dc, luma_split_start,
      chroma_split_start, num_scans;
  long ent_cap;
  bool timed;
  bool ahead_ok;     // restart-free: candidates may be coded in any order

  std::vector<uint8_t> bufs[64];
  long sizes[64] = {0};
  SScan used[64];
  bool coding[64] = {}, done[64] = {}, read[64] = {}, ahead[64] = {};
  int last_dri = 0;
  int inflight = 0;  // candidates on workers
  bool failed = false;
  int64_t counts[SEARCH_STATS] = {0};
  std::condition_variable finished;

  // the selection: sn is the candidate it reads next
  int sn = 0;
  int best_Al_luma = 0, best_Al_chroma = 0;
  long best_cost = 0;
  int best_split_luma = 0, best_split_chroma = 0;
  bool interleave_chroma_dc = false;

  Search(const SearchComp* comps_, int ncomps_, int mcus_x_, int mcus_y_,
         int dc_mode, const int32_t* restarts_, bool timed_)
      : comps(comps_), ncomps(ncomps_), mcus_x(mcus_x_), mcus_y(mcus_y_),
        restarts(restarts_), timed(timed_) {
    build_script(ncomps, dc_mode, script);
    num_scans_luma = 1 + (3 * AL_MAX_LUMA + 2) + (2 * 5 + 1);       // 23
    num_scans_chroma_dc = ncomps == 3 ? 3 : 0;
    luma_split_start = 1 + 3 * AL_MAX_LUMA + 2;                     // 12
    chroma_split_start =
        num_scans_luma + num_scans_chroma_dc + (6 * AL_MAX_CHROMA + 4);  // 42
    num_scans = ncomps == 1 ? num_scans_luma : 64;
    long total_pad_blocks = 0;
    for (int ci = 0; ci < ncomps; ci++)
      total_pad_blocks += (long)comps[ci].bw_pad * comps[ci].bh_pad;
    ent_cap = total_pad_blocks * 192 + 65536;
    ahead_ok = true;
    for (int i = 0; i < num_scans; i++) ahead_ok &= restarts[i] == 0;
  }

  bool over() const { return failed || sn >= num_scans; }

  // the scan candidate i is coded with: frequency splits take the
  // winning Al, final once the selection has passed its ladder
  SScan scan(int i) const {
    SScan sc = script[i];
    if (i >= luma_split_start && i < num_scans_luma) sc.Al = best_Al_luma;
    else if (ncomps == 3 && i >= chroma_split_start) sc.Al = best_Al_chroma;
    return sc;
  }

  // whether the selection reads candidate i (past sn) whatever the sizes
  // it reads first: an early exit skips the rest of a ladder or of the
  // splits, so a candidate behind an exit point is certain only once
  // the selection has passed that point
  bool certain(int i) const {
    const int chroma_al2 = num_scans_luma + num_scans_chroma_dc + 10;
    int first;  // the first candidate after the last exit point before i
    if (i < luma_split_start)
      first = i < 6 ? 0 : 3 * (i / 3);
    else if (i < num_scans_luma)
      first = i < luma_split_start + 5 ? 0
          : luma_split_start + 2 * ((i - luma_split_start + 1) / 2) - 1;
    else if (i < chroma_split_start)
      first = i < chroma_al2 ? 0 : chroma_al2;
    else
      first = i < chroma_split_start + 10 ? 0
          : chroma_split_start + 4 * ((i - chroma_split_start - 2) / 4) + 2;
    return sn >= first;
  }

  // the nearest candidate past sn that the selection may still read (or,
  // with only_certain, will read) and whose scan is known, not coded or
  // being coded, or -1
  int next_ahead(bool only_certain) const {
    for (int i = sn + 1; i < num_scans; i++) {
      if (done[i] || coding[i] || (only_certain && !certain(i))) continue;
      if (i < luma_split_start
          || (i < num_scans_luma && sn >= luma_split_start)
          || (i >= num_scans_luma && i < chroma_split_start)
          || (i >= chroma_split_start && sn >= chroma_split_start))
        return i;
    }
    return -1;
  }

  long code(int sn, const SScan& sc, std::vector<uint8_t>& ent,
            int64_t t[5]);
  void select();
};

// Codes candidate sn into bufs[sn] (DHT + [DRI] + SOS + entropy data, the
// _scan_buffer layout) with the scratch `ent` -> the buffer's size, or -1;
// when timed, t gets the ns of the gather, the tables and the emission,
// then the blocks the AC passes walked and those with an empty band.
long Search::code(int sn, const SScan& sc, std::vector<uint8_t>& ent,
                  int64_t t[5]) {
  const int r = restarts[sn];
  CompPlane cp[3];
  int smx, smy;
  if (sc.nc == 1) {
    const SearchComp& g = comps[sc.comps[0]];
    int slot = sc.comps[0] == 0 ? 0 : 1;
    cp[0] = {g.coef, g.bw, g.bh, g.stride, 1, 1, slot, slot};
    smx = g.bw; smy = g.bh;
  } else {
    for (int i = 0; i < sc.nc; i++) {
      const SearchComp& g = comps[sc.comps[i]];
      int slot = sc.comps[i] == 0 ? 0 : 1;
      cp[i] = {g.coef, g.bw_pad, g.bh_pad, g.stride, g.h, g.v,
               slot, slot};
    }
    smx = mcus_x; smy = mcus_y;
  }

  // gather
  const int64_t t_gather = timed ? now_ns() : 0;
  int64_t dcc[2 * 257]; memset(dcc, 0, sizeof(dcc));
  int64_t acc[2 * 257]; memset(acc, 0, sizeof(acc));
  const bool is_dc = sc.Ss == 0;
  const bool refine = sc.Ah != 0;
  int64_t* walked = timed ? t + 3 : nullptr;
  long rc = 0;
  if (is_dc && !refine) {
    rc = mj_encode_dc_first(cp, sc.nc, smx, smy, r, sc.Al, nullptr,
                            nullptr, ent.data(), ent_cap, dcc, 1);
  } else if (!is_dc && !refine) {
    rc = mj_encode_ac_first(cp, sc.Ss, sc.Se, sc.Al, r, nullptr, nullptr,
                            ent.data(), ent_cap, acc, 1, walked);
  } else if (!is_dc) {
    rc = mj_encode_ac_refine(cp, sc.Ss, sc.Se, sc.Al, r, nullptr, nullptr,
                             ent.data(), ent_cap, acc, 1, walked);
  }
  if (rc < 0) return -1;

  // optimal tables per used slot
  const int64_t t_tables = timed ? now_ns() : 0;
  HuffSpec dct[2], act[2];
  uint32_t dc_co[2 * 256]; uint8_t dc_si[2 * 256];
  uint32_t ac_co[2 * 256]; uint8_t ac_si[2 * 256];
  memset(dc_si, 0, sizeof(dc_si)); memset(ac_si, 0, sizeof(ac_si));
  memset(dc_co, 0, sizeof(dc_co)); memset(ac_co, 0, sizeof(ac_co));
  for (int i = 0; i < sc.nc; i++) {
    int slot = sc.comps[i] == 0 ? 0 : 1;
    if (is_dc && !refine && !dct[slot].present) {
      bool any = false;
      for (int s2 = 0; s2 < 257; s2++) any |= dcc[slot * 257 + s2] != 0;
      if (any) {
        int64_t f[257]; memcpy(f, dcc + slot * 257, sizeof(f));
        long nv = mj_gen_optimal_table(f, dct[slot].bits, dct[slot].vals);
        if (nv < 0) return -1;
        dct[slot].nvals = (int)nv;
        dct[slot].present = true;
        derive_codes(dct[slot].bits, dct[slot].vals,
                     dc_co + slot * 256, dc_si + slot * 256);
      }
    }
    if (!is_dc && !act[slot].present) {
      bool any = false;
      for (int s2 = 0; s2 < 257; s2++) any |= acc[slot * 257 + s2] != 0;
      if (any) {
        int64_t f[257]; memcpy(f, acc + slot * 257, sizeof(f));
        long nv = mj_gen_optimal_table(f, act[slot].bits, act[slot].vals);
        if (nv < 0) return -1;
        act[slot].nvals = (int)nv;
        act[slot].present = true;
        derive_codes(act[slot].bits, act[slot].vals,
                     ac_co + slot * 256, ac_si + slot * 256);
      }
    }
  }

  // emit entropy data
  const int64_t t_emit = timed ? now_ns() : 0;
  long n = 0;
  if (is_dc && !refine) {
    n = mj_encode_dc_first(cp, sc.nc, smx, smy, r, sc.Al, dc_co, dc_si,
                           ent.data(), ent_cap, nullptr, 0);
  } else if (!is_dc && !refine) {
    n = mj_encode_ac_first(cp, sc.Ss, sc.Se, sc.Al, r, ac_co, ac_si,
                           ent.data(), ent_cap, nullptr, 0, walked);
  } else if (!is_dc) {
    n = mj_encode_ac_refine(cp, sc.Ss, sc.Se, sc.Al, r, ac_co, ac_si,
                            ent.data(), ent_cap, nullptr, 0, walked);
  }
  if (n < 0) return -1;

  // candidate buffer: DHT (+DRI) + SOS + entropy (_scan_buffer layout)
  std::vector<uint8_t>& b = bufs[sn];
  b.clear();
  auto byte = [&](int v) { b.push_back((uint8_t)v); };
  // DHT: one marker holding the scan's tables (dht_multi; always
  // emitted, possibly with empty payload — jcmarker emit_multi_dht)
  {
    std::vector<uint8_t> payload;
    auto table = [&](int cls, int slot, const HuffSpec& t) {
      payload.push_back((uint8_t)((cls << 4) | slot));
      for (int l = 1; l <= 16; l++) payload.push_back(t.bits[l]);
      payload.insert(payload.end(), t.vals, t.vals + t.nvals);
    };
    bool seen_d[2] = {false, false}, seen_a[2] = {false, false};
    for (int i = 0; i < sc.nc; i++) {
      int slot = sc.comps[i] == 0 ? 0 : 1;
      if (is_dc && !refine && dct[slot].present && !seen_d[slot]) {
        table(0, slot, dct[slot]); seen_d[slot] = true;
      }
      if (!is_dc && act[slot].present && !seen_a[slot]) {
        table(1, slot, act[slot]); seen_a[slot] = true;
      }
    }
    byte(0xFF); byte(0xC4);
    int len = (int)payload.size() + 2;
    byte(len >> 8); byte(len & 0xFF);
    b.insert(b.end(), payload.begin(), payload.end());
  }
  // last_dri follows the coding order, which is the selection's order
  // wherever a restart interval is set (ahead_ok)
  if (r != last_dri) {
    byte(0xFF); byte(0xDD); byte(0); byte(4);
    byte(r >> 8); byte(r & 0xFF);
    last_dri = r;
  }
  // SOS
  byte(0xFF); byte(0xDA);
  int slen = 2 + 1 + 2 * sc.nc + 3;   // len field + Ns + comps + Ss/Se/A
  byte(slen >> 8); byte(slen & 0xFF);
  byte(sc.nc);
  for (int i = 0; i < sc.nc; i++) {
    int slot = sc.comps[i] == 0 ? 0 : 1;
    byte(sc.comps[i] + 1);
    int td = (is_dc && !refine) ? slot : 0;
    int ta = sc.Se ? slot : 0;
    byte((td << 4) | ta);
  }
  byte(sc.Ss); byte(sc.Se); byte((sc.Ah << 4) | sc.Al);
  b.insert(b.end(), ent.data(), ent.data() + n);
  used[sn] = sc;
  if (timed) {
    t[0] = t_tables - t_gather;
    t[1] = t_emit - t_tables;
    t[2] = now_ns() - t_emit;
  }
  return (long)b.size();
}

// Reads sizes[sn] and moves sn to the next candidate to read, early
// exits included (the body of scanopt._run_selection's loop).
void Search::select() {
  read[sn] = true;
  counts[ST_CANDIDATES]++;
  int nxt = sn + 1;
  if (1 < nxt && nxt <= luma_split_start) {
    if ((nxt - 1) % 3 == 2) {
      int Al = (nxt - 1) / 3;
      long cost = sizes[nxt - 2] + sizes[nxt - 1];
      for (int i = 0; i < Al; i++) cost += sizes[3 + 3 * i];
      if (Al == 0 || cost < best_cost) {
        best_cost = cost; best_Al_luma = Al;
      } else {
        sn = luma_split_start - 1;
      }
    }
  } else if (luma_split_start < nxt && nxt <= num_scans_luma) {
    if (nxt == luma_split_start + 1) {
      best_split_luma = 0;
      best_cost = sizes[nxt - 1];
    } else if ((nxt - luma_split_start) % 2 == 1) {
      int idx = (nxt - luma_split_start) >> 1;
      long cost = sizes[nxt - 2] + sizes[nxt - 1];
      if (cost < best_cost) { best_cost = cost; best_split_luma = idx; }
      if ((idx == 2 && best_split_luma == 0)
          || (idx == 3 && best_split_luma != 2)
          || (idx == 4 && best_split_luma != 4))
        sn = num_scans_luma - 1;
    }
  } else if (num_scans > num_scans_luma) {
    int base = num_scans_luma;
    if (nxt == num_scans_luma + num_scans_chroma_dc) {
      interleave_chroma_dc =
          sizes[base] <= sizes[base + 1] + sizes[base + 2];
    } else if (num_scans_luma + num_scans_chroma_dc < nxt
               && nxt <= chroma_split_start) {
      base = num_scans_luma + num_scans_chroma_dc;
      if ((nxt - base) % 6 == 4) {
        int Al = (nxt - base) / 6;
        long cost = sizes[nxt - 4] + sizes[nxt - 3] + sizes[nxt - 2]
            + sizes[nxt - 1];
        for (int i = 0; i < Al; i++)
          cost += sizes[base + 4 + 6 * i] + sizes[base + 5 + 6 * i];
        if (Al == 0 || cost < best_cost) {
          best_cost = cost; best_Al_chroma = Al;
        } else {
          sn = chroma_split_start - 1;
        }
      }
    } else if (chroma_split_start < nxt && nxt <= num_scans) {
      if (nxt == chroma_split_start + 2) {
        best_split_chroma = 0;
        best_cost = sizes[nxt - 2] + sizes[nxt - 1];
      } else if ((nxt - chroma_split_start) % 4 == 2) {
        int idx = (nxt - chroma_split_start) >> 2;
        long cost = sizes[nxt - 4] + sizes[nxt - 3] + sizes[nxt - 2]
            + sizes[nxt - 1];
        if (cost < best_cost) { best_cost = cost; best_split_chroma = idx; }
        if ((idx == 2 && best_split_chroma == 0)
            || (idx == 3 && best_split_chroma != 2)
            || (idx == 4 && best_split_chroma != 4))
          sn = num_scans - 1;
      }
    }
  }
  sn++;
}

// The worker threads that code the candidates of every search in flight.
// Each keeps its scratch buffer from one candidate to the next.
struct Workers {
  std::mutex mu;
  std::condition_variable work;   // a candidate may be free to take
  std::vector<Search*> searches;  // in flight, oldest first
  std::vector<std::thread> threads;
  bool stopping = false;

  explicit Workers(int n) {
    for (int t = 0; t < n; t++) threads.emplace_back([this] { run(); });
  }

  ~Workers() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stopping = true;
    }
    work.notify_all();
    for (auto& t : threads) t.join();
  }

  // under mu: the candidate a worker codes next -> (search, index), or
  // a null search. First the one a selection needs, oldest search first;
  // else one ahead, from the restart-free search with the most selection
  // left: one its selection will read if any search has such, else one
  // it may read.
  Search* take(int& i) {
    for (Search* s : searches)
      if (!s->coding[s->sn]) { i = s->sn; return s; }
    Search* best = nullptr;
    for (bool only_certain : {true, false}) {
      for (Search* s : searches) {
        if (!s->ahead_ok) continue;
        const int j = s->next_ahead(only_certain);
        if (j >= 0 && (!best || s->num_scans - s->sn
                                    > best->num_scans - best->sn)) {
          best = s; i = j;
        }
      }
      if (best) {
        best->ahead[i] = true;
        best->counts[ST_AHEAD]++;
        return best;
      }
    }
    return nullptr;
  }

  // under mu: moves s's selection over the sizes in hand; a search that
  // is over leaves the list
  void advance(Search& s) {
    while (!s.over() && s.done[s.sn]) s.select();
    if (s.over()) {
      auto it = std::find(searches.begin(), searches.end(), &s);
      if (it != searches.end()) searches.erase(it);
    }
  }

  void run() {
    std::vector<uint8_t> ent;
    std::unique_lock<std::mutex> lk(mu);
    for (;;) {
      int i = 0;
      Search* s = nullptr;
      while (!stopping && !(s = take(i))) work.wait(lk);
      if (stopping) return;
      s->coding[i] = true;
      s->inflight++;
      const SScan sc = s->scan(i);
      lk.unlock();
      if ((long)ent.size() < s->ent_cap) ent.resize(s->ent_cap);
      int64_t t[5] = {0, 0, 0, 0, 0};
      const long sz = s->code(i, sc, ent, t);
      lk.lock();
      s->coding[i] = false;
      s->inflight--;
      if (sz < 0) {
        s->failed = true;
      } else {
        s->sizes[i] = sz;
        s->done[i] = true;
      }
      for (int k = 0; k < 3; k++) s->counts[ST_GATHER + k] += t[k];
      s->counts[ST_BLOCKS] += t[3];
      s->counts[ST_ZERO_BLOCKS] += t[4];
      advance(*s);
      if (s->over() && s->inflight == 0) s->finished.notify_all();
      work.notify_all();
    }
  }

  // runs s's selection on the workers; the calling thread waits -> 0, or
  // -1 if a candidate failed
  int search(Search& s) {
    std::unique_lock<std::mutex> lk(mu);
    searches.push_back(&s);
    work.notify_all();
    s.finished.wait(lk, [&] { return s.over() && s.inflight == 0; });
    for (int i = 0; i < s.num_scans; i++)
      s.counts[ST_AHEAD_UNUSED] += s.ahead[i] && !s.read[i];
    return s.failed ? -1 : 0;
  }
};

}  // namespace

// A set of n worker threads for mj_scan_search; free it with no search
// in flight.
extern "C" void* mj_search_workers_new(int n) {
  return n > 0 ? new Workers(n) : nullptr;
}

extern "C" void mj_search_workers_free(void* workers) {
  delete static_cast<Workers*>(workers);
}

extern "C" long mj_scan_search(
    const SearchComp* comps, int ncomps, int mcus_x, int mcus_y,
    int dc_mode, const int32_t* restarts,
    uint8_t* out, long out_cap, int32_t* meta, void* workers,
    int64_t* stats) {
  Search s(comps, ncomps, mcus_x, mcus_y, dc_mode, restarts,
           stats != nullptr);
  if (static_cast<Workers*>(workers)->search(s) < 0) return -1;
  const int num_scans_luma = s.num_scans_luma;
  const int num_scans_chroma_dc = s.num_scans_chroma_dc;
  const int luma_split_start = s.luma_split_start;
  const int chroma_split_start = s.chroma_split_start;
  const int best_Al_luma = s.best_Al_luma, best_Al_chroma = s.best_Al_chroma;
  const int best_split_luma = s.best_split_luma;
  const int best_split_chroma = s.best_split_chroma;

  // ---- display order (scanopt.display_order, transcribed) ----
  const int64_t t_stitch = s.timed ? now_ns() : 0;
  int order[40]; int nord = 0;
  int min_Al = best_Al_luma < best_Al_chroma ? best_Al_luma : best_Al_chroma;
  order[nord++] = 0;
  if (ncomps == 3 && dc_mode != 0) {
    int base = num_scans_luma;
    if (s.interleave_chroma_dc && dc_mode != 1) order[nord++] = base;
    else { order[nord++] = base + 1; order[nord++] = base + 2; }
  }
  if (best_split_luma == 0) order[nord++] = luma_split_start;
  else {
    order[nord++] = luma_split_start + 2 * (best_split_luma - 1) + 1;
    order[nord++] = luma_split_start + 2 * (best_split_luma - 1) + 2;
  }
  for (int Al = best_Al_luma - 1; Al >= min_Al; Al--)
    order[nord++] = 3 + 3 * Al;
  if (ncomps == 3) {
    if (best_split_chroma == 0) {
      order[nord++] = chroma_split_start;
      order[nord++] = chroma_split_start + 1;
    } else {
      int b0 = chroma_split_start + 4 * (best_split_chroma - 1);
      order[nord++] = b0 + 2; order[nord++] = b0 + 3;
      order[nord++] = b0 + 4; order[nord++] = b0 + 5;
    }
    int cbase = num_scans_luma + num_scans_chroma_dc;
    for (int Al = best_Al_chroma - 1; Al >= min_Al; Al--) {
      order[nord++] = cbase + 6 * Al + 4;
      order[nord++] = cbase + 6 * Al + 5;
    }
  }
  for (int Al = min_Al - 1; Al >= 0; Al--) {
    order[nord++] = 3 + 3 * Al;
    if (ncomps == 3) {
      int cbase = num_scans_luma + num_scans_chroma_dc;
      order[nord++] = cbase + 6 * Al + 4;
      order[nord++] = cbase + 6 * Al + 5;
    }
  }

  // ---- copy winners ----
  long off = 0;
  int m = 0;
  meta[m++] = nord;
  for (int i = 0; i < nord; i++) {
    int idx = order[i];
    const std::vector<uint8_t>& b = s.bufs[idx];
    if (off + (long)b.size() > out_cap) return -1;
    memcpy(out + off, b.data(), b.size());
    const SScan& sc = s.used[idx];
    meta[m++] = idx;
    meta[m++] = sc.nc;
    meta[m++] = sc.comps[0];
    meta[m++] = sc.Ss; meta[m++] = sc.Se;
    meta[m++] = sc.Ah; meta[m++] = sc.Al;
    meta[m++] = (int32_t)b.size();
    off += (long)b.size();
  }
  if (s.timed) {
    s.counts[ST_STITCH] = now_ns() - t_stitch;
    for (int k = 0; k < SEARCH_STATS; k++) stats[k] = s.counts[k];
  }
  return off;
}
