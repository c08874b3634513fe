// Host-side JPEG entropy engine (encode + decode, sequential + progressive).
//
// Fresh array-oriented implementation of ITU-T T.81 Huffman entropy coding
// with mozjpeg/libjpeg-compatible behaviors (EOB-run accumulation, correction
// bit buffering, dummy-block conventions, byte stuffing, restart markers).
// Parity references (semantics only): /root/reference/jchuff.c,
// jcphuff.c, jdhuff.c, jdphuff.c.
//
// Design: the device (TPU) produces whole-image zigzag coefficient planes;
// these functions walk them in MCU order and emit/consume the bitstream.
// Everything is plain C ABI for ctypes.
//
// Build: g++ -O3 -shared -fPIC entropy.cpp -o libmjentropy.so

#include <atomic>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <thread>
#include <vector>
#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

// ---------------------------------------------------------------------------
// Bit writer with 0xFF stuffing
// ---------------------------------------------------------------------------
struct BitWriter {
  uint8_t* out;
  long cap;
  long pos;
  uint64_t acc;   // bits accumulate left-justified
  int nbits;
  bool overflow;

  void init(uint8_t* o, long c) {
    out = o; cap = c; pos = 0; acc = 0; nbits = 0; overflow = false;
  }
  inline void put_byte(uint8_t b) {
    if (pos >= cap) { overflow = true; return; }
    out[pos++] = b;
  }
  inline void put(uint32_t code, int size) {
    // size in [1,26]; code has its value in low `size` bits
    if (size <= 0) return;  // callers flag missing symbols themselves
    acc |= (uint64_t)(code & ((1u << size) - 1)) << (64 - nbits - size);
    nbits += size;
    while (nbits >= 8) {
      uint8_t b = (uint8_t)(acc >> 56);
      put_byte(b);
      if (b == 0xFF) put_byte(0x00);
      acc <<= 8;
      nbits -= 8;
    }
  }
  // Pad with 1-bits to byte boundary and flush (JPEG convention).
  void flush() {
    if (nbits > 0) {
      int pad = 8 - (nbits & 7);
      if (pad != 8) put(0x7F, pad);
      while (nbits >= 8) {
        uint8_t b = (uint8_t)(acc >> 56);
        put_byte(b);
        if (b == 0xFF) put_byte(0x00);
        acc <<= 8;
        nbits -= 8;
      }
    }
    acc = 0; nbits = 0;
  }
  void restart_marker(int n) {
    flush();
    put_byte(0xFF);
    put_byte(0xD0 + (n & 7));
  }
};

static inline int jpeg_nbits(int v) {
  // number of bits needed for magnitude v (v >= 0)
  return v == 0 ? 0 : 32 - __builtin_clz((unsigned)v);
}

struct CompPlane {
  const int16_t* coef;  // (bh, stride, 64) zigzag order
  int32_t bw, bh, stride;
  int32_t h, v;
  int32_t dc_tbl, ac_tbl;
};

struct CompPlaneMut {
  int16_t* coef;
  int32_t bw, bh, stride;
  int32_t h, v;
  int32_t dc_tbl, ac_tbl;
};

struct Tables {
  const uint32_t* dc_co; const uint8_t* dc_si;   // [4][256]
  const uint32_t* ac_co; const uint8_t* ac_si;
  int64_t* dc_counts; int64_t* ac_counts;        // [4][257] (gather mode)
  bool gather;
  BitWriter* bw;

  inline void dc_symbol(int tbl, int sym) {
    if (gather) { dc_counts[tbl * 257 + sym]++; return; }
    int si = dc_si[tbl * 256 + sym];
    if (si == 0) { bw->overflow = true; return; }  // JERR_MISSING_HUFF
    bw->put(dc_co[tbl * 256 + sym], si);
  }
  inline void ac_symbol(int tbl, int sym) {
    if (gather) { ac_counts[tbl * 257 + sym]++; return; }
    int si = ac_si[tbl * 256 + sym];
    if (si == 0) { bw->overflow = true; return; }  // JERR_MISSING_HUFF
    bw->put(ac_co[tbl * 256 + sym], si);
  }
  inline void bits(uint32_t v, int n) {
    if (!gather && n > 0) bw->put(v, n);
  }
};

// Encode one block, sequential mode (F.1.2; matches encode_one_block).
static inline void encode_block_seq(Tables& T, const int16_t* blk,
                                    int dc_tbl, int ac_tbl, int* last_dc) {
  int temp = blk[0] - *last_dc;
  *last_dc = blk[0];
  int temp2 = temp;
  if (temp < 0) { temp = -temp; temp2--; }
  int nb = jpeg_nbits(temp);
  T.dc_symbol(dc_tbl, nb);
  T.bits((uint32_t)temp2, nb);

  int r = 0;
  for (int k = 1; k < 64; k++) {
    int t = blk[k];
    if (t == 0) { r++; continue; }
    while (r > 15) { T.ac_symbol(ac_tbl, 0xF0); r -= 16; }
    int t2 = t;
    if (t < 0) { t = -t; t2--; }
    int nbits = jpeg_nbits(t);
    T.ac_symbol(ac_tbl, (r << 4) + nbits);
    T.bits((uint32_t)t2, nbits);
    r = 0;
  }
  if (r > 0) T.ac_symbol(ac_tbl, 0x00);  // EOB
}

}  // namespace

// Corrupt-data warning counter (jerror num_warnings): bumped once per
// insufficient-data event (JWRN_HIT_MARKER), bad Huffman code
// (JWRN_HUFF_BAD_CODE), and restart resync (JWRN_MUST_RESYNC), so callers
// can mirror djpeg's exit-with-warnings / -strict behavior.
std::atomic<long> mj_warn_count{0};
extern "C" {
void mj_reset_warnings(void) { mj_warn_count = 0; }
void mj_set_warnings(long v) { mj_warn_count = v; }
long mj_get_warnings(void) { return mj_warn_count.load(); }
}

extern "C" {

// ---------------------------------------------------------------------------
// Sequential scan (interleaved or single-component). Returns bytes written,
// -1 on buffer overflow. gather!=0: only accumulate symbol counts.
// ---------------------------------------------------------------------------
long mj_encode_seq(const CompPlane* comps, int ncomp,
                   int mcus_x, int mcus_y, int restart_interval,
                   const uint32_t* dc_co, const uint8_t* dc_si,
                   const uint32_t* ac_co, const uint8_t* ac_si,
                   uint8_t* out, long cap,
                   int64_t* dc_counts, int64_t* ac_counts, int gather) {
  BitWriter bw; bw.init(out, cap);
  Tables T{dc_co, dc_si, ac_co, ac_si, dc_counts, ac_counts, gather != 0, &bw};
  int last_dc[16] = {0};
  int restarts_to_go = restart_interval;
  int next_restart = 0;

  long mcu_index = 0;
  for (int my = 0; my < mcus_y; my++) {
    for (int mx = 0; mx < mcus_x; mx++, mcu_index++) {
      if (restart_interval && restarts_to_go == 0) {
        if (!gather) bw.restart_marker(next_restart);
        next_restart = (next_restart + 1) & 7;
        restarts_to_go = restart_interval;
        memset(last_dc, 0, sizeof(last_dc));
      }
      for (int ci = 0; ci < ncomp; ci++) {
        const CompPlane& c = comps[ci];
        for (int v = 0; v < c.v; v++) {
          for (int h = 0; h < c.h; h++) {
            long by = (long)my * c.v + v;
            long bx = (long)mx * c.h + h;
            const int16_t* blk = c.coef + (by * c.stride + bx) * 64;
            encode_block_seq(T, blk, c.dc_tbl, c.ac_tbl, &last_dc[ci]);
          }
        }
      }
      if (restart_interval) restarts_to_go--;
    }
  }
  if (!gather) bw.flush();
  if (bw.overflow) return -1;
  return bw.pos;
}

// ---------------------------------------------------------------------------
// Progressive: DC first scan (Ss=0, Se=0, Ah=0). Interleaved allowed.
// ---------------------------------------------------------------------------
long mj_encode_dc_first(const CompPlane* comps, int ncomp,
                        int mcus_x, int mcus_y, int restart_interval, int Al,
                        const uint32_t* dc_co, const uint8_t* dc_si,
                        uint8_t* out, long cap,
                        int64_t* dc_counts, int gather) {
  BitWriter bw; bw.init(out, cap);
  Tables T{dc_co, dc_si, nullptr, nullptr, dc_counts, nullptr, gather != 0, &bw};
  int last_dc[16] = {0};
  int restarts_to_go = restart_interval;
  int next_restart = 0;

  for (int my = 0; my < mcus_y; my++) {
    for (int mx = 0; mx < mcus_x; mx++) {
      if (restart_interval && restarts_to_go == 0) {
        if (!gather) bw.restart_marker(next_restart);
        next_restart = (next_restart + 1) & 7;
        restarts_to_go = restart_interval;
        memset(last_dc, 0, sizeof(last_dc));
      }
      for (int ci = 0; ci < ncomp; ci++) {
        const CompPlane& c = comps[ci];
        for (int v = 0; v < c.v; v++) {
          for (int h = 0; h < c.h; h++) {
            long by = (long)my * c.v + v;
            long bx = (long)mx * c.h + h;
            const int16_t* blk = c.coef + (by * c.stride + bx) * 64;
            int temp2 = ((int)blk[0]) >> Al;   // arithmetic shift (IRIGHT_SHIFT)
            int temp = temp2 - last_dc[ci];
            last_dc[ci] = temp2;
            int t2 = temp;
            if (temp < 0) { temp = -temp; t2--; }
            int nb = jpeg_nbits(temp);
            T.dc_symbol(c.dc_tbl, nb);
            T.bits((uint32_t)t2, nb);
          }
        }
      }
      if (restart_interval) restarts_to_go--;
    }
  }
  if (!gather) bw.flush();
  if (bw.overflow) return -1;
  return bw.pos;
}

// DC refine scan: one raw bit per block, no Huffman stats needed.
long mj_encode_dc_refine(const CompPlane* comps, int ncomp,
                         int mcus_x, int mcus_y, int restart_interval, int Al,
                         uint8_t* out, long cap) {
  BitWriter bw; bw.init(out, cap);
  int restarts_to_go = restart_interval;
  int next_restart = 0;
  for (int my = 0; my < mcus_y; my++) {
    for (int mx = 0; mx < mcus_x; mx++) {
      if (restart_interval && restarts_to_go == 0) {
        bw.restart_marker(next_restart);
        next_restart = (next_restart + 1) & 7;
        restarts_to_go = restart_interval;
      }
      for (int ci = 0; ci < ncomp; ci++) {
        const CompPlane& c = comps[ci];
        for (int v = 0; v < c.v; v++) {
          for (int h = 0; h < c.h; h++) {
            long by = (long)my * c.v + v;
            long bx = (long)mx * c.h + h;
            const int16_t* blk = c.coef + (by * c.stride + bx) * 64;
            bw.put((uint32_t)((((int)blk[0]) >> Al) & 1), 1);
          }
        }
      }
      if (restart_interval) restarts_to_go--;
    }
  }
  bw.flush();
  if (bw.overflow) return -1;
  return bw.pos;
}

// ---------------------------------------------------------------------------
// Progressive AC scans (single component, non-interleaved by spec), the
// plain twins: every coefficient of the band tested one at a time. No
// path of the program calls them; tests hold mj_encode_ac_first and
// mj_encode_ac_refine (the bitmap walk, after the extern "C" block) to
// them. State for EOB runs and correction bits matches jcphuff.c.
// ---------------------------------------------------------------------------
namespace {

struct ACState {
  Tables* T;
  int ac_tbl;
  unsigned eobrun = 0;
  uint8_t corr_bits[1024];
  int BE = 0;  // buffered correction bits

  void emit_eobrun() {
    if (eobrun > 0) {
      int nbits = jpeg_nbits((int)eobrun) - 1;
      T->ac_symbol(ac_tbl, nbits << 4);
      if (nbits) T->bits(eobrun, nbits);
      eobrun = 0;
      for (int i = 0; i < BE; i++) T->bits(corr_bits[i], 1);
      BE = 0;
    }
  }
};

}  // namespace

long mj_encode_ac_first_plain(const CompPlane* comp,
                              int Ss, int Se, int Al, int restart_interval,
                              const uint32_t* ac_co, const uint8_t* ac_si,
                              uint8_t* out, long cap,
                              int64_t* ac_counts, int gather) {
  BitWriter bw; bw.init(out, cap);
  Tables T{nullptr, nullptr, ac_co, ac_si, nullptr, ac_counts, gather != 0, &bw};
  const CompPlane& c = *comp;
  ACState S; S.T = &T; S.ac_tbl = c.ac_tbl;
  int restarts_to_go = restart_interval;
  int next_restart = 0;

  for (long by = 0; by < c.bh; by++) {
    for (long bx = 0; bx < c.bw; bx++) {
      if (restart_interval && restarts_to_go == 0) {
        S.emit_eobrun();
        if (!gather) bw.restart_marker(next_restart);
        next_restart = (next_restart + 1) & 7;
        restarts_to_go = restart_interval;
        S.eobrun = 0; S.BE = 0;
      }
      const int16_t* blk = c.coef + (by * c.stride + bx) * 64;
      int r = 0;
      bool any = false;
      for (int k = Ss; k <= Se; k++) {
        int temp = blk[k];
        if (temp == 0) { r++; continue; }
        // point transform: shift magnitude (round toward 0)
        int temp2 = temp >> 31;
        temp ^= temp2; temp -= temp2;       // abs
        temp >>= Al;
        if (temp == 0) { r++; continue; }
        temp2 ^= temp;                       // complement trick for negatives
        if (!any) { if (S.eobrun > 0) S.emit_eobrun(); any = true; }
        while (r > 15) { T.ac_symbol(c.ac_tbl, 0xF0); r -= 16; }
        int nbits = jpeg_nbits(temp);
        T.ac_symbol(c.ac_tbl, (r << 4) + nbits);
        T.bits((uint32_t)temp2, nbits);
        r = 0;
      }
      if (r > 0) {  // trailing zeros -> EOB run
        S.eobrun++;
        if (S.eobrun == 0x7FFF) S.emit_eobrun();
      }
      if (restart_interval) restarts_to_go--;
    }
  }
  S.emit_eobrun();
  if (!gather) bw.flush();
  if (bw.overflow) return -1;
  return bw.pos;
}

long mj_encode_ac_refine_plain(const CompPlane* comp,
                               int Ss, int Se, int Al, int restart_interval,
                               const uint32_t* ac_co, const uint8_t* ac_si,
                               uint8_t* out, long cap,
                               int64_t* ac_counts, int gather) {
  BitWriter bw; bw.init(out, cap);
  Tables T{nullptr, nullptr, ac_co, ac_si, nullptr, ac_counts, gather != 0, &bw};
  const CompPlane& c = *comp;
  ACState S; S.T = &T; S.ac_tbl = c.ac_tbl;
  int restarts_to_go = restart_interval;
  int next_restart = 0;

  for (long by = 0; by < c.bh; by++) {
    for (long bx = 0; bx < c.bw; bx++) {
      if (restart_interval && restarts_to_go == 0) {
        S.emit_eobrun();
        if (!gather) bw.restart_marker(next_restart);
        next_restart = (next_restart + 1) & 7;
        restarts_to_go = restart_interval;
        S.eobrun = 0; S.BE = 0;
      }
      const int16_t* blk = c.coef + (by * c.stride + bx) * 64;
      // absolute values after point transform; EOB = last newly-nonzero index
      int absval[64];
      int EOB = Ss - 1;
      for (int k = Ss; k <= Se; k++) {
        int t = blk[k];
        if (t < 0) t = -t;
        t >>= Al;
        absval[k] = t;
        if (t == 1) EOB = k;
      }
      int r = 0;
      uint8_t local_bits[64];
      int BR = 0;
      for (int k = Ss; k <= Se; k++) {
        int temp = absval[k];
        if (temp == 0) { r++; continue; }
        while (r > 15 && k <= EOB) {
          S.emit_eobrun();
          T.ac_symbol(c.ac_tbl, 0xF0);
          r -= 16;
          for (int i = 0; i < BR; i++) T.bits(local_bits[i], 1);
          BR = 0;
        }
        if (temp > 1) {  // previously nonzero: buffer correction bit
          local_bits[BR++] = (uint8_t)(temp & 1);
          continue;
        }
        S.emit_eobrun();
        T.ac_symbol(c.ac_tbl, (r << 4) + 1);
        T.bits(blk[k] < 0 ? 0u : 1u, 1);   // sign bit
        for (int i = 0; i < BR; i++) T.bits(local_bits[i], 1);
        BR = 0;
        r = 0;
      }
      if (r > 0 || BR > 0) {
        S.eobrun++;
        for (int i = 0; i < BR; i++) S.corr_bits[S.BE + i] = local_bits[i];
        S.BE += BR;
        if (S.eobrun == 0x7FFF || S.BE > 1000 - 64 + 1)
          S.emit_eobrun();
      }
      if (restart_interval) restarts_to_go--;
    }
  }
  S.emit_eobrun();
  if (!gather) bw.flush();
  if (bw.overflow) return -1;
  return bw.pos;
}

// ---------------------------------------------------------------------------
// Optimal Huffman table generation (Annex K.2 with libjpeg tie-breaking).
// freq: int64[257] (entry 256 forced nonzero). Outputs bits[17], vals[256].
// Returns number of values, or -1 on overflow.
// ---------------------------------------------------------------------------
long mj_gen_optimal_table(int64_t* freq, uint8_t* out_bits, uint8_t* out_vals) {
  const int MAX_CLEN = 32;
  int bits[MAX_CLEN + 1]; memset(bits, 0, sizeof(bits));
  int bit_pos[MAX_CLEN + 1];
  int codesize[257]; memset(codesize, 0, sizeof(codesize));
  int others[257];
  int nz_index[257];
  int64_t f[257];

  freq[256] = 1;
  int n = 0;
  for (int i = 0; i < 257; i++) {
    if (freq[i]) { nz_index[n] = i; f[n] = freq[i]; n++; }
  }
  for (int i = 0; i < n; i++) others[i] = -1;

  const int64_t BIG = 1000000000LL;
  for (;;) {
    int c1 = -1, c2 = -1;
    int64_t v = BIG, v2 = BIG;
    for (int i = 0; i < n; i++) {
      if (f[i] <= v2) {
        if (f[i] <= v) { c2 = c1; v2 = v; v = f[i]; c1 = i; }
        else { v2 = f[i]; c2 = i; }
      }
    }
    if (c2 < 0) break;
    f[c1] += f[c2];
    f[c2] = BIG + 1;
    codesize[c1]++;
    while (others[c1] >= 0) { c1 = others[c1]; codesize[c1]++; }
    others[c1] = c2;
    codesize[c2]++;
    while (others[c2] >= 0) { c2 = others[c2]; codesize[c2]++; }
  }

  for (int i = 0; i < n; i++) {
    if (codesize[i] > MAX_CLEN) return -1;
    bits[codesize[i]]++;
  }
  int p = 0;
  for (int i = 1; i <= MAX_CLEN; i++) { bit_pos[i] = p; p += bits[i]; }

  for (int i = MAX_CLEN; i > 16; i--) {
    while (bits[i] > 0) {
      int j = i - 2;
      while (bits[j] == 0) j--;
      bits[i] -= 2;
      bits[i - 1]++;
      bits[j + 1] += 2;
      bits[j]--;
    }
  }
  int i = 16;
  while (bits[i] == 0) i--;
  bits[i]--;

  memset(out_bits, 0, 17);
  for (int l = 1; l <= 16; l++) out_bits[l] = (uint8_t)bits[l];
  memset(out_vals, 0, 256);
  for (int k = 0; k < n - 1; k++) {
    out_vals[bit_pos[codesize[k]]] = (uint8_t)nz_index[k];
    bit_pos[codesize[k]]++;
  }
  long total = 0;
  for (int l = 1; l <= 16; l++) total += out_bits[l];
  return total;
}

// ---------------------------------------------------------------------------
// Bit reader (decode side)
// ---------------------------------------------------------------------------
namespace {

struct BitReader {
  const uint8_t* data;
  long len;
  long pos;        // next byte to read
  uint64_t acc;    // left-justified bits
  int nbits;
  int real_bits;   // bits in acc that came from actual data (rest zero-fed)
  bool saw_marker; // hit a non-stuffing marker: feed zeroes from now on
  bool insufficient;  // ran out of real bits (jdhuff insufficient_data);
                      // sticky until a restart marker is consumed
  long marker_pos;  // byte offset of the 0xFF of the marker (if saw_marker)
  long warns = 0;   // per-call corrupt-data warning count

  void init(const uint8_t* d, long l) {
    data = d; len = l; pos = 0; acc = 0; nbits = 0; real_bits = 0;
    saw_marker = false; insufficient = false; marker_pos = -1;
  }
  // load up to 8 more bits
  inline void fill() {
    while (nbits <= 56) {
      if (saw_marker || pos >= len) {
        // feed zero bits (jdhuff inserts zeroes at data end)
        nbits += 8;
        continue;
      }
      uint8_t b = data[pos];
      if (b == 0xFF) {
        if (pos + 1 < len && data[pos + 1] == 0x00) {
          pos += 2;
        } else {
          saw_marker = true;
          marker_pos = pos;
          nbits += 8;
          continue;
        }
      } else {
        pos += 1;
      }
      acc |= (uint64_t)b << (56 - nbits);
      nbits += 8;
      real_bits += 8;
    }
  }
  inline void skip(int n) {
    acc <<= n;
    nbits -= n;
  }
  inline int get(int n) {
    if (n == 0) return 0;
    if (nbits < n) fill();
    // jdhuff fill_bit_buffer: a request that real data can't satisfy
    // warns once and zero-fills (entropy->insufficient_data)
    if (n > real_bits && !insufficient) {
      insufficient = true;
      warns++;
    }
    real_bits = real_bits >= n ? real_bits - n : 0;
    int v = (int)(acc >> (64 - n));
    acc <<= n;
    nbits -= n;
    return v;
  }
  // Align to byte boundary and consume an expected RSTn marker.
  // Returns marker code byte or -1. Safe because the encoder byte-aligns
  // before RSTn, so at a restart boundary the accumulator holds only pad
  // bits (<8 real bits) or zero-fed bits — never whole unconsumed bytes.
  int read_restart() {
    acc = 0; nbits = 0; real_bits = 0;
    long p = saw_marker ? (long)marker_pos : pos;
    saw_marker = false;
    marker_pos = -1;
    // scan for marker, skipping 0xFF fill bytes
    while (p + 1 < len) {
      if (data[p] == 0xFF && data[p + 1] != 0x00) {
        long q = p + 1;
        while (q < len && data[q] == 0xFF) q++;  // FF fill
        if (q >= len) break;
        pos = q + 1;
        // process_restart resets the out-of-data flag only when a real
        // RSTn was consumed (jdhuff.c:537-540 via unread_marker == 0)
        if (data[q] >= 0xD0 && data[q] <= 0xD7) insufficient = false;
        else {
          warns++;  // JWRN_MUST_RESYNC
          saw_marker = true; marker_pos = q - 1; pos = q - 1;
        }
        return data[q];
      }
      p++;  // resync past garbage
    }
    pos = len;
    return -1;
  }
};

struct DecTables {
  const int32_t* mincode;  // [4][17]
  const int64_t* maxcode;  // [4][18]
  const int32_t* valptr;   // [4][17]
  const uint8_t* vals;     // [4][256]
};

// Decode one Huffman symbol (spec F.2.2.3).
static inline int huff_decode(BitReader& br, const DecTables& t, int tbl) {
  const int64_t* maxcode = t.maxcode + tbl * 18;
  const int32_t* mincode = t.mincode + tbl * 17;
  const int32_t* valptr = t.valptr + tbl * 17;
  const uint8_t* vals = t.vals + tbl * 256;
  int code = br.get(1);
  int l = 1;
  while (code > maxcode[l]) {
    code = (code << 1) | br.get(1);
    l++;
    // jpeg_huff_decode: bad code warns and fakes a zero (jdhuff.c) so
    // corrupt/truncated streams keep decoding like djpeg does
    if (l > 16) { br.warns++; return 0; }
  }
  return vals[valptr[l] + (code - mincode[l])];
}

// HUFF_EXTEND (F.2.2.1)
static inline int huff_extend(int v, int nbits) {
  return (v < (1 << (nbits - 1))) ? v - (1 << nbits) + 1 : v;
}

}  // namespace

// Sequential scan decode. Returns bytes consumed (scan data incl. RSTs),
// or -1 on malformed stream (decoded what it could).
long mj_decode_seq(const uint8_t* data, long len,
                   CompPlaneMut* comps, int ncomp,
                   int mcus_x, int mcus_y, int restart_interval,
                   const int32_t* dc_mincode, const int64_t* dc_maxcode,
                   const int32_t* dc_valptr, const uint8_t* dc_vals,
                   const int32_t* ac_mincode, const int64_t* ac_maxcode,
                   const int32_t* ac_valptr, const uint8_t* ac_vals,
                   int32_t* last_good_row, int64_t* warn_out) {
  BitReader br; br.init(data, len);
  DecTables dct{dc_mincode, dc_maxcode, dc_valptr, dc_vals};
  DecTables act{ac_mincode, ac_maxcode, ac_valptr, ac_vals};
  int last_dc[16] = {0};
  int restarts_to_go = restart_interval;
  if (last_good_row) *last_good_row = 0;

  for (int my = 0; my < mcus_y; my++) {
    for (int mx = 0; mx < mcus_x; mx++) {
      if (restart_interval && restarts_to_go == 0) {
        br.read_restart();
        memset(last_dc, 0, sizeof(last_dc));
        restarts_to_go = restart_interval;
      }
      // out of data: leave the (pre-zeroed) MCU alone -> uniform gray
      // for the rest of the segment (jdhuff.c:787-790); last_good row
      // tracks the input row while data remains (jdcoefct.c:233-234)
      if (!br.insufficient) {
        if (last_good_row) *last_good_row = my;
      for (int ci = 0; ci < ncomp; ci++) {
        CompPlaneMut& c = comps[ci];
        for (int v = 0; v < c.v; v++) {
          for (int h = 0; h < c.h; h++) {
            long by = (long)my * c.v + v;
            long bx = (long)mx * c.h + h;
            int16_t* blk = c.coef + (by * c.stride + bx) * 64;
            int s = huff_decode(br, dct, c.dc_tbl);
            int diff = s ? huff_extend(br.get(s), s) : 0;
            last_dc[ci] += diff;
            blk[0] = (int16_t)last_dc[ci];
            int k = 1;
            while (k < 64) {
              int rs = huff_decode(br, act, c.ac_tbl);
              int r = rs >> 4, sz = rs & 15;
              if (sz == 0) {
                if (r != 15) break;  // EOB
                k += 16;             // ZRL
              } else {
                k += r;
                // corrupt data: jpeg_natural_order's padding maps any
                // overrun to position 63 (jdhuff.c:612-619)
                blk[k > 63 ? 63 : k] = (int16_t)huff_extend(br.get(sz), sz);
                k++;
              }
            }
          }
        }
      }
      }
      if (restart_interval) restarts_to_go--;
    }
  }
  mj_warn_count += br.warns;
  if (warn_out)  // atomic: concurrent scans of one image share the buffer
    __atomic_fetch_add(warn_out, br.warns, __ATOMIC_RELAXED);
  return br.saw_marker ? br.marker_pos : br.pos;
}

// Restart-parallel sequential decode: when the scan carries RSTn markers,
// the segments are independent (DC predictors and bit alignment reset at
// each marker, jdhuff.c process_restart) so they decode concurrently.
// Strict-clean contract: any structural surprise (marker count or sequence
// mismatch) returns -2 and any corrupt-data warning returns -3, and the
// caller reruns the serial decoder for exact warn-and-resync semantics.
long mj_decode_seq_par(const uint8_t* data, long len,
                       CompPlaneMut* comps, int ncomp,
                       int mcus_x, int mcus_y, int restart_interval,
                       const int32_t* dc_mincode, const int64_t* dc_maxcode,
                       const int32_t* dc_valptr, const uint8_t* dc_vals,
                       const int32_t* ac_mincode, const int64_t* ac_maxcode,
                       const int32_t* ac_valptr, const uint8_t* ac_vals,
                       int32_t* last_good_row, int nthreads,
                       int64_t* warn_out) {
  const long num_mcus = (long)mcus_x * mcus_y;
  const int r = restart_interval;
  if (r <= 0) return -2;
  const long nseg = (num_mcus + r - 1) / r;
  if (nseg < 2) return -2;

  // one pass over the scan data locating RSTn boundaries
  std::vector<long> seg_start, seg_end;
  seg_start.reserve(nseg); seg_end.reserve(nseg);
  seg_start.push_back(0);
  long i = 0;
  int expect = 0;
  while (i + 1 < len && (long)seg_start.size() < nseg) {
    if (data[i] != 0xFF) { i++; continue; }
    long j = i + 1;
    while (j < len && data[j] == 0xFF) j++;   // FF fill bytes
    if (j >= len) break;
    if (data[j] == 0x00) { i = j + 1; continue; }  // stuffed FF
    if (data[j] >= 0xD0 && data[j] <= 0xD7) {
      if ((data[j] - 0xD0) != (expect & 7)) return -2;
      expect++;
      seg_end.push_back(i);
      seg_start.push_back(j + 1);
      i = j + 1;
      continue;
    }
    break;  // EOI / next-scan marker: end of this scan's data
  }
  if ((long)seg_start.size() != nseg) return -2;
  seg_end.push_back(len);

  DecTables dct{dc_mincode, dc_maxcode, dc_valptr, dc_vals};
  DecTables act{ac_mincode, ac_maxcode, ac_valptr, ac_vals};
  std::atomic<long> call_warns{0};

  int nt = nthreads > 0 ? nthreads : 1;
  if (nt > (int)nseg) nt = (int)nseg;
  std::atomic<long> consumed_last{0};

  auto worker = [&](int tid) {
    for (long s = tid; s < nseg; s += nt) {
      BitReader br;
      br.init(data + seg_start[s], seg_end[s] - seg_start[s]);
      int last_dc[16] = {0};
      long m0 = s * (long)r;
      long m1 = m0 + r < num_mcus ? m0 + r : num_mcus;
      for (long m = m0; m < m1 && !br.insufficient; m++) {
        long my = m / mcus_x, mx = m % mcus_x;
        for (int ci = 0; ci < ncomp; ci++) {
          CompPlaneMut& c = comps[ci];
          for (int v = 0; v < c.v; v++) {
            for (int h = 0; h < c.h; h++) {
              long by = my * c.v + v;
              long bx = mx * c.h + h;
              int16_t* blk = c.coef + (by * c.stride + bx) * 64;
              int sz0 = huff_decode(br, dct, c.dc_tbl);
              int diff = sz0 ? huff_extend(br.get(sz0), sz0) : 0;
              last_dc[ci] += diff;
              blk[0] = (int16_t)last_dc[ci];
              int k = 1;
              while (k < 64) {
                int rs = huff_decode(br, act, c.ac_tbl);
                int rr = rs >> 4, sz = rs & 15;
                if (sz == 0) {
                  if (rr != 15) break;
                  k += 16;
                } else {
                  k += rr;
                  blk[k > 63 ? 63 : k] = (int16_t)huff_extend(br.get(sz), sz);
                  k++;
                }
              }
            }
          }
        }
      }
      if (br.insufficient) br.warns++;  // force the serial fallback
      call_warns += br.warns;
      if (s == nseg - 1)
        consumed_last = seg_start[s]
            + (br.saw_marker ? br.marker_pos : br.pos);
    }
  };

  if (nt == 1) {
    worker(0);
  } else {
    std::vector<std::thread> ts;
    for (int t = 0; t < nt; t++) ts.emplace_back(worker, t);
    for (auto& t : ts) t.join();
  }

  if (call_warns.load() != 0) return -3;   // serial fallback recounts
  (void)warn_out;                           // clean runs record nothing
  if (last_good_row) *last_good_row = mcus_y - 1;
  return consumed_last.load();
}

// Progressive DC first scan decode (Ss=0, Ah=0).
long mj_decode_dc_first(const uint8_t* data, long len,
                        CompPlaneMut* comps, int ncomp,
                        int mcus_x, int mcus_y, int restart_interval, int Al,
                        const int32_t* dc_mincode, const int64_t* dc_maxcode,
                        const int32_t* dc_valptr, const uint8_t* dc_vals,
                        int32_t* last_good_row, int64_t* warn_out) {
  BitReader br; br.init(data, len);
  DecTables dct{dc_mincode, dc_maxcode, dc_valptr, dc_vals};
  int last_dc[16] = {0};
  int restarts_to_go = restart_interval;
  if (last_good_row) *last_good_row = 0;
  for (int my = 0; my < mcus_y; my++) {
    for (int mx = 0; mx < mcus_x; mx++) {
      if (restart_interval && restarts_to_go == 0) {
        br.read_restart();
        memset(last_dc, 0, sizeof(last_dc));
        restarts_to_go = restart_interval;
      }
      if (!br.insufficient) {
        if (last_good_row) *last_good_row = my;
      for (int ci = 0; ci < ncomp; ci++) {
        CompPlaneMut& c = comps[ci];
        for (int v = 0; v < c.v; v++) {
          for (int h = 0; h < c.h; h++) {
            long by = (long)my * c.v + v;
            long bx = (long)mx * c.h + h;
            int16_t* blk = c.coef + (by * c.stride + bx) * 64;
            int s = huff_decode(br, dct, c.dc_tbl);
            int diff = s ? huff_extend(br.get(s), s) : 0;
            last_dc[ci] += diff;
            blk[0] = (int16_t)(last_dc[ci] << Al);
          }
        }
      }
      }
      if (restart_interval) restarts_to_go--;
    }
  }
  mj_warn_count += br.warns;
  if (warn_out)  // atomic: concurrent scans of one image share the buffer
    __atomic_fetch_add(warn_out, br.warns, __ATOMIC_RELAXED);
  return br.saw_marker ? br.marker_pos : br.pos;
}

// Progressive DC refine scan decode.
long mj_decode_dc_refine(const uint8_t* data, long len,
                         CompPlaneMut* comps, int ncomp,
                         int mcus_x, int mcus_y, int restart_interval, int Al,
                         int32_t* last_good_row, int64_t* warn_out) {
  BitReader br; br.init(data, len);
  int restarts_to_go = restart_interval;
  int p1 = 1 << Al;
  if (last_good_row) *last_good_row = 0;
  for (int my = 0; my < mcus_y; my++) {
    for (int mx = 0; mx < mcus_x; mx++) {
      if (restart_interval && restarts_to_go == 0) {
        br.read_restart();
        restarts_to_go = restart_interval;
      }
      // zero-fed bits never set correction bits, so out-of-data MCUs are
      // naturally untouched (jdphuff.c:466-468 skips the check too)
      if (!br.insufficient && last_good_row) *last_good_row = my;
      for (int ci = 0; ci < ncomp; ci++) {
        CompPlaneMut& c = comps[ci];
        for (int v = 0; v < c.v; v++) {
          for (int h = 0; h < c.h; h++) {
            long by = (long)my * c.v + v;
            long bx = (long)mx * c.h + h;
            int16_t* blk = c.coef + (by * c.stride + bx) * 64;
            if (br.get(1)) blk[0] |= p1;
          }
        }
      }
      if (restart_interval) restarts_to_go--;
    }
  }
  mj_warn_count += br.warns;
  if (warn_out)  // atomic: concurrent scans of one image share the buffer
    __atomic_fetch_add(warn_out, br.warns, __ATOMIC_RELAXED);
  return br.saw_marker ? br.marker_pos : br.pos;
}

// Progressive AC first scan decode (single component).
long mj_decode_ac_first(const uint8_t* data, long len,
                        CompPlaneMut* comp,
                        int Ss, int Se, int Al, int restart_interval,
                        const int32_t* ac_mincode, const int64_t* ac_maxcode,
                        const int32_t* ac_valptr, const uint8_t* ac_vals,
                        int32_t* last_good_row, int64_t* warn_out) {
  BitReader br; br.init(data, len);
  DecTables act{ac_mincode, ac_maxcode, ac_valptr, ac_vals};
  CompPlaneMut& c = *comp;
  unsigned eobrun = 0;
  int restarts_to_go = restart_interval;
  if (last_good_row) *last_good_row = 0;

  for (long by = 0; by < c.bh; by++) {
    for (long bx = 0; bx < c.bw; bx++) {
      if (restart_interval && restarts_to_go == 0) {
        br.read_restart();
        eobrun = 0;
        restarts_to_go = restart_interval;
      }
      int16_t* blk = c.coef + (by * c.stride + bx) * 64;
      if (br.insufficient) {
        // out of data: leave the MCU as-is (jdphuff.c:387)
      } else {
      if (last_good_row) *last_good_row = (int32_t)by;
      if (eobrun > 0) {
        eobrun--;
      } else {
        int k = Ss;
        while (k <= Se) {
          int rs = huff_decode(br, act, c.ac_tbl);
          int r = rs >> 4, sz = rs & 15;
          if (sz == 0) {
            if (r != 15) {
              eobrun = (1u << r) - 1;
              if (r) eobrun += br.get(r);
              break;
            }
            k += 16;
          } else {
            k += r;
            // corrupt data: one write may land past Se; natural-order
            // padding clamps it to position 63 (jdphuff.c:412-414)
            blk[k > 63 ? 63 : k] =
                (int16_t)(huff_extend(br.get(sz), sz) * (1 << Al));
            k++;
          }
        }
      }
      }
      if (restart_interval) restarts_to_go--;
    }
  }
  mj_warn_count += br.warns;
  if (warn_out)  // atomic: concurrent scans of one image share the buffer
    __atomic_fetch_add(warn_out, br.warns, __ATOMIC_RELAXED);
  return br.saw_marker ? br.marker_pos : br.pos;
}

// Progressive AC refine scan decode (G.2; matches jdphuff decode_mcu_AC_refine).
long mj_decode_ac_refine(const uint8_t* data, long len,
                         CompPlaneMut* comp,
                         int Ss, int Se, int Al, int restart_interval,
                         const int32_t* ac_mincode, const int64_t* ac_maxcode,
                         const int32_t* ac_valptr, const uint8_t* ac_vals,
                         int32_t* last_good_row, int64_t* warn_out) {
  BitReader br; br.init(data, len);
  DecTables act{ac_mincode, ac_maxcode, ac_valptr, ac_vals};
  CompPlaneMut& c = *comp;
  unsigned eobrun = 0;
  int restarts_to_go = restart_interval;
  int p1 = 1 << Al;
  int m1 = -(1 << Al);
  if (last_good_row) *last_good_row = 0;

  for (long by = 0; by < c.bh; by++) {
    for (long bx = 0; bx < c.bw; bx++) {
      if (restart_interval && restarts_to_go == 0) {
        br.read_restart();
        eobrun = 0;
        restarts_to_go = restart_interval;
      }
      int16_t* blk = c.coef + (by * c.stride + bx) * 64;
      // out of data: don't modify the MCU (jdphuff.c:525-526)
      if (br.insufficient) {
        if (restart_interval) restarts_to_go--;
        continue;
      }
      if (last_good_row) *last_good_row = (int32_t)by;
      int k = Ss;
      if (eobrun == 0) {
        while (k <= Se) {
          int rs = huff_decode(br, act, c.ac_tbl);
          int r = rs >> 4, sz = rs & 15;
          int coef_to_set = 0;
          if (sz == 0) {
            if (r != 15) {
              eobrun = (1u << r);
              if (r) eobrun += br.get(r);
              break;  // rest handled by EOB logic below
            }
            // ZRL: skip 16 zero-history coefficients
          } else {
            // sz must be 1 for refinement scans
            coef_to_set = br.get(1) ? p1 : m1;
          }
          // advance over r zero-history coefficients, applying correction
          // bits to nonzero-history ones along the way
          while (k <= Se) {
            int16_t* p = &blk[k];
            if (*p != 0) {
              if (br.get(1)) {
                if ((*p & p1) == 0)
                  *p += (int16_t)(*p >= 0 ? p1 : m1);
              }
            } else {
              if (r == 0) break;
              r--;
            }
            k++;
          }
          if (coef_to_set && k <= Se) blk[k] = (int16_t)coef_to_set;
          k++;
        }
      }
      if (eobrun > 0) {
        // apply correction bits to remaining nonzero-history coefficients
        while (k <= Se) {
          int16_t* p = &blk[k];
          if (*p != 0) {
            if (br.get(1)) {
              if ((*p & p1) == 0)
                *p += (int16_t)(*p >= 0 ? p1 : m1);
            }
          }
          k++;
        }
        eobrun--;
      }
      if (restart_interval) restarts_to_go--;
    }
  }
  mj_warn_count += br.warns;
  if (warn_out)  // atomic: concurrent scans of one image share the buffer
    __atomic_fetch_add(warn_out, br.warns, __ATOMIC_RELAXED);
  return br.saw_marker ? br.marker_pos : br.pos;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Progressive AC scans through a per-block bitmap of the band's nonzero
// coefficients (jcphuff.c's encode_mcu_AC_first_prepare and
// encode_mcu_AC_refine_prepare, SIMD in libjpeg-turbo's jcphuff-sse2.asm).
// Per block, a prepare step computes the magnitudes after the point
// transform, the value bits JPEG emits and a 64-bit mask of the
// coefficients that are nonzero after the transform, cut to the band;
// the coder then visits only the mask's set bits, each found by count
// trailing zeros, and a block whose mask is empty goes straight to the
// EOB run. The prepare is AVX2 where the build targets it (-march=native)
// and a scalar loop otherwise; both give the same values. Symbols, bits,
// counts and return values are those of the _plain twins above.
// ---------------------------------------------------------------------------
namespace {

// the bits Ss..Se of a 64-bit mask
static inline uint64_t band_mask(int Ss, int Se) {
  return (~0ULL >> (63 - Se)) & (~0ULL << Ss);
}

// Prepare one block: mag[k] = |c| >> Al, and with vals, vals[k] = mag[k]
// XOR the sign (the first scan's value bits: the complement for a
// negative coefficient). Returns the mask of nonzero mag[k], and in
// *ones that of mag[k] == 1 (refinement scans: the newly nonzero
// coefficients).
template <bool with_vals, bool with_ones>
static inline uint64_t prepare(const int16_t* blk, int Al, uint16_t* mag,
                               uint16_t* vals, uint64_t* ones) {
#if defined(__AVX2__)
  const __m128i sh = _mm_cvtsi32_si128(Al);
  const __m256i zero = _mm256_setzero_si256();
  const __m256i one = _mm256_set1_epi16(1);
  __m256i z[4], o[4];
  for (int v = 0; v < 4; v++) {
    const __m256i x =
        _mm256_loadu_si256(reinterpret_cast<const __m256i*>(blk + 16 * v));
    // abs(-32768) stays 0x8000, which the logical shift reads as 32768
    const __m256i a = _mm256_srl_epi16(_mm256_abs_epi16(x), sh);
    _mm256_storeu_si256(reinterpret_cast<__m256i*>(mag + 16 * v), a);
    if constexpr (with_vals)
      _mm256_storeu_si256(reinterpret_cast<__m256i*>(vals + 16 * v),
                          _mm256_xor_si256(a, _mm256_srai_epi16(x, 15)));
    z[v] = _mm256_cmpeq_epi16(a, zero);
    if constexpr (with_ones) o[v] = _mm256_cmpeq_epi16(a, one);
  }
  // 16-bit lanes of two vectors -> bytes in coefficient order -> bits
  auto bits32 = [](__m256i lo, __m256i hi) {
    return (uint32_t)_mm256_movemask_epi8(
        _mm256_permute4x64_epi64(_mm256_packs_epi16(lo, hi), 0xD8));
  };
  if constexpr (with_ones)
    *ones = bits32(o[0], o[1]) | (uint64_t)bits32(o[2], o[3]) << 32;
  return ~(bits32(z[0], z[1]) | (uint64_t)bits32(z[2], z[3]) << 32);
#else
  uint64_t nz = 0, om = 0;
  for (int k = 0; k < 64; k++) {
    const int x = blk[k];
    const uint16_t a = (uint16_t)((x < 0 ? -x : x) >> Al);
    mag[k] = a;
    if (with_vals) vals[k] = (uint16_t)(a ^ (x < 0 ? 0xFFFF : 0));
    nz |= (uint64_t)(a != 0) << k;
    if (with_ones) om |= (uint64_t)(a == 1) << k;
  }
  if (with_ones) *ones = om;
  return nz;
#endif
}

// The walk's output: symbol counts (gather) or Huffman codes written
// with their value bits in one put (emission).
template <bool gather>
struct ACOut {
  BitWriter* bw;
  const uint32_t* co; const uint8_t* si;   // the scan's table
  int64_t* counts;                          // [257] (gather)

  // symbol sym followed by the n low bits of v (n in [0, 16])
  inline void sym(int sym, uint32_t v, int n) {
    if (gather) { counts[sym]++; return; }
    const int s = si[sym];
    if (s == 0) { bw->overflow = true; return; }  // JERR_MISSING_HUFF
    put((uint64_t)co[sym] << n | (v & ((1u << n) - 1)), s + n);
  }
  // size in [1, 32]; whole bytes leave the accumulator four at a time,
  // so up to 31 bits stay in it between puts
  inline void put(uint64_t code, int size) {
    BitWriter& w = *bw;
    w.acc |= (code & ((1ULL << size) - 1)) << (64 - w.nbits - size);
    w.nbits += size;
    if (w.nbits < 32) return;
    const uint32_t top = (uint32_t)(w.acc >> 32);
    if (((~top - 0x01010101u) & top & 0x80808080u) == 0
        && w.pos + 4 <= w.cap) {   // no 0xFF byte to stuff
      const uint32_t be = __builtin_bswap32(top);
      memcpy(w.out + w.pos, &be, 4);
      w.pos += 4;
    } else {
      for (int i = 0; i < 4; i++) {
        const uint8_t b = (uint8_t)(top >> (24 - 8 * i));
        w.put_byte(b);
        if (b == 0xFF) w.put_byte(0x00);
      }
    }
    w.acc <<= 32;
    w.nbits -= 32;
  }
  // the n (up to 64) bits of v, first bit the most significant
  inline void bits(uint64_t v, int n) {
    if (gather) return;
    while (n > 32) { n -= 32; put(v >> n, 32); }
    if (n > 0) put(v, n);
  }
};

// EOB runs and the refinement scans' buffered correction bits (BE of
// them, packed first bit first), as jcphuff.c keeps them.
template <bool gather>
struct ACRun {
  ACOut<gather>& o;
  unsigned eobrun = 0;
  int BE = 0;
  uint64_t corr[16] = {0};   // up to 937 + 63 bits

  explicit ACRun(ACOut<gather>& o_) : o(o_) {}

  void add_bits(uint64_t v, int n) {   // n in [0, 63]
    if (gather) { BE += n; return; }
    if (n == 0) return;
    const int w = BE >> 6, b = BE & 63, room = 64 - b;
    v &= ~0ULL >> (64 - n);
    if (n <= room) {
      corr[w] |= v << (room - n);
    } else {
      corr[w] |= v >> (n - room);
      corr[w + 1] = v << (64 - (n - room));
    }
    BE += n;
  }
  void emit() {
    if (eobrun == 0) return;
    const int n = jpeg_nbits((int)eobrun) - 1;
    o.sym(n << 4, eobrun, n);
    eobrun = 0;
    if (!gather) {
      int left = BE;
      for (int w = 0; left > 0; w++, left -= 64) {
        const int m = left < 64 ? left : 64;
        o.bits(corr[w] >> (64 - m), m);
        corr[w] = 0;
      }
    }
    BE = 0;
  }
  // a block that ends on zeros (or pending correction bits)
  void add_block() {
    eobrun++;
    if (eobrun == 0x7FFF || BE > 1000 - 64 + 1) emit();
  }
};

template <bool gather, bool refine>
long ac_walk(const CompPlane& c, int Ss, int Se, int Al,
             int restart_interval, ACOut<gather>& o, int64_t* walked) {
  BitWriter& bw = *o.bw;
  ACRun<gather> S(o);
  const uint64_t band = band_mask(Ss, Se);
  alignas(32) uint16_t mag[64], vals[64];
  int restarts_to_go = restart_interval;
  int next_restart = 0;
  long zero_blocks = 0;

  for (long by = 0; by < c.bh; by++) {
    const int16_t* row = c.coef + by * c.stride * 64;
    for (long bx = 0; bx < c.bw; bx++) {
      if (restart_interval && restarts_to_go == 0) {
        S.emit();
        if (!gather) bw.restart_marker(next_restart);
        next_restart = (next_restart + 1) & 7;
        restarts_to_go = restart_interval;
        S.eobrun = 0; S.BE = 0;
      }
      if (restart_interval) restarts_to_go--;
      const int16_t* blk = row + bx * 64;
      uint64_t ones = 0;
      uint64_t m = prepare<!gather && !refine, refine>(
          blk, Al, mag, vals, &ones) & band;
      if (m == 0) {  // the band is all zero: one more block of the run
        zero_blocks++;
        S.add_block();
        continue;
      }
      int prev = Ss - 1;
      if (!refine) {
        S.emit();
        do {
          const int k = __builtin_ctzll(m);
          m &= m - 1;
          int r = k - prev - 1;
          prev = k;
          while (r > 15) { o.sym(0xF0, 0, 0); r -= 16; }
          const int nb = jpeg_nbits(mag[k]);
          o.sym((r << 4) + nb, vals[k], nb);
        } while (m);
        if (prev < Se) S.add_block();
        continue;
      }
      // refinement: EOB is the last newly nonzero coefficient; those
      // nonzero before are one correction bit each, buffered
      ones &= band;
      const int EOB = ones ? 63 - __builtin_clzll(ones) : Ss - 1;
      int r = 0, BR = 0;
      uint64_t cb = 0;
      do {
        const int k = __builtin_ctzll(m);
        m &= m - 1;
        r += k - prev - 1;
        prev = k;
        while (r > 15 && k <= EOB) {
          S.emit();
          o.sym(0xF0, 0, 0);
          r -= 16;
          o.bits(cb, BR);
          cb = 0; BR = 0;
        }
        if (mag[k] > 1) {
          cb = cb << 1 | (mag[k] & 1);
          BR++;
          continue;
        }
        S.emit();
        o.sym((r << 4) + 1, blk[k] < 0 ? 0u : 1u, 1);   // the sign bit
        o.bits(cb, BR);
        cb = 0; BR = 0;
        r = 0;
      } while (m);
      r += Se - prev;
      if (r > 0 || BR > 0) {
        S.add_bits(cb, BR);
        S.add_block();
      }
    }
  }
  S.emit();
  if (walked) {
    walked[0] += (long)c.bw * c.bh;
    walked[1] += zero_blocks;
  }
  if (!gather) bw.flush();
  if (bw.overflow) return -1;
  return bw.pos;
}

template <bool refine>
long ac_scan(const CompPlane* comp, int Ss, int Se, int Al,
             int restart_interval, const uint32_t* ac_co,
             const uint8_t* ac_si, uint8_t* out, long cap,
             int64_t* ac_counts, int gather, int64_t* walked) {
  BitWriter bw; bw.init(out, cap);
  const CompPlane& c = *comp;
  if (gather) {
    ACOut<true> o{&bw, nullptr, nullptr, ac_counts + c.ac_tbl * 257};
    return ac_walk<true, refine>(c, Ss, Se, Al, restart_interval, o,
                                 walked);
  }
  ACOut<false> o{&bw, ac_co + c.ac_tbl * 256, ac_si + c.ac_tbl * 256,
               nullptr};
  return ac_walk<false, refine>(c, Ss, Se, Al, restart_interval, o,
                                walked);
}

}  // namespace

// Progressive AC first (Ah = 0) and refinement scans of one component.
// Returns the bytes written, -1 on buffer overflow or a missing code;
// gather != 0: only accumulate symbol counts. walked: null, or two int64
// counters the call adds to: the blocks walked and those whose band was
// all zero after the point transform.
extern "C" long mj_encode_ac_first(const CompPlane* comp,
                                   int Ss, int Se, int Al,
                                   int restart_interval,
                                   const uint32_t* ac_co,
                                   const uint8_t* ac_si,
                                   uint8_t* out, long cap,
                                   int64_t* ac_counts, int gather,
                                   int64_t* walked) {
  return ac_scan<false>(comp, Ss, Se, Al, restart_interval, ac_co, ac_si,
                        out, cap, ac_counts, gather, walked);
}

extern "C" long mj_encode_ac_refine(const CompPlane* comp,
                                    int Ss, int Se, int Al,
                                    int restart_interval,
                                    const uint32_t* ac_co,
                                    const uint8_t* ac_si,
                                    uint8_t* out, long cap,
                                    int64_t* ac_counts, int gather,
                                    int64_t* walked) {
  return ac_scan<true>(comp, Ss, Se, Al, restart_interval, ac_co, ac_si,
                       out, cap, ac_counts, gather, walked);
}

// ---------------------------------------------------------------------------
// AC-refinement flush schedule for the device bit-packer (ops/bitpack.py).
// The (eobrun, BE) state machine of jcphuff.c:817-918 is the one sequential
// recurrence in progressive packing; everything else vectorizes. Per block:
//   e[b]  - EOB-run contribution (block ends with pending zeros/bits)
//   br[b] - local correction bits left unflushed at block end
//   ev[b] - block has an emission event (a newly-nonzero coefficient)
// Segments of `restart` blocks are independent. Outputs per block:
//   flush_run[b]  - EOB run emitted at the block's start-flush lane (0=none)
//   flush_be[b]   - BE bits emitted there
//   forced_run[b] - run emitted at the block-end forced flush (0=none)
//   forced_be[b]  - BE bits emitted there
//   attach_blk[b] - block index whose flush consumes b's unflushed bits
//                   (negative-1 => segment-end flush lane)
//   attach_kind[b]- 0 start-flush lane, 1 forced lane, 2 segment end
//   attach_base[b]- rank offset of b's first bit inside that bucket
// and per segment: end_run[s], end_be[s].
extern "C" long mj_ac_refine_schedule(
    const int32_t* e, const int32_t* br, const int32_t* ev,
    long nblocks, long restart,
    int32_t* flush_run, int32_t* flush_be,
    int32_t* forced_run, int32_t* forced_be,
    int32_t* attach_blk, int32_t* attach_kind, int32_t* attach_base,
    int32_t* end_run, int32_t* end_be) {
  const long S = (nblocks + restart - 1) / restart;
  for (long s = 0; s < S; s++) {
    long b0 = s * restart;
    long b1 = b0 + restart < nblocks ? b0 + restart : nblocks;
    long eobrun = 0, BE = 0;
    long qstart = b0;  // first block whose bits are still queued
    for (long b = b0; b < b1; b++) {
      flush_run[b] = flush_be[b] = forced_run[b] = forced_be[b] = 0;
      attach_blk[b] = -1; attach_kind[b] = 2; attach_base[b] = 0;
      if (ev[b] && eobrun > 0) {           // start-of-block emit_eobrun
        flush_run[b] = (int32_t)eobrun;
        flush_be[b] = (int32_t)BE;
        long base = 0;
        for (long q = qstart; q < b; q++) {
          if (br[q]) { attach_blk[q] = (int32_t)b; attach_kind[q] = 0;
                       attach_base[q] = (int32_t)base; base += br[q]; }
        }
        eobrun = 0; BE = 0; qstart = b;
      }
      if (e[b]) {                           // block-end contribution
        eobrun++;
        BE += br[b];
        if (eobrun == 0x7FFF || BE > 937) { // forced emit_eobrun
          forced_run[b] = (int32_t)eobrun;
          forced_be[b] = (int32_t)BE;
          long base = 0;
          for (long q = qstart; q <= b; q++) {
            if (br[q] && attach_blk[q] < 0) {
              attach_blk[q] = (int32_t)b; attach_kind[q] = 1;
              attach_base[q] = (int32_t)base; base += br[q];
            }
          }
          eobrun = 0; BE = 0; qstart = b + 1;
        }
      }
    }
    end_run[s] = (int32_t)eobrun;           // segment-end emit_eobrun
    end_be[s] = (int32_t)BE;
    long base = 0;
    for (long q = qstart; q < b1; q++) {
      if (br[q] && attach_blk[q] < 0) {
        attach_kind[q] = 2; attach_base[q] = (int32_t)base; base += br[q];
      }
    }
  }
  return S;
}

// --------------------------------------------------------------------------
// Sparse coefficient expansion (ops/sparsepack.py): per-block 64-bit
// nonzero masks + superblock-compacted value stream -> dense zigzag
// planes. Popcount walk; returns nonzero on count mismatch.
// --------------------------------------------------------------------------
extern "C" long mj_sparse_expand(const uint32_t* masks, const int16_t* vals,
                                 const int32_t* sb_counts, long nblocks,
                                 int g, int cap_sb, int16_t* out) {
  const long S = nblocks / g;
  for (long s = 0; s < S; s++) {
    const int16_t* v = vals + s * cap_sb;
    long used = 0;
    for (int j = 0; j < g; j++) {
      long b = s * g + j;
      uint64_t m = (uint64_t)masks[b * 2] |
                   ((uint64_t)masks[b * 2 + 1] << 32);
      int16_t* o = out + b * 64;
      while (m) {
        int k = __builtin_ctzll(m);
        o[k] = v[used++];
        m &= m - 1;
      }
    }
    if (used != sb_counts[s]) return s + 1;
  }
  return 0;
}

// Exact-global variant (ops/sparsepack.py pack_planes_exact): values are
// concatenated in block order with no slack, one BYTE each (int8), with
// 0x80 marking an escape whose real int16 rides in the side stream.
// The caller downloads exactly the filled (bucketed) prefixes.  Returns
// nonzero if the masks demand more values than were provided.
extern "C" long mj_sparse_expand_flat(const uint32_t* masks,
                                      const uint8_t* lo,
                                      const int16_t* esc, long nblocks,
                                      long nlo, long nesc, int16_t* out) {
  long used = 0, eused = 0;
  for (long b = 0; b < nblocks; b++) {
    uint64_t m = (uint64_t)masks[b * 2] |
                 ((uint64_t)masks[b * 2 + 1] << 32);
    int16_t* o = out + b * 64;
    while (m) {
      int k = __builtin_ctzll(m);
      if (used >= nlo) return b + 1;
      uint8_t v = lo[used++];
      if (v == 0x80) {
        if (eused >= nesc) return b + 1;
        o[k] = esc[eused++];
      } else {
        o[k] = (int16_t)(int8_t)v;
      }
      m &= m - 1;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Device coefficient transport decode (ops/transport.py): an internal
// baseline-style Huffman stream packed ON DEVICE with the std luma
// tables — one independent word-aligned stream per image, MSB-first u32
// words, NO 0xFF stuffing, no markers.  Per block: DC delta (predictor
// resets per image, chains across component boundaries) then
// (run,size)+magnitude AC symbols with ZRL/EOB (jchuff.c F.1.2
// semantics).  Block order: components in order, raster blocks.
// Returns 0 on success, (image index + 1) on a malformed stream.
// ---------------------------------------------------------------------------

namespace {

struct WordReader {
  const uint32_t* w;
  long nwords;
  long pos = 0;       // next word
  uint64_t acc = 0;   // left-justified
  int nbits = 0;
  long consumed = 0;  // bits handed out
  bool bad = false;

  void init(const uint32_t* words, long n) {
    w = words;
    nwords = n;
    pos = 0;
    acc = 0;
    nbits = 0;
    consumed = 0;
    bad = false;
  }
  inline void fill() {
    while (nbits <= 32) {
      uint32_t v = (pos < nwords) ? w[pos] : 0;
      if (pos >= nwords) bad = true;
      pos++;
      acc |= (uint64_t)v << (32 - nbits);
      nbits += 32;
    }
  }
  inline int get(int n) {
    if (n == 0) return 0;
    if (nbits < n) fill();
    int v = (int)(acc >> (64 - n));
    acc <<= n;
    nbits -= n;
    consumed += n;
    return v;
  }
};

inline int transport_huff_decode(WordReader& br, const int32_t* mincode,
                                 const int64_t* maxcode,
                                 const int32_t* valptr,
                                 const uint8_t* vals) {
  int code = br.get(1);
  int l = 1;
  while (code > maxcode[l]) {
    code = (code << 1) | br.get(1);
    l++;
    if (l > 16) {
      br.bad = true;
      return 0;
    }
  }
  return vals[valptr[l] + (code - mincode[l])];
}

}  // namespace

extern "C" long mj_transport_decode(
    const uint32_t* words, long words_per_img, const int32_t* bits,
    int b, long n_img,
    const int32_t* dc_mincode, const int64_t* dc_maxcode,
    const int32_t* dc_valptr, const uint8_t* dc_vals,
    const int32_t* ac_mincode, const int64_t* ac_maxcode,
    const int32_t* ac_valptr, const uint8_t* ac_vals,
    int16_t* out /* (b*n_img, 64), zeroed */) {
  for (int i = 0; i < b; i++) {
    WordReader br;
    br.init(words + (long)i * words_per_img, words_per_img);
    int pred = 0;
    int16_t* base = out + (long)i * n_img * 64;
    for (long blk = 0; blk < n_img; blk++) {
      int16_t* o = base + blk * 64;
      int s = transport_huff_decode(br, dc_mincode, dc_maxcode,
                                    dc_valptr, dc_vals);
      if (s > 0) {
        int v = br.get(s);
        if (v < (1 << (s - 1))) v += ((-1) << s) + 1;
        pred += v;
      }
      o[0] = (int16_t)pred;
      int k = 1;
      while (k < 64) {
        int sym = transport_huff_decode(br, ac_mincode, ac_maxcode,
                                        ac_valptr, ac_vals);
        if (sym == 0) break;  // EOB
        int run = sym >> 4, size = sym & 15;
        if (size == 0) {
          if (run != 15) {
            br.bad = true;
            break;
          }
          k += 16;  // ZRL
          continue;
        }
        k += run;
        if (k > 63) {
          br.bad = true;
          break;
        }
        int v = br.get(size);
        if (v < (1 << (size - 1))) v += ((-1) << size) + 1;
        o[k] = (int16_t)v;
        k++;
      }
      if (br.bad) return i + 1;
    }
    if (br.consumed != bits[i]) return i + 1;
  }
  return 0;
}
