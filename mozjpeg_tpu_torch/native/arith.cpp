// Arithmetic (QM-coder) entropy codec — sequential + progressive.
//
// Fresh implementation of ITU-T T.81 Annex D/F/G arithmetic coding with
// libjpeg-compatible statistics layout and termination ("Pacman" shortest
// output). Parity references (semantics): /root/reference/jcarith.c,
// /root/reference/jdarith.c, /root/reference/jaricom.c.
//
// Also exports per-state rate tables (-log2 probability estimates in
// 1/256 bit units) for the arithmetic trellis (jget_arith_rates).

#include <cstdint>
#include <cstring>
#include <cmath>

// ITU-T T.81 Table D.3 probability estimation state machine
static const struct { uint16_t qe; uint8_t nl, nm, sw; } ARITAB[114] = {
  {0x5a1d,1,1,1}, {0x2586,14,2,0}, {0x1114,16,3,0}, {0x080b,18,4,0},
  {0x03d8,20,5,0}, {0x01da,23,6,0}, {0x00e5,25,7,0}, {0x006f,28,8,0},
  {0x0036,30,9,0}, {0x001a,33,10,0}, {0x000d,35,11,0}, {0x0006,9,12,0},
  {0x0003,10,13,0}, {0x0001,12,13,0}, {0x5a7f,15,15,1}, {0x3f25,36,16,0},
  {0x2cf2,38,17,0}, {0x207c,39,18,0}, {0x17b9,40,19,0}, {0x1182,42,20,0},
  {0x0cef,43,21,0}, {0x09a1,45,22,0}, {0x072f,46,23,0}, {0x055c,48,24,0},
  {0x0406,49,25,0}, {0x0303,51,26,0}, {0x0240,52,27,0}, {0x01b1,54,28,0},
  {0x0144,56,29,0}, {0x00f5,57,30,0}, {0x00b7,59,31,0}, {0x008a,60,32,0},
  {0x0068,62,33,0}, {0x004e,63,34,0}, {0x003b,32,35,0}, {0x002c,33,9,0},
  {0x5ae1,37,37,1}, {0x484c,64,38,0}, {0x3a0d,65,39,0}, {0x2ef1,67,40,0},
  {0x261f,68,41,0}, {0x1f33,69,42,0}, {0x19a8,70,43,0}, {0x1518,72,44,0},
  {0x1177,73,45,0}, {0x0e74,74,46,0}, {0x0bfb,75,47,0}, {0x09f8,77,48,0},
  {0x0861,78,49,0}, {0x0706,79,50,0}, {0x05cd,48,51,0}, {0x04de,50,52,0},
  {0x040f,50,53,0}, {0x0363,51,54,0}, {0x02d4,52,55,0}, {0x025c,53,56,0},
  {0x01f8,54,57,0}, {0x01a4,55,58,0}, {0x0160,56,59,0}, {0x0125,57,60,0},
  {0x00f6,58,61,0}, {0x00cb,59,62,0}, {0x00ab,61,63,0}, {0x008f,61,32,0},
  {0x5b12,65,65,1}, {0x4d04,80,66,0}, {0x412c,81,67,0}, {0x37d8,82,68,0},
  {0x2fe8,83,69,0}, {0x293c,84,70,0}, {0x2379,86,71,0}, {0x1edf,87,72,0},
  {0x1aa9,87,73,0}, {0x174e,72,74,0}, {0x1424,72,75,0}, {0x119c,74,76,0},
  {0x0f6b,74,77,0}, {0x0d51,75,78,0}, {0x0bb6,77,79,0}, {0x0a40,77,48,0},
  {0x5832,80,81,1}, {0x4d1c,88,82,0}, {0x438e,89,83,0}, {0x3bdd,90,84,0},
  {0x34ee,91,85,0}, {0x2eae,92,86,0}, {0x299a,93,87,0}, {0x2516,86,71,0},
  {0x5570,88,89,1}, {0x4ca9,95,90,0}, {0x44d9,96,91,0}, {0x3e22,97,92,0},
  {0x3824,99,93,0}, {0x32b4,99,94,0}, {0x2e17,93,86,0}, {0x56a8,95,96,1},
  {0x4f46,101,97,0}, {0x47e5,102,98,0}, {0x41cf,103,99,0}, {0x3c3d,104,100,0},
  {0x375e,99,93,0}, {0x5231,105,102,0}, {0x4c0f,106,103,0}, {0x4639,107,104,0},
  {0x415e,103,99,0}, {0x5627,105,106,1}, {0x50e7,108,107,0}, {0x4b85,109,103,0},
  {0x5597,110,109,0}, {0x504f,111,107,0}, {0x5a10,110,111,1}, {0x5522,112,109,0},
  {0x59eb,112,111,1}, {0x5a1d,113,113,0}
};

namespace {

struct CompPlaneA {
  int16_t* coef;   // (bh, stride, 64) zigzag order (mutable for decode)
  int32_t bw, bh, stride;
  int32_t h, v;
  int32_t dc_tbl, ac_tbl;
};

// natural order of zigzag index (for natural-order coefficient access the
// reference uses; our planes are zigzag so AC scans index directly)
struct ArithEnc {
  uint8_t* out;
  long cap, pos;
  bool overflow;
  int32_t c;       // JLONG 32-bit (sign matters only via masks)
  int32_t a;
  int sc, zc, ct;
  int buffer;
  uint8_t dc_stats[4][64];
  uint8_t ac_stats[4][256];
  uint8_t fixed_bin[4];
  int last_dc[16];
  int dc_context[16];

  void put(int val) {
    if (pos >= cap) { overflow = true; return; }
    out[pos++] = (uint8_t)val;
  }

  void init_state() {
    c = 0; a = 0x10000L; sc = 0; zc = 0; ct = 11; buffer = -1;
  }
  void reset_all(bool reset_dc, bool reset_ac) {
    if (reset_dc) {
      memset(dc_stats, 0, sizeof(dc_stats));
      memset(last_dc, 0, sizeof(last_dc));
      memset(dc_context, 0, sizeof(dc_context));
    }
    if (reset_ac) memset(ac_stats, 0, sizeof(ac_stats));
    memset(fixed_bin, 0, sizeof(fixed_bin));
    fixed_bin[0] = 113;   // non-adaptive 50% state (jcarith.c start_pass)
    init_state();
  }

  void encode(uint8_t* st, int val) {
    int sv = *st;
    const auto& t = ARITAB[sv & 0x7F];
    int32_t qe = t.qe;
    a -= qe;
    if (val != (sv >> 7)) {
      if (a >= qe) { c += a; a = qe; }
      *st = (uint8_t)((sv & 0x80) ^ (t.nl | (t.sw << 7)));
    } else {
      if (a >= 0x8000L) return;
      if (a < qe) { c += a; a = qe; }
      *st = (uint8_t)((sv & 0x80) ^ t.nm);
    }
    do {
      a <<= 1; c <<= 1;
      if (--ct == 0) {
        int32_t temp = (int32_t)(((uint32_t)c) >> 19);
        if (temp > 0xFF) {
          if (buffer >= 0) {
            if (zc) do put(0x00); while (--zc);
            put(buffer + 1);
            if (buffer + 1 == 0xFF) put(0x00);
          }
          zc += sc; sc = 0;
          buffer = temp & 0xFF;
        } else if (temp == 0xFF) {
          ++sc;
        } else {
          if (buffer == 0) ++zc;
          else if (buffer >= 0) {
            if (zc) do put(0x00); while (--zc);
            put(buffer);
          }
          if (sc) {
            if (zc) do put(0x00); while (--zc);
            do { put(0xFF); put(0x00); } while (--sc);
          }
          buffer = temp & 0xFF;
        }
        c &= 0x7FFFFL;
        ct += 8;
      }
    } while (a < 0x8000L);
  }

  // Section D.1.8 termination (matches jcarith.c finish_pass)
  void finish() {
    int32_t temp;
    if ((temp = (int32_t)((a - 1 + c) & 0xFFFF0000UL)) < c)
      c = temp + 0x8000L;
    else
      c = temp;
    c <<= ct;
    if ((uint32_t)c & 0xF8000000UL) {
      if (buffer >= 0) {
        if (zc) do put(0x00); while (--zc);
        put(buffer + 1);
        if (buffer + 1 == 0xFF) put(0x00);
      }
      zc += sc; sc = 0;
    } else {
      if (buffer == 0) ++zc;
      else if (buffer >= 0) {
        if (zc) do put(0x00); while (--zc);
        put(buffer);
      }
      if (sc) {
        if (zc) do put(0x00); while (--zc);
        do { put(0xFF); put(0x00); } while (--sc);
      }
    }
    if (c & 0x7FFF800L) {
      if (zc) do put(0x00); while (--zc);
      put((c >> 19) & 0xFF);
      if (((c >> 19) & 0xFF) == 0xFF) put(0x00);
      if (c & 0x7F800L) {
        put((c >> 11) & 0xFF);
        if (((c >> 11) & 0xFF) == 0xFF) put(0x00);
      }
    }
  }

  void restart(int n, bool dc, bool ac) {
    finish();
    put(0xFF);
    put(0xD0 + (n & 7));
    reset_all(dc, ac);
  }

  // DC coefficient (Figure F.4), value v_cur already point-transformed
  void encode_dc(int tbl, int ci, int v_cur, int dc_L, int dc_U) {
    uint8_t* st = dc_stats[tbl] + dc_context[ci];
    int v = v_cur - last_dc[ci];
    if (v == 0) {
      encode(st, 0);
      dc_context[ci] = 0;
    } else {
      last_dc[ci] = v_cur;
      encode(st, 1);
      if (v > 0) {
        encode(st + 1, 0);
        st += 2;
        dc_context[ci] = 4;
      } else {
        v = -v;
        encode(st + 1, 1);
        st += 3;
        dc_context[ci] = 8;
      }
      int m = 0;
      if ((v -= 1) != 0) {
        encode(st, 1);
        m = 1;
        int v2 = v;
        st = dc_stats[tbl] + 20;
        while (v2 >>= 1) { encode(st, 1); m <<= 1; st += 1; }
      }
      encode(st, 0);
      if (m < (int)((1L << dc_L) >> 1)) dc_context[ci] = 0;
      else if (m > (int)((1L << dc_U) >> 1)) dc_context[ci] += 8;
      st += 14;
      while (m >>= 1) encode(st, (m & v) ? 1 : 0);
    }
  }

  // AC run (Figures F.5-F.9) over zigzag band [ss..ke] with Al shift
  void encode_ac_band(int tbl, const int16_t* blk, int ss, int se, int al,
                      int ac_K) {
    int ke, v;
    for (ke = se; ke > 0; ke--) {
      v = blk[ke];
      if (v >= 0) { if (v >> al) break; }
      else { v = -v; if (v >> al) break; }
    }
    int k;
    for (k = ss; k <= ke; k++) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      encode(st, 0);  // EOB decision
      for (;;) {
        v = blk[k];
        if (v >= 0) { if ((v >>= al) != 0) break; }
        else { v = -v; if ((v >>= al) != 0) { v = -v; break; } }
        encode(st + 1, 0);  st += 3;  k++;
      }
      encode(st + 1, 1);
      if (v > 0) encode(fixed_bin, 0);
      else { v = -v; encode(fixed_bin, 1); }
      st += 2;
      int m = 0;
      if ((v -= 1) != 0) {
        encode(st, 1);
        m = 1;
        int v2 = v;
        if (v2 >>= 1) {
          encode(st, 1);
          m <<= 1;
          st = ac_stats[tbl] + (k <= ac_K ? 189 : 217);
          while (v2 >>= 1) { encode(st, 1); m <<= 1; st += 1; }
        }
      }
      encode(st, 0);
      st += 14;
      while (m >>= 1) encode(st, (m & v) ? 1 : 0);
    }
    if (k <= se) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      encode(st, 1);
    }
  }
};

struct ArithDec {
  const uint8_t* data;
  long len, pos;
  int unread_marker;
  int32_t c, a;
  int ct;
  uint8_t dc_stats[4][64];
  uint8_t ac_stats[4][256];
  uint8_t fixed_bin[4];
  int last_dc[16];
  int dc_context[16];
  bool bad;

  int get_byte() {
    if (pos >= len) return 0;
    return data[pos++];
  }

  void init_state() {
    c = 0; a = 0; ct = -16;
  }
  void reset_all(bool dc, bool ac) {
    if (dc) {
      memset(dc_stats, 0, sizeof(dc_stats));
      memset(last_dc, 0, sizeof(last_dc));
      memset(dc_context, 0, sizeof(dc_context));
    }
    if (ac) memset(ac_stats, 0, sizeof(ac_stats));
    memset(fixed_bin, 0, sizeof(fixed_bin));
    fixed_bin[0] = 113;   // non-adaptive 50% state (jdarith.c start_pass)
    init_state();
  }

  int decode(uint8_t* st) {
    while (a < 0x8000L) {
      if (--ct < 0) {
        int data_b;
        if (unread_marker) data_b = 0;
        else {
          data_b = get_byte();
          if (data_b == 0xFF) {
            do data_b = get_byte(); while (data_b == 0xFF);
            if (data_b == 0) data_b = 0xFF;
            else { unread_marker = data_b; data_b = 0; }
          }
        }
        c = (c << 8) | data_b;
        if ((ct += 8) < 0)
          if (++ct == 0)
            a = 0x8000L;
      }
      a <<= 1;
    }
    int sv = *st;
    const auto& t = ARITAB[sv & 0x7F];
    int32_t qe = t.qe;
    int32_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ t.nm);
      } else {
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ (t.nl | (t.sw << 7)));
        sv ^= 0x80;
      }
    } else if (a < 0x8000L) {
      if (a < qe) {
        *st = (uint8_t)((sv & 0x80) ^ (t.nl | (t.sw << 7)));
        sv ^= 0x80;
      } else {
        *st = (uint8_t)((sv & 0x80) ^ t.nm);
      }
    }
    return sv >> 7;
  }

  void process_restart(bool dc, bool ac, int /*n*/) {
    // consume the RSTn marker at the current byte position
    if (unread_marker >= 0xD0 && unread_marker <= 0xD7) {
      unread_marker = 0;
    } else {
      // scan forward for the marker, skipping 0xFF fill bytes
      // (T.81 B.1.1.2; jdmarker.c next_marker) and requiring RSTn
      while (pos + 1 < len) {
        if (data[pos] == 0xFF && data[pos + 1] != 0x00) {
          long q = pos + 1;
          while (q < len && data[q] == 0xFF) q++;  // FF fill
          if (q < len && data[q] >= 0xD0 && data[q] <= 0xD7) {
            pos = q + 1;
            break;
          }
          pos = q;        // non-RST marker: resync past it
          continue;
        }
        pos++;
      }
    }
    reset_all(dc, ac);
  }

  // -> DC value delta applied; returns new last_dc (not shifted)
  void decode_dc(int tbl, int ci, int dc_L, int dc_U) {
    uint8_t* st = dc_stats[tbl] + dc_context[ci];
    if (decode(st) == 0) {
      dc_context[ci] = 0;
    } else {
      int sign = decode(st + 1);
      st += 2; st += sign;
      int m = decode(st);
      if (m != 0) {
        st = dc_stats[tbl] + 20;
        while (decode(st)) {
          if ((m <<= 1) == 0x8000) { bad = true; return; }
          st += 1;
        }
      }
      if (m < (int)((1L << dc_L) >> 1)) dc_context[ci] = 0;
      else if (m > (int)((1L << dc_U) >> 1)) dc_context[ci] = 12 + (sign * 4);
      else dc_context[ci] = 4 + (sign * 4);
      int v = m;
      st += 14;
      while (m >>= 1)
        if (decode(st)) v |= m;
      v += 1; if (sign) v = -v;
      last_dc[ci] = (last_dc[ci] + v) & 0xffff;
    }
  }

  void decode_ac_band(int tbl, int16_t* blk, int ss, int se, int al,
                      int ac_K) {
    for (int k = ss; k <= se; k++) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (decode(st)) break;
      while (decode(st + 1) == 0) {
        st += 3; k++;
        if (k > se) { bad = true; return; }
      }
      int sign = decode(fixed_bin);
      st += 2;
      int m = decode(st);
      if (m != 0) {
        if (decode(st)) {
          m <<= 1;
          st = ac_stats[tbl] + (k <= ac_K ? 189 : 217);
          while (decode(st)) {
            if ((m <<= 1) == 0x8000) { bad = true; return; }
            st += 1;
          }
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (decode(st)) v |= m;
      v += 1; if (sign) v = -v;
      blk[k] = (int16_t)((unsigned)v << al);
    }
  }
};

}  // namespace

extern "C" {

// Sequential arithmetic encode (interleaved MCUs). Returns bytes or -1.
long mj_arith_encode_seq(const CompPlaneA* comps, int ncomp,
                         int mcus_x, int mcus_y, int restart_interval,
                         const uint8_t* dc_L, const uint8_t* dc_U,
                         const uint8_t* ac_K, uint8_t* out, long cap) {
  ArithEnc e;
  e.out = out; e.cap = cap; e.pos = 0; e.overflow = false;
  e.reset_all(true, true);
  int restarts_to_go = restart_interval;
  int next_restart = 0;

  for (int my = 0; my < mcus_y; my++) {
    for (int mx = 0; mx < mcus_x; mx++) {
      if (restart_interval && restarts_to_go == 0) {
        e.restart(next_restart, true, true);
        next_restart = (next_restart + 1) & 7;
        restarts_to_go = restart_interval;
      }
      for (int ci = 0; ci < ncomp; ci++) {
        const CompPlaneA& cp = comps[ci];
        for (int v = 0; v < cp.v; v++) {
          for (int h = 0; h < cp.h; h++) {
            long by = (long)my * cp.v + v;
            long bx = (long)mx * cp.h + h;
            const int16_t* blk = cp.coef + (by * cp.stride + bx) * 64;
            e.encode_dc(cp.dc_tbl, ci, blk[0], dc_L[cp.dc_tbl],
                        dc_U[cp.dc_tbl]);
            e.encode_ac_band(cp.ac_tbl, blk, 1, 63, 0, ac_K[cp.ac_tbl]);
          }
        }
      }
      if (restart_interval) restarts_to_go--;
    }
  }
  e.finish();
  if (e.overflow) return -1;
  return e.pos;
}

long mj_arith_decode_seq(const uint8_t* data, long len,
                         CompPlaneA* comps, int ncomp,
                         int mcus_x, int mcus_y, int restart_interval,
                         const uint8_t* dc_L, const uint8_t* dc_U,
                         const uint8_t* ac_K) {
  ArithDec d;
  d.data = data; d.len = len; d.pos = 0; d.unread_marker = 0; d.bad = false;
  d.reset_all(true, true);
  int restarts_to_go = restart_interval;

  for (int my = 0; my < mcus_y; my++) {
    for (int mx = 0; mx < mcus_x; mx++) {
      if (restart_interval && restarts_to_go == 0) {
        d.process_restart(true, true, 0);
        restarts_to_go = restart_interval;
      }
      for (int ci = 0; ci < ncomp; ci++) {
        CompPlaneA& cp = comps[ci];
        for (int v = 0; v < cp.v; v++) {
          for (int h = 0; h < cp.h; h++) {
            long by = (long)my * cp.v + v;
            long bx = (long)mx * cp.h + h;
            int16_t* blk = cp.coef + (by * cp.stride + bx) * 64;
            d.decode_dc(cp.dc_tbl, ci, dc_L[cp.dc_tbl], dc_U[cp.dc_tbl]);
            if (d.bad) return -1;
            blk[0] = (int16_t)d.last_dc[ci];
            d.decode_ac_band(cp.ac_tbl, blk, 1, 63, 0, ac_K[cp.ac_tbl]);
            if (d.bad) return -1;
          }
        }
      }
      if (restart_interval) restarts_to_go--;
    }
  }
  return d.pos;
}

// Progressive variants ------------------------------------------------------

long mj_arith_encode_dc_first(const CompPlaneA* comps, int ncomp,
                              int mcus_x, int mcus_y, int restart_interval,
                              int Al, const uint8_t* dc_L,
                              const uint8_t* dc_U, uint8_t* out, long cap) {
  ArithEnc e;
  e.out = out; e.cap = cap; e.pos = 0; e.overflow = false;
  e.reset_all(true, true);
  int restarts_to_go = restart_interval;
  int next_restart = 0;
  for (int my = 0; my < mcus_y; my++)
    for (int mx = 0; mx < mcus_x; mx++) {
      if (restart_interval && restarts_to_go == 0) {
        e.restart(next_restart, true, false);
        next_restart = (next_restart + 1) & 7;
        restarts_to_go = restart_interval;
      }
      for (int ci = 0; ci < ncomp; ci++) {
        const CompPlaneA& cp = comps[ci];
        for (int v = 0; v < cp.v; v++)
          for (int h = 0; h < cp.h; h++) {
            long by = (long)my * cp.v + v;
            long bx = (long)mx * cp.h + h;
            const int16_t* blk = cp.coef + (by * cp.stride + bx) * 64;
            int m = ((int)blk[0]) >> Al;
            e.encode_dc(cp.dc_tbl, ci, m, dc_L[cp.dc_tbl], dc_U[cp.dc_tbl]);
          }
      }
      if (restart_interval) restarts_to_go--;
    }
  e.finish();
  return e.overflow ? -1 : e.pos;
}

long mj_arith_encode_dc_refine(const CompPlaneA* comps, int ncomp,
                               int mcus_x, int mcus_y, int restart_interval,
                               int Al, uint8_t* out, long cap) {
  ArithEnc e;
  e.out = out; e.cap = cap; e.pos = 0; e.overflow = false;
  e.reset_all(true, true);
  int restarts_to_go = restart_interval;
  int next_restart = 0;
  for (int my = 0; my < mcus_y; my++)
    for (int mx = 0; mx < mcus_x; mx++) {
      if (restart_interval && restarts_to_go == 0) {
        e.restart(next_restart, false, false);
        next_restart = (next_restart + 1) & 7;
        restarts_to_go = restart_interval;
      }
      for (int ci = 0; ci < ncomp; ci++) {
        const CompPlaneA& cp = comps[ci];
        for (int v = 0; v < cp.v; v++)
          for (int h = 0; h < cp.h; h++) {
            long by = (long)my * cp.v + v;
            long bx = (long)mx * cp.h + h;
            const int16_t* blk = cp.coef + (by * cp.stride + bx) * 64;
            e.encode(e.fixed_bin, (((int)blk[0]) >> Al) & 1);
          }
      }
      if (restart_interval) restarts_to_go--;
    }
  e.finish();
  return e.overflow ? -1 : e.pos;
}

long mj_arith_encode_ac_first(const CompPlaneA* comp, int Ss, int Se, int Al,
                              int restart_interval, const uint8_t* ac_K,
                              uint8_t* out, long cap) {
  ArithEnc e;
  e.out = out; e.cap = cap; e.pos = 0; e.overflow = false;
  e.reset_all(true, true);
  const CompPlaneA& cp = *comp;
  int restarts_to_go = restart_interval;
  int next_restart = 0;
  for (long by = 0; by < cp.bh; by++)
    for (long bx = 0; bx < cp.bw; bx++) {
      if (restart_interval && restarts_to_go == 0) {
        e.restart(next_restart, false, true);
        next_restart = (next_restart + 1) & 7;
        restarts_to_go = restart_interval;
      }
      const int16_t* blk = cp.coef + (by * cp.stride + bx) * 64;
      e.encode_ac_band(cp.ac_tbl, blk, Ss, Se, Al, ac_K[cp.ac_tbl]);
      if (restart_interval) restarts_to_go--;
    }
  e.finish();
  return e.overflow ? -1 : e.pos;
}

long mj_arith_encode_ac_refine(const CompPlaneA* comp, int Ss, int Se,
                               int Al, int restart_interval,
                               uint8_t* out, long cap) {
  ArithEnc e;
  e.out = out; e.cap = cap; e.pos = 0; e.overflow = false;
  e.reset_all(true, true);
  const CompPlaneA& cp = *comp;
  int restarts_to_go = restart_interval;
  int next_restart = 0;
  int Ah = Al + 1;
  for (long by = 0; by < cp.bh; by++)
    for (long bx = 0; bx < cp.bw; bx++) {
      if (restart_interval && restarts_to_go == 0) {
        e.restart(next_restart, false, true);
        next_restart = (next_restart + 1) & 7;
        restarts_to_go = restart_interval;
      }
      const int16_t* blk = cp.coef + (by * cp.stride + bx) * 64;
      // Section G.1.3.3 (jcarith.c encode_mcu_AC_refine)
      int ke, kex, v;
      for (ke = Se; ke > 0; ke--) {
        v = blk[ke];
        if (v >= 0) { if (v >> Al) break; }
        else { v = -v; if (v >> Al) break; }
      }
      for (kex = ke; kex > 0; kex--) {
        v = blk[kex];
        if (v >= 0) { if (v >> Ah) break; }
        else { v = -v; if (v >> Ah) break; }
      }
      int k;
      for (k = Ss; k <= ke; k++) {
        uint8_t* st = e.ac_stats[cp.ac_tbl] + 3 * (k - 1);
        if (k > kex) e.encode(st, 0);
        for (;;) {
          v = blk[k];
          if (v >= 0) {
            if (v >>= Al) {
              if (v >> 1) e.encode(st + 2, (v & 1));
              else { e.encode(st + 1, 1); e.encode(e.fixed_bin, 0); }
              break;
            }
          } else {
            v = -v;
            if (v >>= Al) {
              if (v >> 1) e.encode(st + 2, (v & 1));
              else { e.encode(st + 1, 1); e.encode(e.fixed_bin, 1); }
              break;
            }
          }
          e.encode(st + 1, 0);  st += 3;  k++;
        }
      }
      if (k <= Se) {
        uint8_t* st = e.ac_stats[cp.ac_tbl] + 3 * (k - 1);
        e.encode(st, 1);
      }
      if (restart_interval) restarts_to_go--;
    }
  e.finish();
  return e.overflow ? -1 : e.pos;
}

long mj_arith_decode_dc_first(const uint8_t* data, long len,
                              CompPlaneA* comps, int ncomp,
                              int mcus_x, int mcus_y, int restart_interval,
                              int Al, const uint8_t* dc_L,
                              const uint8_t* dc_U) {
  ArithDec d;
  d.data = data; d.len = len; d.pos = 0; d.unread_marker = 0; d.bad = false;
  d.reset_all(true, true);
  int restarts_to_go = restart_interval;
  for (int my = 0; my < mcus_y; my++)
    for (int mx = 0; mx < mcus_x; mx++) {
      if (restart_interval && restarts_to_go == 0) {
        d.process_restart(true, false, 0);
        restarts_to_go = restart_interval;
      }
      for (int ci = 0; ci < ncomp; ci++) {
        CompPlaneA& cp = comps[ci];
        for (int v = 0; v < cp.v; v++)
          for (int h = 0; h < cp.h; h++) {
            long by = (long)my * cp.v + v;
            long bx = (long)mx * cp.h + h;
            int16_t* blk = cp.coef + (by * cp.stride + bx) * 64;
            d.decode_dc(cp.dc_tbl, ci, dc_L[cp.dc_tbl], dc_U[cp.dc_tbl]);
            if (d.bad) return -1;
            blk[0] = (int16_t)(d.last_dc[ci] << Al);
          }
      }
      if (restart_interval) restarts_to_go--;
    }
  return d.pos;
}

long mj_arith_decode_dc_refine(const uint8_t* data, long len,
                               CompPlaneA* comps, int ncomp,
                               int mcus_x, int mcus_y, int restart_interval,
                               int Al) {
  ArithDec d;
  d.data = data; d.len = len; d.pos = 0; d.unread_marker = 0; d.bad = false;
  d.reset_all(true, true);
  int restarts_to_go = restart_interval;
  int p1 = 1 << Al;
  for (int my = 0; my < mcus_y; my++)
    for (int mx = 0; mx < mcus_x; mx++) {
      if (restart_interval && restarts_to_go == 0) {
        d.process_restart(false, false, 0);
        restarts_to_go = restart_interval;
      }
      for (int ci = 0; ci < ncomp; ci++) {
        CompPlaneA& cp = comps[ci];
        for (int v = 0; v < cp.v; v++)
          for (int h = 0; h < cp.h; h++) {
            long by = (long)my * cp.v + v;
            long bx = (long)mx * cp.h + h;
            int16_t* blk = cp.coef + (by * cp.stride + bx) * 64;
            if (d.decode(d.fixed_bin)) blk[0] |= p1;
          }
      }
      if (restart_interval) restarts_to_go--;
    }
  return d.pos;
}

long mj_arith_decode_ac_first(const uint8_t* data, long len,
                              CompPlaneA* comp, int Ss, int Se, int Al,
                              int restart_interval, const uint8_t* ac_K) {
  ArithDec d;
  d.data = data; d.len = len; d.pos = 0; d.unread_marker = 0; d.bad = false;
  d.reset_all(true, true);
  CompPlaneA& cp = *comp;
  int restarts_to_go = restart_interval;
  for (long by = 0; by < cp.bh; by++)
    for (long bx = 0; bx < cp.bw; bx++) {
      if (restart_interval && restarts_to_go == 0) {
        d.process_restart(false, true, 0);
        restarts_to_go = restart_interval;
      }
      int16_t* blk = cp.coef + (by * cp.stride + bx) * 64;
      d.decode_ac_band(cp.ac_tbl, blk, Ss, Se, Al, ac_K[cp.ac_tbl]);
      if (d.bad) return -1;
      if (restart_interval) restarts_to_go--;
    }
  return d.pos;
}

long mj_arith_decode_ac_refine(const uint8_t* data, long len,
                               CompPlaneA* comp, int Ss, int Se, int Al,
                               int restart_interval) {
  ArithDec d;
  d.data = data; d.len = len; d.pos = 0; d.unread_marker = 0; d.bad = false;
  d.reset_all(true, true);
  CompPlaneA& cp = *comp;
  int restarts_to_go = restart_interval;
  int p1 = 1 << Al;
  int m1 = -(1 << Al);
  for (long by = 0; by < cp.bh; by++)
    for (long bx = 0; bx < cp.bw; bx++) {
      if (restart_interval && restarts_to_go == 0) {
        d.process_restart(false, true, 0);
        restarts_to_go = restart_interval;
      }
      int16_t* blk = cp.coef + (by * cp.stride + bx) * 64;
      int kex;
      for (kex = Se; kex > 0; kex--)
        if (blk[kex]) break;
      for (int k = Ss; k <= Se; k++) {
        uint8_t* st = d.ac_stats[cp.ac_tbl] + 3 * (k - 1);
        if (k > kex)
          if (d.decode(st)) break;
        for (;;) {
          int16_t* thiscoef = blk + k;
          if (*thiscoef) {
            if (d.decode(st + 2)) {
              if (*thiscoef < 0) *thiscoef += (int16_t)m1;
              else *thiscoef += (int16_t)p1;
            }
            break;
          }
          if (d.decode(st + 1)) {
            if (d.decode(d.fixed_bin)) *thiscoef = (int16_t)m1;
            else *thiscoef = (int16_t)p1;
            break;
          }
          st += 3; k++;
          if (k > Se) return -1;
        }
      }
      if (restart_interval) restarts_to_go--;
    }
  return d.pos;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Trellis support: a persistent single-component training context.  The
// reference's trellis passes run the adaptive coder over each quantized
// iMCU row with byte emission suppressed (jcarith.c:127-128) and snapshot
// -log2 probabilities from the evolving states before each row
// (jccoefct.c:384 jget_arith_rates).
// ---------------------------------------------------------------------------

extern "C" {

void* mj_arith_ctx_new() {
  ArithEnc* e = new ArithEnc();
  e->out = nullptr;
  e->cap = 0;            // put() becomes a no-op (emission suppressed)
  e->pos = 0;
  e->overflow = false;
  e->reset_all(true, true);
  return e;
}

void mj_arith_ctx_free(void* ctx) { delete (ArithEnc*)ctx; }

// restart boundary in the suppressed trellis re-encode (jcarith.c
// emit_restart): the re-encode runs in sequential mode (trellis_passes
// forces progressive_mode FALSE locally) but emit_restart tests the GLOBAL
// cinfo->progressive_mode with the pseudo-scan's Ss=1, so for progressive
// files only the AC statistics reset -- DC stats and predictions persist
// across restart boundaries during trellis passes.
void mj_arith_ctx_restart(void* ctx, int n, int reset_dc, int reset_ac) {
  ((ArithEnc*)ctx)->restart(n, reset_dc != 0, reset_ac != 0);
}

// rate_dc: 64*2 floats, rate_ac: 256*2 floats (jcarith.c:944-971 math)
void mj_arith_get_rates(void* ctx, float* rate_dc, float* rate_ac) {
  ArithEnc* e = (ArithEnc*)ctx;
  for (int i = 0; i < 64; i++) {
    int state = e->dc_stats[0][i];
    int mps_val = state >> 7;
    float prob_lps = (ARITAB[state & 0x7f].qe) / 46340.95;
    float prob_0 = mps_val ? prob_lps : 1.0 - prob_lps;
    float prob_1 = 1.0 - prob_0;
    rate_dc[2 * i + 0] = -log(prob_0) / log(2.0);
    rate_dc[2 * i + 1] = -log(prob_1) / log(2.0);
  }
  for (int i = 0; i < 256; i++) {
    int state = e->ac_stats[0][i];
    int mps_val = state >> 7;
    float prob_lps = (ARITAB[state & 0x7f].qe) / 46340.95;
    float prob_0 = mps_val ? prob_lps : 1.0 - prob_lps;
    float prob_1 = 1.0 - prob_0;
    rate_ac[2 * i + 0] = -log(prob_0) / log(2.0);
    rate_ac[2 * i + 1] = -log(prob_1) / log(2.0);
  }
}

// coefs: nblocks x 64 int16 zigzag blocks (a block row, raster order)
void mj_arith_train_rows(void* ctx, const int16_t* coefs, int nblocks,
                         int dc_L, int dc_U, int ac_K) {
  ArithEnc* e = (ArithEnc*)ctx;
  for (int b = 0; b < nblocks; b++) {
    const int16_t* blk = coefs + (long)b * 64;
    e->encode_dc(0, 0, blk[0], dc_L, dc_U);
    e->encode_ac_band(0, blk, 1, 63, 0, ac_K);
  }
}

}  // extern "C"
