// Lossless JPEG (ITU-T T.81 process 14): predictors 1-7 + point transform
// + Huffman difference coding + restart intervals. Parity references
// (semantics): /root/reference/jclossls.c, jdlossls.c, jclhuff.c, jdlhuff.c.
//
// Scope: 1x1-sampled components (the standard lossless layout). Restart
// markers are emitted every restart_interval MCUs (jclhuff.c:333-337,
// emit_restart at :298) and the predictor resets to first-row mode via a
// per-component unsigned row counter rows_to_go = interval / MCUs_per_row
// (jclossls.c:73-77, reset_predictor :240); the decoder requires the
// interval to be a whole number of MCU rows (jddiffct.c:104-109).

#include <cstdint>
#include <cstring>

namespace {

struct BitW {
  uint8_t* out; long cap, pos; uint64_t acc; int nbits; bool ovf;
  void init(uint8_t* o, long c) { out = o; cap = c; pos = 0; acc = 0;
                                  nbits = 0; ovf = false; }
  inline void putb(uint8_t b) { if (pos >= cap) { ovf = true; return; }
                                out[pos++] = b; }
  inline void put(uint32_t code, int size) {
    acc |= (uint64_t)(code & ((1u << size) - 1)) << (64 - nbits - size);
    nbits += size;
    while (nbits >= 8) {
      uint8_t b = (uint8_t)(acc >> 56);
      putb(b);
      if (b == 0xFF) putb(0x00);
      acc <<= 8; nbits -= 8;
    }
  }
  void flush() {
    if (nbits > 0) {
      int pad = 8 - (nbits & 7);
      if (pad != 8) put(0x7F, pad);
      while (nbits >= 8) {
        uint8_t b = (uint8_t)(acc >> 56);
        putb(b);
        if (b == 0xFF) putb(0x00);
        acc <<= 8; nbits -= 8;
      }
    }
  }
};

struct BitR {
  const uint8_t* data; long len, pos; uint64_t acc; int nbits; bool marker;
  void init(const uint8_t* d, long l) { data = d; len = l; pos = 0; acc = 0;
                                        nbits = 0; marker = false; }
  inline void fill() {
    while (nbits <= 56) {
      if (marker || pos >= len) { nbits += 8; continue; }
      uint8_t b = data[pos];
      if (b == 0xFF) {
        if (pos + 1 < len && data[pos + 1] == 0x00) pos += 2;
        else { marker = true; nbits += 8; continue; }
      } else pos += 1;
      acc |= (uint64_t)b << (56 - nbits);
      nbits += 8;
    }
  }
  inline int get(int n) {
    if (n == 0) return 0;
    if (nbits < n) fill();
    int v = (int)(acc >> (64 - n));
    acc <<= n; nbits -= n;
    return v;
  }
};

static inline int predict(int pred_sel, int Ra, int Rb, int Rc) {
  switch (pred_sel) {
    case 1: return Ra;
    case 2: return Rb;
    case 3: return Rc;
    case 4: return Ra + Rb - Rc;
    case 5: return Ra + ((Rb - Rc) >> 1);
    case 6: return Rb + ((Ra - Rc) >> 1);
    case 7: return (Ra + Rb) >> 1;
  }
  return 0;
}

}  // namespace

extern "C" {

// planes: per comp uint16 (height, width) row-major, samples ALREADY point-
// transformed (>> Pt) by the caller.  Interleaved 1x1 MCU order.
// Emit (gather==0) or count (gather!=0, counts int64[4*257]).
// restart: markers every `restart` MCUs; predictor resets at row ends when
// the per-component row counter (restart / width, unsigned) runs out.
long mj_lossless_encode(const uint16_t* const* planes, int ncomp,
                        int width, int height, int pred_sel, int precision,
                        int Pt, const int32_t* dc_tbl_idx,
                        const uint32_t* ehufco, const uint8_t* ehufsi,
                        uint8_t* out, long cap, int64_t* counts,
                        int gather, unsigned restart) {
  BitW bw; bw.init(out, cap);
  const int initial = 1 << (precision - Pt - 1);
  const unsigned rows_per = restart ? restart / (unsigned)width : 0;
  unsigned rows_to_go[4];
  bool first_row[4];
  for (int ci = 0; ci < ncomp && ci < 4; ci++) {
    rows_to_go[ci] = rows_per;            // reset_predictor at start_pass
    first_row[ci] = true;
  }
  unsigned restarts_to_go = restart;      // jclhuff.c:204
  int next_rst = 0;

  for (int y = 0; y < height; y++) {
    for (int x = 0; x < width; x++) {
      if (restart && restarts_to_go == 0) {   // emit_restart jclhuff.c:335
        if (!gather) {
          bw.flush();
          bw.putb(0xFF);
          bw.putb((uint8_t)(0xD0 + next_rst));
        }
      }
      for (int ci = 0; ci < ncomp; ci++) {
        const uint16_t* p = planes[ci];
        int samp = p[(long)y * width + x];
        int pred;
        if (first_row[ci])
          pred = (x == 0) ? initial : p[(long)y * width + x - 1];  // 1-D
        else if (x == 0)
          pred = p[(long)(y - 1) * width];               // Rb
        else {
          int Ra = p[(long)y * width + x - 1];
          int Rb = p[(long)(y - 1) * width + x];
          int Rc = p[(long)(y - 1) * width + x - 1];
          pred = predict(pred_sel, Ra, Rb, Rc);
        }
        int temp = samp - pred;
        int temp2;
        if (temp & 0x8000) {
          temp = (-temp) & 0x7FFF;
          if (temp == 0) temp = 0x8000;
          temp2 = ~temp;
        } else {
          temp &= 0x7FFF;
          temp2 = temp;
        }
        int nbits = 0;
        int t = temp;
        while (t) { nbits++; t >>= 1; }
        int tbl = dc_tbl_idx[ci];
        if (gather) {
          counts[tbl * 257 + nbits]++;
        } else {
          bw.put(ehufco[tbl * 256 + nbits], ehufsi[tbl * 256 + nbits]);
          if (nbits && nbits != 16)
            bw.put((uint32_t)temp2, nbits);
        }
      }
      if (restart) {                      // jclhuff.c:400-406
        if (restarts_to_go == 0) {
          restarts_to_go = restart;
          next_rst = (next_rst + 1) & 7;
        }
        restarts_to_go--;
      }
    }
    if (restart) {                        // jclossls.c:73-77 row accounting
      for (int ci = 0; ci < ncomp && ci < 4; ci++) {
        if (--rows_to_go[ci] == 0) {      // unsigned: wraps when rows_per
          rows_to_go[ci] = rows_per;      // does not divide evenly
          first_row[ci] = true;
        } else {
          first_row[ci] = false;
        }
      }
    } else {
      for (int ci = 0; ci < ncomp && ci < 4; ci++) first_row[ci] = false;
    }
  }
  if (!gather) bw.flush();
  return bw.ovf ? -1 : bw.pos;
}

// Decode into planes (point-transformed domain; caller applies << Pt).
// restart: the decoder requires the interval to be a whole number of MCU
// rows (jddiffct.c:104-109 errors otherwise); returns -2 if not.
long mj_lossless_decode(const uint8_t* data, long len,
                        uint16_t* const* planes, int ncomp,
                        int width, int height, int pred_sel, int precision,
                        int Pt, const int32_t* dc_tbl_idx,
                        const int32_t* mincode, const int64_t* maxcode,
                        const int32_t* valptr, const uint8_t* vals,
                        unsigned restart) {
  BitR br; br.init(data, len);
  const int initial = 1 << (precision - Pt - 1);
  if (restart && restart % (unsigned)width != 0) return -2;
  const unsigned rows_per = restart ? restart / (unsigned)width : 0;
  unsigned rows_since = 0;
  bool first_row = true;

  for (int y = 0; y < height; y++) {
    if (restart && y > 0 && rows_since == rows_per) {
      // process_restart (jdlhuff.c:166): drop pad bits, eat the RSTn
      // marker, reset the predictors to first-row mode
      br.acc = 0; br.nbits = 0; br.marker = false;
      if (br.pos + 1 >= len || data[br.pos] != 0xFF ||
          data[br.pos + 1] < 0xD0 || data[br.pos + 1] > 0xD7)
        return -1;
      br.pos += 2;
      rows_since = 0;
      first_row = true;
    }
    for (int x = 0; x < width; x++) {
      for (int ci = 0; ci < ncomp; ci++) {
        uint16_t* p = planes[ci];
        int tbl = dc_tbl_idx[ci];
        const int64_t* mx = maxcode + tbl * 18;
        const int32_t* mn = mincode + tbl * 17;
        const int32_t* vp = valptr + tbl * 17;
        const uint8_t* vl = vals + tbl * 256;
        int code = br.get(1);
        int l = 1;
        while (code > mx[l]) {
          code = (code << 1) | br.get(1);
          if (++l > 16) return -1;
        }
        int s = vl[vp[l] + (code - mn[l])];
        int diff;
        if (s == 0) diff = 0;
        else if (s == 16) diff = 32768;
        else {
          int v = br.get(s);
          diff = (v < (1 << (s - 1))) ? v - (1 << s) + 1 : v;
        }
        int pred;
        if (first_row)
          pred = (x == 0) ? initial : p[(long)y * width + x - 1];
        else if (x == 0)
          pred = p[(long)(y - 1) * width];
        else {
          int Ra = p[(long)y * width + x - 1];
          int Rb = p[(long)(y - 1) * width + x];
          int Rc = p[(long)(y - 1) * width + x - 1];
          pred = predict(pred_sel, Ra, Rb, Rc);
        }
        p[(long)y * width + x] = (uint16_t)((pred + diff) & 0xFFFF);
      }
    }
    first_row = false;
    rows_since++;
  }
  return br.pos;
}

}  // extern "C"
