// GIF LZW codec + Targa RLE decode for the cjpeg/djpeg file-format shims.
//
// Semantics mirror the reference readers/writers exactly:
//   decode: rdgif.c GetCode/LZWReadByte (incl. out-of-data zero padding,
//           bad-code recovery, deferred-clear handling)
//   encode: wrgif.c output/clear_block/compress (hash-probing LZW with
//           12-bit max codes and 255-byte packetization), plus the
//           uncompressed -gif0 variant (put_raw_pixel_rows)
//   targa:  rdtarga.c read_rle_pixel block/dup state machine
#include <cstdint>
#include <cstring>

namespace {

constexpr int MAX_LZW_BITS = 12;
constexpr int LZW_TABLE_SIZE = 1 << MAX_LZW_BITS;
constexpr int HSIZE = 5003;

// ---------------------------------------------------------------- decode
struct GifReader {
  const uint8_t* data;
  long len, pos;
  uint8_t code_buf[256 + 4];
  int last_byte, last_bit, cur_bit;
  bool first_time, out_of_blocks;
  int input_code_size, code_size, limit_code, max_code;
  int clear_code, end_code;
  int oldcode, firstcode;
  uint16_t symbol_head[LZW_TABLE_SIZE];
  uint8_t symbol_tail[LZW_TABLE_SIZE];
  uint8_t symbol_stack[LZW_TABLE_SIZE];
  uint8_t* sp;

  int get_data_block(uint8_t* buf) {
    if (pos >= len) return -1;
    int count = data[pos++];
    if (count > 0) {
      if (pos + count > len) return -1;
      memcpy(buf, data + pos, count);
      pos += count;
    }
    return count;
  }

  void reinit_lzw() {
    code_size = input_code_size + 1;
    limit_code = clear_code << 1;
    max_code = clear_code + 2;
    sp = symbol_stack;
  }

  void init(const uint8_t* d, long l, int ics) {
    data = d; len = l; pos = 0;
    last_byte = 2; code_buf[0] = code_buf[1] = 0;
    last_bit = 0; cur_bit = 0;
    first_time = true; out_of_blocks = false;
    input_code_size = ics;
    clear_code = 1 << ics;
    end_code = clear_code + 1;
    oldcode = firstcode = 0;
    reinit_lzw();
  }

  int get_code() {
    while (cur_bit + code_size > last_bit) {
      if (first_time) { first_time = false; return clear_code; }
      if (out_of_blocks) return end_code;
      code_buf[0] = code_buf[last_byte - 2];
      code_buf[1] = code_buf[last_byte - 1];
      int count = get_data_block(&code_buf[2]);
      if (count <= 0) { out_of_blocks = true; return end_code; }
      cur_bit = (cur_bit - last_bit) + 16;
      last_byte = 2 + count;
      last_bit = last_byte * 8;
    }
    int offs = cur_bit >> 3;
    int accum = code_buf[offs + 2];
    accum = (accum << 8) | code_buf[offs + 1];
    accum = (accum << 8) | code_buf[offs];
    accum >>= (cur_bit & 7);
    cur_bit += code_size;
    return accum & ((1 << code_size) - 1);
  }

  int read_byte_lzw() {
    if (sp > symbol_stack) return *(--sp);
    int code = get_code();
    if (code == clear_code) {
      reinit_lzw();
      do { code = get_code(); } while (code == clear_code);
      if (code > clear_code) code = 0;   // bad data recovery
      firstcode = oldcode = code;
      return code;
    }
    if (code == end_code) {
      if (!out_of_blocks) {
        uint8_t buf[256];
        while (get_data_block(buf) > 0) {}
        out_of_blocks = true;
      }
      return 0;                          // pad with zeros
    }
    int incode = code;
    if (code >= max_code) {
      if (code > max_code) incode = 0;   // bad data: prevent table loops
      *(sp++) = (uint8_t)firstcode;
      code = oldcode;
    }
    while (code >= clear_code) {
      *(sp++) = symbol_tail[code];
      code = symbol_head[code];
    }
    firstcode = code;
    if ((code = max_code) < LZW_TABLE_SIZE) {
      symbol_head[code] = (uint16_t)oldcode;
      symbol_tail[code] = (uint8_t)firstcode;
      max_code++;
      if (max_code >= limit_code && code_size < MAX_LZW_BITS) {
        code_size++;
        limit_code <<= 1;
      }
    }
    oldcode = incode;
    return firstcode;
  }
};

// ---------------------------------------------------------------- encode
struct GifWriter {
  uint8_t* out;
  long outcap, outlen;
  int n_bits, init_bits, maxcode;
  long cur_accum;
  int cur_bits;
  int ClearCode, EOFCode, free_code, code_counter;
  bool first_byte;
  int waiting_code;
  int bytesinpkt;
  uint8_t packetbuf[256];
  int16_t hash_code[HSIZE];
  int32_t hash_value[HSIZE];

  static int MAXCODE(int n) { return (1 << n) - 1; }

  void flush_packet() {
    if (bytesinpkt > 0) {
      packetbuf[0] = (uint8_t)bytesinpkt++;
      if (outlen + bytesinpkt <= outcap)
        memcpy(out + outlen, packetbuf, bytesinpkt);
      outlen += bytesinpkt;
      bytesinpkt = 0;
    }
  }
  void char_out(int c) {
    packetbuf[++bytesinpkt] = (uint8_t)c;
    if (bytesinpkt >= 255) flush_packet();
  }
  void output(int code) {
    cur_accum |= ((long)code) << cur_bits;
    cur_bits += n_bits;
    while (cur_bits >= 8) {
      char_out(cur_accum & 0xFF);
      cur_accum >>= 8;
      cur_bits -= 8;
    }
    if (free_code > maxcode) {
      n_bits++;
      maxcode = (n_bits == MAX_LZW_BITS) ? LZW_TABLE_SIZE : MAXCODE(n_bits);
    }
  }
  void clear_hash() { memset(hash_code, 0, sizeof(hash_code)); }
  void clear_block() {
    clear_hash();
    free_code = ClearCode + 2;
    output(ClearCode);
    n_bits = init_bits;
    maxcode = MAXCODE(n_bits);
  }
  void init(uint8_t* o, long cap, int i_bits) {
    out = o; outcap = cap; outlen = 0;
    n_bits = init_bits = i_bits;
    maxcode = MAXCODE(n_bits);
    ClearCode = 1 << (i_bits - 1);
    EOFCode = ClearCode + 1;
    code_counter = free_code = ClearCode + 2;
    first_byte = true;
    waiting_code = 0;
    bytesinpkt = 0;
    cur_accum = 0;
    cur_bits = 0;
    clear_hash();
    output(ClearCode);
  }
  void term() {
    if (!first_byte) output(waiting_code);
    output(EOFCode);
    if (cur_bits > 0) char_out(cur_accum & 0xFF);
    flush_packet();
  }
};

}  // namespace

extern "C" {

// Decode the LZW-compressed pixel stream (sequence of count-prefixed data
// blocks) into npixels bytes. Returns bytes of input consumed, or -1 if
// out has wrong size assumptions (never fails on bad data -- mirrors the
// reference's warn-and-recover behavior).
long mj_gif_lzw_decode(const uint8_t* data, long len, int input_code_size,
                       uint8_t* outpix, long npixels) {
  GifReader r;
  r.init(data, len, input_code_size);
  for (long i = 0; i < npixels; i++) outpix[i] = (uint8_t)r.read_byte_lzw();
  // skip to the block terminator if not already consumed
  if (!r.out_of_blocks) {
    uint8_t buf[256];
    while (r.get_data_block(buf) > 0) {}
  }
  return r.pos;
}

// Encode pixels with wrgif's LZW (lzw=1) or the raw -gif0 scheme (lzw=0).
// Output is the packetized stream WITHOUT the trailing zero terminator.
// Returns output length (may exceed outcap -- caller must re-call with a
// large enough buffer; bytes beyond outcap are dropped).
long mj_gif_lzw_encode(const uint8_t* pix, long n, int init_code_size,
                       int lzw, uint8_t* out, long outcap) {
  GifWriter w;
  w.init(out, outcap, init_code_size + 1);
  if (lzw) {
    for (long idx = 0; idx < n; idx++) {
      int c = pix[idx];
      if (w.first_byte) {
        w.waiting_code = c;
        w.first_byte = false;
        continue;
      }
      long i = ((long)c << (MAX_LZW_BITS - 8)) + w.waiting_code;
      if (i >= HSIZE) i -= HSIZE;
      int32_t probe = ((int32_t)w.waiting_code << 8) | c;
      if (w.hash_code[i] == 0) {
        w.output(w.waiting_code);
        if (w.free_code < LZW_TABLE_SIZE) {
          w.hash_code[i] = (int16_t)w.free_code++;
          w.hash_value[i] = probe;
        } else {
          w.clear_block();
        }
        w.waiting_code = c;
        continue;
      }
      if (w.hash_value[i] == probe) {
        w.waiting_code = w.hash_code[i];
        continue;
      }
      long disp = (i == 0) ? 1 : HSIZE - i;
      for (;;) {
        i -= disp;
        if (i < 0) i += HSIZE;
        if (w.hash_code[i] == 0) {
          w.output(w.waiting_code);
          if (w.free_code < LZW_TABLE_SIZE) {
            w.hash_code[i] = (int16_t)w.free_code++;
            w.hash_value[i] = probe;
          } else {
            w.clear_block();
          }
          w.waiting_code = c;
          break;
        }
        if (w.hash_value[i] == probe) {
          w.waiting_code = w.hash_code[i];
          break;
        }
      }
    }
  } else {
    // put_raw_pixel_rows: emit each pixel as a symbol, issuing Clear
    // codes to stop the decoder from ratcheting its code size
    for (long idx = 0; idx < n; idx++) {
      w.output(pix[idx]);
      if (w.code_counter < w.maxcode) {
        w.code_counter++;
      } else {
        w.output(w.ClearCode);
        w.code_counter = w.ClearCode + 2;
      }
    }
    w.first_byte = true;  // term() must not emit a waiting code
  }
  w.term();
  return w.outlen;
}

// Targa RLE decode: expand to npixels * pixel_size bytes.
// Returns input bytes consumed or -1 on premature end.
long mj_tga_rle_decode(const uint8_t* data, long len, int pixel_size,
                       uint8_t* out, long npixels) {
  long pos = 0;
  int block_count = 0, dup_count = 0;
  uint8_t pixel[4] = {0, 0, 0, 0};
  for (long i = 0; i < npixels; i++) {
    if (dup_count > 0) {
      dup_count--;
    } else {
      if (--block_count < 0) {
        if (pos >= len) return -1;
        int b = data[pos++];
        if (b & 0x80) {
          dup_count = b & 0x7F;
          block_count = 0;
        } else {
          block_count = b & 0x7F;
        }
      }
      if (pos + pixel_size > len) return -1;
      for (int k = 0; k < pixel_size; k++) pixel[k] = data[pos++];
    }
    memcpy(out + i * pixel_size, pixel, pixel_size);
  }
  return pos;
}

// PNG row unfiltering (ISO/IEC 15948 §9; reference reads PNG via libpng in
// rdpng.c — this is the equivalent raw-stream reconstruction).  `raw` is the
// zlib-inflated stream: nrows * (1 filter byte + rowbytes).  Reconstructed
// samples are written to `out` (nrows * rowbytes).  bpp = bytes per complete
// pixel (rounded up to 1 for sub-byte depths).  Returns 0, or -1 on a bad
// filter type.
int mj_png_unfilter(const uint8_t* raw, uint8_t* out, long nrows,
                    long rowbytes, int bpp) {
  const uint8_t* prev = nullptr;
  for (long y = 0; y < nrows; y++) {
    int ft = raw[y * (rowbytes + 1)];
    const uint8_t* in = raw + y * (rowbytes + 1) + 1;
    uint8_t* cur = out + y * rowbytes;
    switch (ft) {
      case 0:
        memcpy(cur, in, rowbytes);
        break;
      case 1:  // Sub
        for (long i = 0; i < bpp && i < rowbytes; i++) cur[i] = in[i];
        for (long i = bpp; i < rowbytes; i++)
          cur[i] = (uint8_t)(in[i] + cur[i - bpp]);
        break;
      case 2:  // Up
        if (prev)
          for (long i = 0; i < rowbytes; i++)
            cur[i] = (uint8_t)(in[i] + prev[i]);
        else
          memcpy(cur, in, rowbytes);
        break;
      case 3:  // Average
        for (long i = 0; i < rowbytes; i++) {
          int a = i >= bpp ? cur[i - bpp] : 0;
          int b = prev ? prev[i] : 0;
          cur[i] = (uint8_t)(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:  // Paeth
        for (long i = 0; i < rowbytes; i++) {
          int a = i >= bpp ? cur[i - bpp] : 0;
          int b = prev ? prev[i] : 0;
          int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          int p = a + b - c;
          int pa = p > a ? p - a : a - p;
          int pb = p > b ? p - b : b - p;
          int pc = p > c ? p - c : c - p;
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[i] = (uint8_t)(in[i] + pred);
        }
        break;
      default:
        return -1;
    }
    prev = cur;
  }
  return 0;
}

}  // extern "C"
