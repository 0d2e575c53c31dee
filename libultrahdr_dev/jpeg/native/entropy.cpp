// Baseline JPEG Huffman entropy codec (host side).
//
// The framework splits JPEG work: blockwise DCT/quantization runs on
// the accelerator (libultrahdr_dev/jpeg/dct.py); this file is the
// inherently sequential bit-level entropy stage, filling the role
// libjpeg-turbo's entropy coder plays for the reference
// (/root/reference/lib/src/jpegencoderhelper.cpp:226 jpeg_write_raw_data,
// /root/reference/lib/src/jpegdecoderhelper.cpp:422 jpeg_read_raw_data).
//
// Interface: flat arrays of 8x8 blocks in zigzag order, MCU-interleaved,
// with a component id per block. Python owns all marker/container work.
//
// Build: g++ -O2 -shared -fPIC entropy.cpp -o _entropy.so

#include <cstdint>
#include <cstring>

namespace {

struct HuffEncTable {
  uint16_t code[256];
  uint8_t size[256];
};

// Derive canonical codes from BITS (1-indexed, 16 entries) + HUFFVAL.
// ITU-T T.81 Annex C.
void build_enc_table(const uint8_t* bits17, const uint8_t* vals256,
                     HuffEncTable* t) {
  std::memset(t, 0, sizeof(*t));
  uint16_t code = 0;
  int k = 0;
  for (int len = 1; len <= 16; ++len) {
    for (int i = 0; i < bits17[len]; ++i) {
      uint8_t sym = vals256[k++];
      t->code[sym] = code;
      t->size[sym] = (uint8_t)len;
      ++code;
    }
    code <<= 1;
  }
}

struct BitWriter {
  uint8_t* out;
  long cap;
  long pos;
  uint64_t acc = 0;
  int nbits = 0;
  bool overflow = false;

  inline void put(uint32_t code, int len) {
    acc = (acc << len) | (code & ((1ull << len) - 1));
    nbits += len;
    while (nbits >= 8) {
      if (pos >= cap) { overflow = true; return; }
      uint8_t byte = (uint8_t)(acc >> (nbits - 8));
      out[pos++] = byte;
      if (byte == 0xFF) {
        if (pos >= cap) { overflow = true; return; }
        out[pos++] = 0x00;  // byte stuffing
      }
      nbits -= 8;
    }
  }

};

inline int bit_length(int v) {
  int n = 0;
  while (v) { ++n; v >>= 1; }
  return n;
}

struct HuffDecTable {
  // T.81 F.2.2.3 MINCODE/MAXCODE/VALPTR decode, plus an 8-bit fast LUT.
  int32_t mincode[17];
  int32_t maxcode[18];
  int32_t valptr[17];
  uint8_t vals[256];
  // fast path: index by next 8 bits -> (symbol | (len << 8)) or 0xFFFF
  uint16_t lut[256];
  // wide fast path: next 12 bits -> (symbol | (len << 8)) or 0xFFFF.
  // Annex-K AC tables put many common run/size symbols at 9-12 bits,
  // so the 8-bit window misses often on dense (high-quality) scans.
  uint16_t lut12[4096];
};

void build_dec_table(const uint8_t* bits17, const uint8_t* vals256,
                     HuffDecTable* t) {
  std::memcpy(t->vals, vals256, 256);
  int code = 0, k = 0;
  for (int len = 1; len <= 16; ++len) {
    if (bits17[len]) {
      t->valptr[len] = k;
      t->mincode[len] = code;
      k += bits17[len];
      code += bits17[len];
      t->maxcode[len] = code - 1;
    } else {
      t->mincode[len] = 0;
      t->maxcode[len] = -1;
    }
    code <<= 1;
  }
  t->maxcode[17] = 0x7FFFFFFF;
  for (int i = 0; i < 256; ++i) t->lut[i] = 0xFFFF;
  // Fill fast LUT for codes of length <= 8.
  code = 0; k = 0;
  for (int len = 1; len <= 8; ++len) {
    for (int i = 0; i < bits17[len]; ++i) {
      uint8_t sym = vals256[k++];
      int shift = 8 - len;
      int base = code << shift;
      for (int j = 0; j < (1 << shift); ++j)
        t->lut[base + j] = (uint16_t)(sym | (len << 8));
      ++code;
    }
    code <<= 1;
  }
  for (int i = 0; i < 4096; ++i) t->lut12[i] = 0xFFFF;
  code = 0; k = 0;
  for (int len = 1; len <= 12; ++len) {
    for (int i = 0; i < bits17[len]; ++i) {
      uint8_t sym = vals256[k++];
      int shift = 12 - len;
      int base = code << shift;
      for (int j = 0; j < (1 << shift); ++j)
        t->lut12[base + j] = (uint16_t)(sym | (len << 8));
      ++code;
    }
    code <<= 1;
  }
}

struct BitReader {
  const uint8_t* data;
  long len;
  long pos = 0;
  uint64_t acc = 0;
  int nbits = 0;
  bool error = false;
  bool hit_marker = false;

  // Refill up to >= 25 bits if possible.
  inline void refill() {
    // Fast path: pull 4 bytes at once when none is 0xFF (the common
    // case; stuffed/marker bytes take the byte loop below).
    while (nbits <= 32 && pos + 4 <= len) {
      uint32_t w;
      __builtin_memcpy(&w, data + pos, 4);
      uint32_t x = ~w;  // a 0xFF byte becomes 0x00
      if ((((x - 0x01010101u) & ~x) & 0x80808080u) != 0) break;
      acc = (acc << 32) | __builtin_bswap32(w);
      nbits += 32;
      pos += 4;
    }
    while (nbits <= 56 && pos < len) {
      uint8_t b = data[pos];
      if (b == 0xFF) {
        if (pos + 1 < len && data[pos + 1] == 0x00) {
          acc = (acc << 8) | 0xFF;
          nbits += 8;
          pos += 2;
          continue;
        }
        // real marker: stop feeding, pad with zeros
        hit_marker = true;
        break;
      }
      acc = (acc << 8) | b;
      nbits += 8;
      ++pos;
    }
  }

  inline uint32_t peek(int n) {
    if (nbits < n) refill();
    if (nbits < n) {
      // pad with zero bits (stream may legally end mid-code at EOB)
      return (uint32_t)((acc << (n - nbits)) & ((1u << n) - 1));
    }
    return (uint32_t)((acc >> (nbits - n)) & ((1u << n) - 1));
  }

  inline void skip(int n) {
    if (nbits < n) refill();
    if (nbits < n) { nbits = 0; error = true; return; }
    nbits -= n;
  }

  inline uint32_t get(int n) {
    uint32_t v = peek(n);
    skip(n);
    return v;
  }

  // Align to byte boundary and consume an RSTn marker if present
  // (any number of 0xFF fill bytes may precede it, T.81 B.1.1.2).
  inline bool sync_restart() {
    nbits = 0;
    acc = 0;
    while (pos + 1 < len && data[pos] == 0xFF && data[pos + 1] == 0xFF)
      ++pos;  // fill byte
    if (pos + 1 < len && data[pos] == 0xFF &&
        data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7) {
      pos += 2;
      hit_marker = false;
      return true;
    }
    return false;
  }
};

// ---------------------------------------------------------------------------
// Fast baseline decode path: destuff once, then a branch-light
// left-aligned 64-bit bit reader (one refill covers a full
// code+value pair, <= 31 bits). This fills the role of
// libjpeg-turbo's SIMD-assisted entropy decoder behind the
// reference's jpegdecoderhelper.cpp:422 for foreign (non-restart)
// streams that can't ride the lane-parallel device path.
// ---------------------------------------------------------------------------

// Remove 0xFF00 byte stuffing; split at RSTn markers. Returns the
// destuffed length; seg_starts[i] = destuffed offset where restart
// segment i begins (segment 0 starts at 0). out must have room for
// len + 64 bytes (tail is zero-padded for the wide loads).
static long destuff(const uint8_t* in, long len, uint8_t* out,
                    long* seg_starts, long max_segs, long* nsegs) {
  long o = 0;
  long s = 0;
  seg_starts[s++] = 0;
  long i = 0;
  while (i < len) {
    const uint8_t* ff = (const uint8_t*)memchr(in + i, 0xFF, len - i);
    if (!ff) {
      std::memcpy(out + o, in + i, len - i);
      o += len - i;
      break;
    }
    long n = ff - (in + i);
    std::memcpy(out + o, in + i, n);
    o += n;
    i += n;
    // in[i] == 0xFF
    if (i + 1 >= len) break;  // dangling FF at end: drop
    uint8_t m = in[i + 1];
    if (m == 0x00) {          // stuffed data byte
      out[o++] = 0xFF;
      i += 2;
    } else if (m == 0xFF) {   // fill byte
      ++i;
    } else if (m >= 0xD0 && m <= 0xD7) {  // restart marker
      if (s < max_segs) seg_starts[s++] = o;
      i += 2;
    } else {
      break;                  // real marker terminates entropy data
    }
  }
  std::memset(out + o, 0, 1024);
  *nsegs = s;
  return o;
}

struct FastReader {
  const uint8_t* start;
  const uint8_t* p;
  const uint8_t* pend;   // destuffed end (zero padding beyond)
  uint64_t bits = 0;     // left-aligned
  int cnt = 0;

  inline void reset(const uint8_t* base, const uint8_t* at,
                    const uint8_t* end) {
    start = base;
    p = at;
    pend = end;
    bits = 0;
    cnt = 0;
  }

  inline void refill() {
    // Safe: the buffer carries 1024 zero-pad bytes past pend. A
    // valid stream keeps p <= pend + 8 at block boundaries (the
    // register holds at most 63 look-ahead bits); one block's decode
    // advances p by at most ~256 bytes, so reads stay inside the
    // pad and the per-block overrun check bounds garbage decode.
    uint64_t w;
    __builtin_memcpy(&w, p, 8);
    bits |= __builtin_bswap64(w) >> cnt;
    int adv = (63 - cnt) >> 3;
    p += adv;
    cnt += adv << 3;
  }

  inline uint32_t peek(int n) const {
    return (uint32_t)(bits >> (64 - n));
  }

  inline void consume(int n) {
    bits <<= n;
    cnt -= n;
  }

  inline bool overrun() const { return p > pend + 64; }

  // Exact bits consumed since the last reset: p counts look-ahead
  // bytes pulled into the register, cnt the bits still unconsumed.
  inline long consumed_bits(const uint8_t* base) const {
    return (long)(p - base) * 8 - cnt;
  }
};

// Slow-path decode for codes longer than the 12-bit window; does NOT
// consume — returns the symbol and its length via *len_out so the
// caller can extract value bits from the same register window.
inline int fast_decode_slow(const FastReader& r, const HuffDecTable& t,
                            int* len_out) {
  int code = (int)r.peek(16);
  for (int len = 13; len <= 16; ++len) {
    int c = code >> (16 - len);
    if (c <= t.maxcode[len]) {
      *len_out = len;
      return t.vals[t.valptr[len] + (c - t.mincode[len])];
    }
  }
  return -1;
}

inline int decode_huff(BitReader& br, const HuffDecTable& t) {
  uint32_t look = br.peek(8);
  uint16_t hit = t.lut[look];
  if (hit != 0xFFFF) {
    br.skip(hit >> 8);
    return hit & 0xFF;
  }
  // slow path: lengths 9..16
  int code = (int)br.peek(16);
  for (int len = 9; len <= 16; ++len) {
    int c = code >> (16 - len);
    if (c <= t.maxcode[len]) {
      br.skip(len);
      return t.vals[t.valptr[len] + (c - t.mincode[len])];
    }
  }
  br.error = true;
  return 0;
}

// Extend: T.81 F.2.2.1 (receive/extend), branchless — the sign of a
// coefficient is coin-flip data, so the naive compare mispredicts on
// ~half of all nonzero coefficients.
inline int extend(int v, int size) {
  return v + (((v - (1 << (size - 1))) >> 31) & ((-1 << size) + 1));
}

}  // namespace

extern "C" {

// Encode MCU-interleaved zigzag blocks to entropy-coded bytes.
// blocks:      int16[nblocks][64], zigzag order
// comp_ids:    uint8[nblocks], component index per block (< ncomp)
// dc_sel/ac_sel: uint8[ncomp], huffman table slot per component (< 4)
// dc_bits/dc_vals: uint8[4][17] / uint8[4][256] table definitions
// restart_interval: MCUs between RSTn markers (0 = none)
// mcu_blocks:  blocks per MCU
// Returns bytes written, or -1 on overflow.
long uhdr_huff_encode(const int16_t* blocks, long nblocks,
                      const uint8_t* comp_ids, int ncomp,
                      const uint8_t* dc_sel, const uint8_t* ac_sel,
                      const uint8_t* dc_bits, const uint8_t* dc_vals,
                      const uint8_t* ac_bits, const uint8_t* ac_vals,
                      int restart_interval, int mcu_blocks,
                      uint8_t* out, long out_capacity) {
  HuffEncTable dct[4], act[4];
  for (int i = 0; i < 4; ++i) {
    build_enc_table(dc_bits + i * 17, dc_vals + i * 256, &dct[i]);
    build_enc_table(ac_bits + i * 17, ac_vals + i * 256, &act[i]);
  }
  BitWriter bw{out, out_capacity, 0};
  int pred[4] = {0, 0, 0, 0};
  long mcu_count = 0;
  int rst = 0;

  for (long b = 0; b < nblocks; ++b) {
    if (restart_interval && mcu_blocks && b % mcu_blocks == 0 &&
        mcu_count && mcu_count % restart_interval == 0) {
      // flush to byte boundary with 1-bits, then RSTn
      if (bw.nbits % 8) bw.put(0x7F, 8 - (bw.nbits % 8));
      if (bw.pos + 2 > bw.cap) return -1;
      bw.out[bw.pos++] = 0xFF;
      bw.out[bw.pos++] = (uint8_t)(0xD0 + rst);
      rst = (rst + 1) & 7;
      pred[0] = pred[1] = pred[2] = pred[3] = 0;
    }
    if (mcu_blocks && b % mcu_blocks == 0) ++mcu_count;

    int c = comp_ids[b];
    const HuffEncTable& dt = dct[dc_sel[c]];
    const HuffEncTable& at = act[ac_sel[c]];
    const int16_t* blk = blocks + b * 64;

    int dc = blk[0];
    int diff = dc - pred[c];
    pred[c] = dc;
    int adiff = diff < 0 ? -diff : diff;
    int size = bit_length(adiff);
    bw.put(dt.code[size], dt.size[size]);
    if (size) {
      int bitsv = diff < 0 ? diff + (1 << size) - 1 : diff;
      bw.put((uint32_t)bitsv, size);
    }

    int run = 0;
    for (int k = 1; k < 64; ++k) {
      int v = blk[k];
      if (v == 0) {
        ++run;
        continue;
      }
      while (run >= 16) {
        bw.put(at.code[0xF0], at.size[0xF0]);  // ZRL
        run -= 16;
      }
      int av = v < 0 ? -v : v;
      int s = bit_length(av);
      int sym = (run << 4) | s;
      bw.put(at.code[sym], at.size[sym]);
      int bitsv = v < 0 ? v + (1 << s) - 1 : v;
      bw.put((uint32_t)bitsv, s);
      run = 0;
    }
    if (run > 0) bw.put(at.code[0x00], at.size[0x00]);  // EOB
    if (bw.overflow) return -1;
  }
  if (bw.nbits % 8) bw.put(0x7F, 8 - (bw.nbits % 8));
  if (bw.overflow) return -1;
  return bw.pos;
}

// Decode entropy-coded bytes into MCU-interleaved zigzag blocks.
// Same table/layout conventions as the encoder. Returns 0 on success,
// negative on error.
long uhdr_huff_decode(const uint8_t* data, long len, long nblocks,
                      const uint8_t* comp_ids, int ncomp,
                      const uint8_t* dc_sel, const uint8_t* ac_sel,
                      const uint8_t* dc_bits, const uint8_t* dc_vals,
                      const uint8_t* ac_bits, const uint8_t* ac_vals,
                      int restart_interval, int mcu_blocks,
                      int16_t* out_blocks) {
  HuffDecTable dct[4], act[4];
  for (int i = 0; i < 4; ++i) {
    build_dec_table(dc_bits + i * 17, dc_vals + i * 256, &dct[i]);
    build_dec_table(ac_bits + i * 17, ac_vals + i * 256, &act[i]);
  }

  // Destuff + segment split once up front; the hot loop then runs a
  // branch-light wide reader with no stuffing/marker logic.
  long max_segs = restart_interval && mcu_blocks
                      ? (nblocks / mcu_blocks) / restart_interval + 2
                      : 2;
  uint8_t* flat = new uint8_t[(size_t)len + 1024];
  long* seg_starts = new long[max_segs];
  long nsegs = 0;
  long flat_len = destuff(data, len, flat, seg_starts, max_segs,
                          &nsegs);
  long seg = 0;

  FastReader r;
  r.reset(flat, flat, flat + flat_len);
  // A segment's decode must consume no more bits than the segment
  // holds — the old byte-serial reader errored on reads past the end
  // of data; the wide reader zero-feeds, so enforce the equivalent
  // bound explicitly at every segment boundary and at end of scan.
  const uint8_t* seg_base = flat;
  long seg_end = nsegs > 1 ? seg_starts[1] : flat_len;
  int pred[4] = {0, 0, 0, 0};
  long mcu_count = 0;
  long rc = 0;

  std::memset(out_blocks, 0, (size_t)nblocks * 64 * sizeof(int16_t));

  for (long b = 0; b < nblocks; ++b) {
    if (mcu_blocks && b % mcu_blocks == 0) {
      if (restart_interval && mcu_count &&
          mcu_count % restart_interval == 0) {
        {
          long used = r.consumed_bits(seg_base);
          long avail = (seg_end - (seg_base - flat)) * 8;
          // Valid segments leave only the <=7 pad bits unconsumed;
          // more means garbage decode, less means truncation.
          if (used > avail || used + 8 <= avail) { rc = -(b + 1); break; }
        }
        ++seg;
        if (seg >= nsegs) { rc = -(b + 1); break; }  // missing RSTn
        seg_base = flat + seg_starts[seg];
        seg_end = seg + 1 < nsegs ? seg_starts[seg + 1] : flat_len;
        r.reset(flat, seg_base, flat + flat_len);
        pred[0] = pred[1] = pred[2] = pred[3] = 0;
      }
      ++mcu_count;
    }
    if (r.overrun()) { rc = -(b + 1); break; }

    int c = comp_ids[b];
    const HuffDecTable& dt = dct[dc_sel[c]];
    const HuffDecTable& at = act[ac_sel[c]];
    int16_t* blk = out_blocks + b * 64;

    r.refill();
    // DC: symbol + value in one register window (dependent-chain
    // shortening: a single shift extracts the value bits behind the
    // code instead of consume-then-peek).
    {
      uint32_t look = r.peek(12);
      uint16_t hit = dt.lut12[look];
      int size, len;
      if (__builtin_expect(hit != 0xFFFF, 1)) {
        size = hit & 0xFF;
        len = hit >> 8;
      } else {
        size = fast_decode_slow(r, dt, &len);
        if (size < 0) { rc = -(b + 1); break; }
      }
      if (size) {
        int v = (int)((r.bits >> (64 - len - size))
                      & ((1u << size) - 1));
        pred[c] += extend(v, size);
        r.consume(len + size);
      } else {
        r.consume(len);
      }
    }
    blk[0] = (int16_t)pred[c];

    int k = 1;
    while (k < 64) {
      if (r.cnt < 32) r.refill();
      uint32_t look = r.peek(12);
      uint16_t hit = at.lut12[look];
      int sym, len;
      if (__builtin_expect(hit != 0xFFFF, 1)) {
        sym = hit & 0xFF;
        len = hit >> 8;
      } else {
        sym = fast_decode_slow(r, at, &len);
        if (sym < 0) { rc = -(b + 1); goto done; }
      }
      int run = sym >> 4, s = sym & 15;
      if (s == 0) {
        r.consume(len);
        if (run == 15) { k += 16; continue; }  // ZRL
        break;                                  // EOB
      }
      k += run;
      if (k > 63) { rc = -(b + 1); goto done; }
      int v = (int)((r.bits >> (64 - len - s)) & ((1u << s) - 1));
      blk[k] = (int16_t)extend(v, s);
      r.consume(len + s);
      ++k;
    }
  }
  if (rc == 0) {
    long used = r.consumed_bits(seg_base);
    long avail = (seg_end - (seg_base - flat)) * 8;
    if (used > avail || used + 8 <= avail) rc = -nblocks;
  }
done:
  delete[] flat;
  delete[] seg_starts;
  return rc;
}

// Lengths-only scan of a restart-less baseline stream: walk every
// codeword (skipping value bits, storing nothing) and record the bit
// offset of each r_mcus-aligned MCU boundary in DESTUFFED coordinates.
// This is the host half of the foreign-JPEG device decode: the
// offsets synthesize restart-style segments so the lane-parallel
// decoder (device_decode.py) can decode any baseline JPEG, with DC
// carry-ins fixed up on device. Walking lengths is ~2x cheaper than a
// full decode (no extend/store), and with one host core it is the
// only serial work left on this path.
//
// Outputs: out_destuffed (caller-allocated, len + 1024 bytes),
// out_bit_offsets[ceil(n_mcus/r_mcus)]. Returns the destuffed length,
// or a negative error (stream has restart markers / truncated / bad
// code).
long uhdr_huff_scan_offsets(const uint8_t* data, long len, long n_mcus,
                            const uint8_t* pattern, int mcu_blocks,
                            const uint8_t* dc_sel, const uint8_t* ac_sel,
                            const uint8_t* dc_bits, const uint8_t* dc_vals,
                            const uint8_t* ac_bits, const uint8_t* ac_vals,
                            int r_mcus, uint8_t* out_destuffed,
                            long* out_bit_offsets) {
  HuffDecTable dct[4], act[4];
  for (int i = 0; i < 4; ++i) {
    build_dec_table(dc_bits + i * 17, dc_vals + i * 256, &dct[i]);
    build_dec_table(ac_bits + i * 17, ac_vals + i * 256, &act[i]);
  }
  long seg_starts[2];
  long nsegs = 0;
  long flat_len = destuff(data, len, out_destuffed, seg_starts, 2,
                          &nsegs);
  if (nsegs != 1) return -2;  // restart markers present: not this path

  FastReader r;
  r.reset(out_destuffed, out_destuffed, out_destuffed + flat_len);
  long nseg_out = 0;
  for (long m = 0; m < n_mcus; ++m) {
    if (m % r_mcus == 0)
      out_bit_offsets[nseg_out++] = r.consumed_bits(out_destuffed);
    for (int bi = 0; bi < mcu_blocks; ++bi) {
      // Overrun check per BLOCK, not per MCU: one block consumes at
      // most ~27 + 63*26 bits ~= 210 bytes of lookahead, so a check
      // here bounds zero-fed decode well inside the 1024-byte destuff
      // pad (a 6-block 4:2:0 MCU checked only once per MCU could walk
      // ~1.25 KB past pend on a truncated/malicious stream).
      if (r.overrun()) return -1;
      int c = pattern[bi];
      const HuffDecTable& dt = dct[dc_sel[c]];
      const HuffDecTable& at = act[ac_sel[c]];
      r.refill();
      {
        uint32_t look = r.peek(12);
        uint16_t hit = dt.lut12[look];
        int size, lenb;
        if (__builtin_expect(hit != 0xFFFF, 1)) {
          size = hit & 0xFF;
          lenb = hit >> 8;
        } else {
          size = fast_decode_slow(r, dt, &lenb);
          if (size < 0) return -1;
        }
        r.consume(lenb + size);
      }
      int k = 1;
      while (k < 64) {
        if (r.cnt < 32) r.refill();
        uint32_t look = r.peek(12);
        uint16_t hit = at.lut12[look];
        int sym, lenb;
        if (__builtin_expect(hit != 0xFFFF, 1)) {
          sym = hit & 0xFF;
          lenb = hit >> 8;
        } else {
          sym = fast_decode_slow(r, at, &lenb);
          if (sym < 0) return -1;
        }
        int run = sym >> 4, s = sym & 15;
        if (s == 0) {
          r.consume(lenb);
          if (run == 15) { k += 16; continue; }  // ZRL
          break;                                  // EOB
        }
        k += run;
        if (k > 63) return -1;
        r.consume(lenb + s);
        ++k;
      }
    }
  }
  long used = r.consumed_bits(out_destuffed);
  long avail = flat_len * 8;
  if (used > avail || used + 8 <= avail) return -1;
  return flat_len;
}

// ---------------------------------------------------------------------------
// Progressive JPEG scan decoding (T.81 Annex G.2). Each scan refines a
// persistent coefficient buffer; Python orchestrates the scan sequence
// and owns the per-component grids.
// ---------------------------------------------------------------------------

// DC scan, first pass (Ah == 0): diffs scaled by 1 << Al.
// blocks are in scan order (interleaved MCU order when ncomp > 1).
long uhdr_prog_dc_first(const uint8_t* data, long len, long nblocks,
                        const uint8_t* comp_ids, int ncomp,
                        const uint8_t* dc_sel, const uint8_t* dc_bits,
                        const uint8_t* dc_vals, int al,
                        int restart_interval, int mcu_blocks,
                        int16_t* coefs /* (nblocks, 64) zigzag */) {
  HuffDecTable dct[4];
  for (int i = 0; i < 4; ++i)
    build_dec_table(dc_bits + i * 17, dc_vals + i * 256, &dct[i]);
  BitReader br{data, len};
  int pred[4] = {0, 0, 0, 0};
  long mcu_count = 0;
  for (long b = 0; b < nblocks; ++b) {
    if (restart_interval && mcu_blocks && b % mcu_blocks == 0 &&
        mcu_count && mcu_count % restart_interval == 0) {
      br.sync_restart();
      pred[0] = pred[1] = pred[2] = pred[3] = 0;
    }
    if (mcu_blocks && b % mcu_blocks == 0) ++mcu_count;
    int c = comp_ids[b];
    int size = decode_huff(br, dct[dc_sel[c]]);
    if (br.error) return -(b + 1);
    int diff = size ? extend((int)br.get(size), size) : 0;
    pred[c] += diff;
    coefs[b * 64] = (int16_t)(pred[c] << al);
  }
  return 0;
}

// DC refinement (Ah > 0): one appended bit per block.
long uhdr_prog_dc_refine(const uint8_t* data, long len, long nblocks,
                         int al, int restart_interval, int mcu_blocks,
                         int16_t* coefs) {
  BitReader br{data, len};
  long mcu_count = 0;
  for (long b = 0; b < nblocks; ++b) {
    if (restart_interval && mcu_blocks && b % mcu_blocks == 0 &&
        mcu_count && mcu_count % restart_interval == 0)
      br.sync_restart();
    if (mcu_blocks && b % mcu_blocks == 0) ++mcu_count;
    if (br.get(1)) coefs[b * 64] |= (int16_t)(1 << al);
    if (br.error) return -(b + 1);
  }
  return 0;
}

// AC scan, first pass (Ah == 0): run-length with EOB runs, single
// component, spectral band [ss, se], values scaled by 1 << Al.
long uhdr_prog_ac_first(const uint8_t* data, long len, long nblocks,
                        const uint8_t* ac_bits, const uint8_t* ac_vals,
                        int ss, int se, int al, int restart_interval,
                        int16_t* coefs) {
  HuffDecTable act;
  build_dec_table(ac_bits, ac_vals, &act);
  BitReader br{data, len};
  long eobrun = 0;
  for (long b = 0; b < nblocks; ++b) {
    if (restart_interval && b && b % restart_interval == 0) {
      br.sync_restart();
      eobrun = 0;
    }
    if (eobrun > 0) {
      --eobrun;
      continue;
    }
    int16_t* blk = coefs + b * 64;
    int k = ss;
    while (k <= se) {
      int sym = decode_huff(br, act);
      if (br.error) return -(b + 1);
      int r = sym >> 4, s = sym & 15;
      if (s == 0) {
        if (r == 15) { k += 16; continue; }  // ZRL
        eobrun = (1l << r) - 1;
        if (r) eobrun += br.get(r);
        break;  // EOB for this block
      }
      k += r;
      if (k > se) return -(b + 1);
      blk[k] = (int16_t)(extend((int)br.get(s), s) << al);
      ++k;
    }
  }
  return 0;
}

// AC refinement (Ah > 0): append a bit to already-nonzero
// coefficients, insert new +-(1 << Al) coefficients (T.81 G.2.2).
long uhdr_prog_ac_refine(const uint8_t* data, long len, long nblocks,
                         const uint8_t* ac_bits, const uint8_t* ac_vals,
                         int ss, int se, int al, int restart_interval,
                         int16_t* coefs) {
  HuffDecTable act;
  build_dec_table(ac_bits, ac_vals, &act);
  BitReader br{data, len};
  long eobrun = 0;
  const int16_t p1 = (int16_t)(1 << al);
  const int16_t m1 = (int16_t)(-(1 << al));

  for (long b = 0; b < nblocks; ++b) {
    if (restart_interval && b && b % restart_interval == 0) {
      br.sync_restart();
      eobrun = 0;
    }
    int16_t* blk = coefs + b * 64;
    int k = ss;
    if (eobrun == 0) {
      while (k <= se) {
        int sym = decode_huff(br, act);
        if (br.error) return -(b + 1);
        int r = sym >> 4, s = sym & 15;
        int16_t newval = 0;
        if (s == 0) {
          if (r != 15) {
            eobrun = (1l << r);
            if (r) eobrun += br.get(r);
            break;
          }
          // r == 15: skip 16 zero-history coefficients
        } else {
          // s must be 1; the new coefficient is +-1 << al
          newval = br.get(1) ? p1 : m1;
        }
        // advance over r zero-history coefficients, refining nonzero
        // ones along the way
        while (k <= se) {
          if (blk[k]) {
            if (br.get(1)) {
              if ((blk[k] & p1) == 0)
                blk[k] += (int16_t)(blk[k] >= 0 ? p1 : m1);
            }
          } else {
            if (r == 0) break;
            --r;
          }
          ++k;
        }
        if (newval && k <= se) blk[k] = newval;
        ++k;
        if (br.error) return -(b + 1);
      }
    }
    if (eobrun > 0) {
      // EOB run: still refine existing nonzero coefficients in band.
      while (k <= se) {
        if (blk[k]) {
          if (br.get(1)) {
            if ((blk[k] & p1) == 0)
              blk[k] += (int16_t)(blk[k] >= 0 ? p1 : m1);
          }
        }
        ++k;
      }
      --eobrun;
    }
    if (br.error) return -(b + 1);
  }
  return 0;
}

}  // extern "C"
