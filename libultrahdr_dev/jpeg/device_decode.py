"""JPEG Huffman entropy DECODING on the device for restart-interval
streams.

The host/CPU formulation (native/entropy.cpp, mirroring what the
reference delegates to libjpeg's serial bit-reader,
/root/reference/lib/src/jpegdecoderhelper.cpp:422) walks the bitstream
one codeword at a time. That serial decode forces ~36 MB of decoded
coefficients from host to device per 4K frame. This module
decodes ON the device instead, so only the ~1.5 MB entropy-coded bytes
are uploaded.

Key idea: streams this framework encodes carry restart markers every
R MCUs (device_entropy.py). Each restart interval is byte-aligned,
DC-prediction-reset and independent — so a 4K frame is ~12k intervals
that decode in parallel lanes. Decoding within an interval is
bit-serial, expressed as one jax.lax.while_loop whose body decodes one
codeword per lane per step:

  - the bitstream is pre-expanded (vectorized, once) into a
    nibble-indexed window table W[(lane, n)] = 32 stream bits starting
    at nibble n, so any bit position needs only ONE indexed read, and
    a left shift of <=3 exposes >=29 valid bits (max codeword+extra is
    16+11 = 27 for DC, 16+10 = 26 for AC);
  - all per-lane indexed reads/writes use compare+select against an
    iota instead of gather/scatter (dense elementwise work; whether a
    plain gather is faster on the GPU is an open measurement);
  - canonical Huffman decode is a select chain over the table's
    left-aligned code boundaries (sorted ascending by construction),
    evaluating luma+chroma variants with per-entry constant selects.

Lanes that finish their interval (block count reached) freeze; the
loop ends when every lane is done. Output is the dense per-interval
coefficient array, reshaped to per-component block grids by static
transposes — ready to fuse with dequant/IDCT and the gain-map apply in
a single jit.

Any baseline JPEG with restart intervals takes this path — the select
chains are built from the file's own DHT definitions (kernel compiles
cache per table set; everything this framework encodes shares the
Annex-K set). Foreign files without restart markers fall back to the
host decoder.
"""

from __future__ import annotations

import os
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import counters
from . import tables
from .device_entropy import _build_code_table

# ---------------------------------------------------------------------------
# Decode chain constants: canonical left-aligned code boundaries.
# ---------------------------------------------------------------------------


def _chain_consts(bits, vals):
    """Per-symbol (boundary, packed) arrays, ascending by boundary.

    boundary = first 16-bit left-aligned codeword value for the symbol;
    packed = (symbol << 5) | code_length. A peek16 maps to the LAST
    entry whose boundary is <= peek16 (canonical codes partition the
    code space in ascending order).
    """
    code, size = _build_code_table(bits, vals)
    entries = []
    for sym in range(256):
        if size[sym]:
            left = int(code[sym]) << (16 - int(size[sym]))
            entries.append((left, (sym << 5) | int(size[sym])))
    entries.sort()
    bnd = np.asarray([e[0] for e in entries], np.uint32)
    pck = np.asarray([e[1] for e in entries], np.uint32)
    return bnd, pck


_DC_L = _chain_consts(tables.DC_LUMA_BITS, tables.DC_LUMA_VALS)
_AC_L = _chain_consts(tables.AC_LUMA_BITS, tables.AC_LUMA_VALS)
_DC_C = _chain_consts(tables.DC_CHROMA_BITS, tables.DC_CHROMA_VALS)
_AC_C = _chain_consts(tables.AC_CHROMA_BITS, tables.AC_CHROMA_VALS)
_ANNEX_K_CHAINS = (_DC_L, _AC_L, _DC_C, _AC_C)


def serialize_tables(dc_l, ac_l, dc_c=None, ac_c=None) -> bytes:
    """Hashable kernel-cache key for a set of (bits, vals) specs.
    Value counts are 2 bytes: a legal DHT may carry exactly 256 values
    (sum(bits) == 256), which a single length byte cannot hold."""
    out = bytearray()
    for t in (dc_l, ac_l, dc_c or dc_l, ac_c or ac_l):
        out += bytes(t[0]) + len(t[1]).to_bytes(2, "big") + bytes(t[1])
    return bytes(out)


def chains_from_key(tkey: bytes):
    """Inverse of serialize_tables -> 4 chain-constant tuples."""
    out = []
    pos = 0
    for _ in range(4):
        bits = list(tkey[pos:pos + 16])
        pos += 16
        n = int.from_bytes(tkey[pos:pos + 2], "big")
        pos += 2
        vals = list(tkey[pos:pos + n])
        pos += n
        out.append(_chain_consts(bits, vals))
    return tuple(out)


def min_code_len_from_key(tkey: bytes | None) -> int:
    """Shortest codeword length across the key's four tables (2 for
    the Annex-K default tables). Bounds the per-unit bit cost for the
    decode loop's step cap."""
    if not tkey:
        return 2
    m = 16
    pos = 0
    for _ in range(4):
        bits = tkey[pos:pos + 16]
        n = int.from_bytes(tkey[pos + 16:pos + 18], "big")
        pos += 18 + n
        for length, count in enumerate(bits, 1):
            if count:
                m = min(m, length)
                break
    return max(m, 1)


def _pad_chain_pair(a, b):
    """Equalize two chains' lengths with unreachable sentinel entries
    (boundary > any 16-bit peek) so the fused luma/chroma select chain
    can zip them."""
    la, lb = len(a[0]), len(b[0])
    n = max(la, lb)

    def pad(c, ln):
        if ln == n:
            return c
        bnd = np.concatenate([c[0], np.full(n - ln, 0x1FFFF, np.uint32)])
        pck = np.concatenate([c[1], np.zeros(n - ln, np.uint32)])
        return bnd, pck

    return pad(a, la), pad(b, lb)


def _eval_chain(peek16, consts):
    """Single-table canonical decode: select chain over boundaries.
    Returns packed (sym << 5 | len) u32."""
    bnd, pck = consts
    out = jnp.full(peek16.shape, np.uint32(pck[0]))
    for i in range(1, len(bnd)):
        out = jnp.where(peek16 >= np.uint32(bnd[i]), np.uint32(pck[i]),
                        out)
    return out


def _eval_chain_pair(peek16, luma_consts, chroma_consts, is_luma):
    """Two tables (luma/chroma) fused into one chain with per-entry
    constant selects; unequal lengths are sentinel-padded."""
    luma_consts, chroma_consts = _pad_chain_pair(luma_consts,
                                                 chroma_consts)
    bl, pl = luma_consts
    bc, pc = chroma_consts
    out = jnp.where(is_luma, np.uint32(pl[0]), np.uint32(pc[0]))
    for i in range(1, len(bl)):
        b = jnp.where(is_luma, np.uint32(bl[i]), np.uint32(bc[i]))
        p = jnp.where(is_luma, np.uint32(pl[i]), np.uint32(pc[i]))
        out = jnp.where(peek16 >= b, p, out)
    return out


# ---------------------------------------------------------------------------
# Host prep: destuff + split the entropy segment at restart markers.
# ---------------------------------------------------------------------------

_LEN_BUCKETS = (48, 64, 96, 128, 192, 256, 384, 512, 768, 1024, 1536,
                2048, 3072, 4096, 6144, 8192)


def _bucket_len(n: int) -> int:
    for b in _LEN_BUCKETS:
        if n <= b:
            return b
    return -(-n // 8192) * 8192


def split_rst_stream(entropy: bytes, n_chunks: int):
    """Destuff and split an entropy-coded segment with RSTn markers
    into an (n_chunks, L) u8 matrix (L bucketed for compile reuse).

    The segment must contain only entropy data + RST markers (ending
    before EOI). Returns the padded chunk matrix.
    """
    arr = np.frombuffer(entropy, np.uint8)
    if arr.size == 0:
        raise ValueError("empty entropy segment")
    # 0xFF bytes are rare (~1%): classify only those instead of running
    # full-array prev/next compares.
    ff = np.flatnonzero(arr == 0xFF)
    ff = ff[ff + 1 < arr.size]
    nxt = arr[ff + 1]
    rst_ff = ff[(nxt >= 0xD0) & (nxt <= 0xD7)]
    stuff = ff[nxt == 0x00] + 1
    n_found = rst_ff.size + 1
    if n_found != n_chunks:
        raise ValueError(
            f"expected {n_chunks} restart intervals, found {n_found}")
    keep = np.ones(arr.size, bool)
    keep[rst_ff] = False
    keep[rst_ff + 1] = False
    keep[stuff] = False
    data = arr[keep]
    # Chunk k (destuffed) spans raw [rst_ff[k-1]+2, rst_ff[k]) minus
    # the stuffed zeros inside that range.
    raw_starts = np.concatenate([[0], rst_ff + 2])
    raw_ends = np.concatenate([rst_ff, [arr.size]])
    stuff_before_start = np.searchsorted(stuff, raw_starts)
    stuff_before_end = np.searchsorted(stuff, raw_ends)
    lens = ((raw_ends - raw_starts)
            - (stuff_before_end - stuff_before_start))
    if np.any(lens < 0):
        raise ValueError("marker structure corrupt")
    L = _bucket_len(int(lens.max()))
    starts = np.concatenate([[0], np.cumsum(lens)])[:-1]
    if data.size + L >= 2**31:
        # int32 gather indices would wrap; no legal 8192^2 image
        # needs a 2 GiB entropy segment (only crafted fill-padding).
        raise ValueError("entropy segment too large")
    # The per-lane L-byte windows are gathered ON DEVICE from this
    # contiguous destuffed buffer (one row-gather inside the fused
    # decode kernel): uploading dest + starts ships ~2x fewer bytes
    # than the padded window matrix. Bytes past a lane's own interval
    # (the next interval's data) are never consumed — each lane stops
    # after its target MCU count; the reader may prefetch them as
    # lookahead only.
    return data, starts.astype(np.int32), L


def scan_foreign_stream(entropy: bytes, n_mcus: int, gray: bool,
                        specs, r_mcus: int,
                        sampling: tuple = (2, 2)):
    """Synthesize device-decodable segments for a RESTART-LESS
    baseline stream: a native lengths-only scan (entropy.cpp
    uhdr_huff_scan_offsets) walks every codeword once and records the
    exact bit offset of each r_mcus-aligned MCU boundary, so the
    lane-parallel device decoder can run one lane per boundary (with
    dc_carry=True fixing up the shared DC-prediction chain on device).
    This is the single remaining serial host step for foreign JPEGs —
    the role libjpeg-turbo's entropy decoder plays behind the
    reference's jpegdecoderhelper.cpp:422, at ~half the work of a full
    host decode.

    specs: (dc_luma, ac_luma, dc_chroma, ac_chroma) (bits, vals)
    table definitions (chroma pair None for grayscale).
    Returns (chunks_u8, start_bits_i32) or None when the scan fails
    (native codec unavailable, corrupt stream, restart markers).
    """
    from . import native, tables as tb

    lib = native.get_lib()
    if lib is None:
        return None
    if getattr(lib, "uhdr_huff_scan_offsets", None) is None:
        return None
    import ctypes

    def u8p(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

    dcb = np.zeros((4, 17), np.uint8)
    dcv = np.zeros((4, 256), np.uint8)
    acb = np.zeros((4, 17), np.uint8)
    acv = np.zeros((4, 256), np.uint8)
    dcb[0], dcv[0] = tb.pack_huff_table(*specs[0])
    acb[0], acv[0] = tb.pack_huff_table(*specs[1])
    if not gray:
        dcb[1], dcv[1] = tb.pack_huff_table(*specs[2])
        acb[1], acv[1] = tb.pack_huff_table(*specs[3])
    if gray:
        pattern = np.zeros(1, np.uint8)
        sel = np.zeros(1, np.uint8)
    else:
        ypm = sampling[0] * sampling[1]
        pattern = np.array([0] * ypm + [1, 2], np.uint8)
        sel = np.array([0, 1, 1], np.uint8)
    mcu_blocks = len(pattern)

    data = np.frombuffer(entropy, np.uint8)
    dest = np.empty(data.size + 1024, np.uint8)
    n_segs = -(-n_mcus // r_mcus)
    offs = np.zeros(n_segs + 1, np.int64)
    rc = lib.uhdr_huff_scan_offsets(
        u8p(data), data.size, n_mcus, u8p(pattern), mcu_blocks,
        u8p(sel), u8p(sel), u8p(dcb.reshape(-1)), u8p(dcv.reshape(-1)),
        u8p(acb.reshape(-1)), u8p(acv.reshape(-1)), r_mcus, u8p(dest),
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_long)))
    if rc <= 0:
        return None
    dlen = int(rc)
    offs = offs[:n_segs]
    ends = np.append(offs[1:], dlen * 8)
    starts_byte = offs // 8
    start_bits = (offs % 8).astype(np.int32)
    lens = (ends + 7) // 8 - starts_byte
    # +8 slack: the nibble window table reads a few bytes of lookahead
    # past the last consumed bit.
    L = _bucket_len(int(lens.max()) + 8)
    if dlen + L >= 2**31:
        return None
    # Windows are gathered on device (see split_rst_stream); mid-byte
    # lane starts are handled by start_bits.
    return dest[:dlen].copy(), starts_byte.astype(np.int32), \
        start_bits, L


# ---------------------------------------------------------------------------
# Device kernel.
# ---------------------------------------------------------------------------


def _window_table(chunks_u8):
    """(NC, L) u8 -> (NC, 2L) u32 nibble-indexed windows: entry n holds
    the 32 stream bits starting at nibble n (zero-padded past the
    end). Pure static shifts/slices — vectorized, runs once."""
    nc, L = chunks_u8.shape
    b = chunks_u8.astype(jnp.uint32)
    z = jnp.zeros((nc, 4), jnp.uint32)
    bp = jnp.concatenate([b, z], axis=1)
    w = ((bp[:, :L] << 24) | (bp[:, 1:L + 1] << 16)
         | (bp[:, 2:L + 2] << 8) | bp[:, 3:L + 3])
    w_odd = (w << 4) | (bp[:, 4:L + 4] >> 4)
    return jnp.stack([w, w_odd], axis=2).reshape(nc, 2 * L)


def _select_read(table, idx):
    """table[(lane, idx[lane])] without an XLA gather: compare+select
    against a column iota (dense elementwise work, no gather)."""
    cols = jnp.arange(table.shape[1], dtype=jnp.int32)
    return jnp.sum(jnp.where(cols[None, :] == idx[:, None], table, 0),
                   axis=1, dtype=table.dtype)


def _signed_extend(extra, nbits):
    """JPEG F.2.2.1 EXTEND: map nbits-bit magnitude to signed value."""
    half = jnp.where(nbits > 0, jnp.int32(1) << (nbits - 1).astype(
        jnp.uint32).clip(0, 31).astype(jnp.int32), jnp.int32(1))
    full = (jnp.int32(1) << nbits.astype(jnp.uint32).clip(0, 31).astype(
        jnp.int32)) - 1
    e = extra.astype(jnp.int32)
    return jnp.where(nbits > 0,
                     jnp.where(e < half, e - full, e), 0)


def _win_at(t, ws):
    """Left-aligned 32-bit window starting at in-step bit offset t,
    assembled from the step's u32 reads ws (ws[i] holds the 32 stream
    bits at in-step offset 28*i). Overlapping reads carry identical
    stream bits, so the pairwise ORs are exact; the where-chain picks
    the deepest pair that still covers t. Valid for
    t <= 28*(len(ws)-1)+4 with >= 27 usable bits."""
    tu = t.astype(jnp.uint32)
    top = 28 * (len(ws) - 1)
    win = ws[-1] << ((tu - top) & 31)
    for i in range(len(ws) - 2, -1, -1):
        lo = 28 * i
        pair = ((ws[i] << ((tu - lo) & 31))
                | (ws[i + 1] >> ((lo + 28 - tu) & 31)))
        win = jnp.where(t <= lo + 28, pair, win)
    return win


# Units decoded per while_loop step (default; explicit arg wins).
# Total per-unit work is invariant in this knob — it only amortizes
# the loop's carried-state latency over more units per trip. The
# default of 3 came from a sweep on the previous accelerator and waits
# on an H100 sweep (microbench --decode-emit-sweep; ROADMAP design
# debt 3).
_DEFAULT_UNITS = max(1, min(4, int(os.environ.get(
    "UHDR_DECODE_UNITS", "3"))))

# Emission strategy of the decode loop (default; explicit arg wins).
# "dense": every unit rewrites the carried (nc, cb*64) coefficient
# buffer through a compare+select mask — ~2*cb*128 bytes of HBM
# traffic per lane per STEP, which makes the loop memory-bound on its
# own carried state for production interval sizes. "log": units
# append (key, val) pairs into a compact log via an in-place
# dynamic_update_slice (per-step traffic ~units*6 bytes per lane);
# the dense buffer is rebuilt after the loop by one vectorized
# binary search over the per-lane monotone keys. Bit-exact equals
# "dense" (tests/test_device_decode.py). "dense" is the default from a
# sweep on the previous accelerator; which emission wins on the H100
# waits on the same sweep (ROADMAP design debt 3).
_DEFAULT_EMIT = os.environ.get("UHDR_DECODE_EMIT", "dense")


def decode_rst_chunks(chunks_u8, r_mcus: int, n_mcus: int, gray: bool,
                      chains=None, min_code_bits: int = 2,
                      start_bits=None, dc_carry: bool = False,
                      ypm: int = 4, units_per_step: int | None = None,
                      emit_mode: str | None = None,
                      return_steps: bool = False):
    """Traceable device decode of restart-interval chunks.

    chunks_u8: (NC, L) u8 destuffed interval bytes (zero-padded).
    chains: (dc_luma, ac_luma, dc_chroma, ac_chroma) chain constants
    (defaults to the Annex-K tables).
    min_code_bits: shortest codeword across the tables in `chains`
    (min_code_len_from_key); bounds the decode-loop trip count. The
    Annex-K default tables bottom out at 2 bits, but foreign optimized
    tables may carry 1-bit codes — underestimating this truncates
    valid streams mid-decode.
    start_bits: optional (NC,) i32 per-lane initial bit offset into
    its chunk window (synthesized segments of a restart-less stream
    start mid-byte; real RST intervals are byte-aligned, so None).
    dc_carry: lanes are slices of ONE DC-prediction chain (foreign
    restart-less stream) rather than prediction-reset intervals; add
    each lane's carry-in (exclusive prefix over the previous lanes'
    local DC sums) to its decoded DC coefficients.
    ypm: luma blocks per MCU for color streams (4 = 4:2:0, 2 = 4:2:2,
    1 = 4:4:4); the interleave pattern is [Y*ypm, U, V].
    emit_mode: "dense" | "log" coefficient emission (None = the
    UHDR_DECODE_EMIT env default) — bit-identical results, different
    HBM traffic shape; see _DEFAULT_EMIT above.
    Returns (NC * r_mcus * bpm, 64) i16 MCU-ordered zigzag blocks
    (bpm = ypm + 2 for color, 1 for grayscale); trailing pad blocks
    (beyond n_mcus) are zero. With return_steps=True, returns
    (blocks, trips): trips is the decode while_loop's i32 trip count.
    """
    dc_l, ac_l, dc_c, ac_c = chains or _ANNEX_K_CHAINS
    nc, L = chunks_u8.shape
    bpm = 1 if gray else ypm + 2
    cb = bpm * r_mcus
    W = _window_table(chunks_u8)
    lane = jnp.arange(nc, dtype=jnp.int32)
    last_mcus = n_mcus - r_mcus * (nc - 1)
    target = jnp.where(lane < nc - 1, cb, bpm * last_mcus)
    max_bits = L * 8
    out_cols = jnp.arange(cb * 64, dtype=jnp.int32)[None, :]

    units = units_per_step or _DEFAULT_UNITS
    # Emission upper bound: every coefficient + per-block DC/EOB/ZRL
    # overhead, bounded by the bit budget (each unit costs at least
    # one codeword of min_code_bits; `units` decode per loop step).
    step_cap = max_bits // (units * min_code_bits) + 2
    log_emit = (emit_mode or _DEFAULT_EMIT) == "log"
    if log_emit:
        # Every block completes within <=65 units on ANY input (each
        # AC unit either strictly raises k or ends the block; DC is
        # one unit), so a lane reaches `target` within cb*65 units —
        # usually a tighter trip bound than the bit budget, and it
        # sizes the emission log statically. Taking the min never
        # changes results: both caps exceed the natural completion
        # point, past which every lane is frozen.
        step_cap = min(step_cap, cb * 65 // units + 2)
        log_cap = 1 << max(5, ((step_cap + 1) * units - 1).bit_length())

    def decode_unit(win, bit, blk, k, dcp, done):
        """Decode ONE codeword+extra from the (left-aligned, >=27
        valid bits) window; returns the advanced lane state plus the
        emission for the dense out-buffer write."""
        peek = win >> 16
        slot = blk % bpm
        is_luma = True if gray else slot < ypm
        is_dc = k == 0
        if gray:
            dc_pk = _eval_chain(peek, dc_l)
            ac_pk = _eval_chain(peek, ac_l)
        else:
            dc_pk = _eval_chain_pair(peek, dc_l, dc_c, is_luma)
            ac_pk = _eval_chain_pair(peek, ac_l, ac_c, is_luma)
        pk = jnp.where(is_dc, dc_pk, ac_pk)
        sym = (pk >> 5).astype(jnp.int32)
        clen = (pk & 31).astype(jnp.int32)

        nextra = jnp.where(is_dc, sym, sym & 15)
        extra = jnp.where(
            nextra > 0,
            (win << clen.astype(jnp.uint32))
            >> ((32 - nextra).astype(jnp.uint32) & 31), jnp.uint32(0))
        val = _signed_extend(extra, nextra)

        # --- DC unit ---
        if gray:
            comp = jnp.zeros_like(blk)
            dc_pred = dcp[:, 0]
        else:
            comp = jnp.where(slot < ypm, 0, slot - (ypm - 1))
            dc_pred = jnp.where(slot < ypm, dcp[:, 0],
                                jnp.where(slot == ypm, dcp[:, 1],
                                          dcp[:, 2]))
        new_dc = dc_pred + val

        # --- AC unit ---
        is_eob = sym == 0
        is_zrl = sym == 0xF0
        run = sym >> 4
        kk = jnp.minimum(k + run, 63)

        emit = (~done) & (is_dc | ~(is_eob | is_zrl))
        dest = jnp.where(is_dc, blk * 64, blk * 64 + kk)
        eval_ = jnp.where(is_dc, new_dc, val)

        blk_n = jnp.where(is_dc, blk,
                          jnp.where(is_eob | (kk >= 63), blk + 1, blk))
        k_n = jnp.where(is_dc, 1,
                        jnp.where(is_eob | (kk >= 63), 0,
                                  jnp.where(is_zrl, k + 16, kk + 1)))
        ulen = clen + nextra

        bit = jnp.where(done, bit, bit + ulen)
        blk = jnp.where(done, blk, blk_n)
        k = jnp.where(done, k, k_n)
        if gray:
            dcp = jnp.where((~done & is_dc)[:, None], new_dc[:, None],
                            dcp)
        else:
            upd = (~done) & is_dc
            for c in range(3):
                dcp = dcp.at[:, c].set(
                    jnp.where(upd & (comp == c), new_dc, dcp[:, c]))
        done = done | (blk >= target) | (bit > max_bits)
        return (bit, blk, k, dcp, done, ulen,
                dest, eval_.astype(jnp.int16), emit)

    def cond(state):
        return jnp.any(~state[4])

    def body(state):
        bit, blk, k, dcp, done, out, nstep = state
        # `units` indexed reads expose a 28*units+4 bit multi-window:
        # unit j's <=27-bit codeword+extra starts at in-step offset
        # t_j <= 3 + 27*j, always covered (3 + 27*(units-1) + 27 <=
        # 28*(units-1) + 32 for units >= 2; units==1 fits w0's 29).
        nib = bit >> 2
        r = (bit & 3).astype(jnp.int32)
        ws = [_select_read(W, nib + 7 * i) for i in range(units)]

        t = r
        for _ in range(units):
            (bit, blk, k, dcp, done, ulen, dest, val,
             emit) = decode_unit(_win_at(t, ws), bit, blk, k, dcp, done)
            m = (out_cols == dest[:, None]) & emit[:, None]
            out = jnp.where(m, val[:, None], out)
            t = t + ulen

        done = done | (nstep >= step_cap)
        return bit, blk, k, dcp, done, out, nstep + 1

    def body_log(state):
        # Log emission: instead of rewriting the dense (nc, cb*64)
        # buffer per unit, append (key, val) at column nstep*units via
        # an in-place dynamic_update_slice. key = dest*2+1 when the
        # unit emits; a non-emitting unit repeats the lane's previous
        # key (init 0 — even, never matches a target), so each lane's
        # key row stays monotone non-decreasing with the emitted
        # original FIRST in any duplicate run; the unwritten tail
        # holds the +inf sentinel. The dense buffer is then rebuilt by
        # one vectorized lower-bound search (see below).
        bit, blk, k, dcp, done, keys, vals, lastk, nstep = state
        nib = bit >> 2
        r = (bit & 3).astype(jnp.int32)
        ws = [_select_read(W, nib + 7 * i) for i in range(units)]

        t = r
        ku, vu = [], []
        for _ in range(units):
            (bit, blk, k, dcp, done, ulen, dest, val,
             emit) = decode_unit(_win_at(t, ws), bit, blk, k, dcp, done)
            lastk = jnp.where(emit, dest * 2 + 1, lastk)
            ku.append(lastk)
            vu.append(jnp.where(emit, val, jnp.int16(0)))
            t = t + ulen
        col = nstep * units
        keys = jax.lax.dynamic_update_slice(
            keys, jnp.stack(ku, axis=1), (jnp.int32(0), col))
        vals = jax.lax.dynamic_update_slice(
            vals, jnp.stack(vu, axis=1), (jnp.int32(0), col))

        done = done | (nstep >= step_cap)
        return bit, blk, k, dcp, done, keys, vals, lastk, nstep + 1

    bit0 = (jnp.zeros(nc, jnp.int32) if start_bits is None
            else start_bits.astype(jnp.int32))
    if log_emit:
        state = (bit0, jnp.zeros(nc, jnp.int32),
                 jnp.zeros(nc, jnp.int32), jnp.zeros((nc, 3), jnp.int32),
                 jnp.zeros(nc, bool),
                 jnp.full((nc, log_cap), 2**31 - 1, jnp.int32),
                 jnp.zeros((nc, log_cap), jnp.int16),
                 jnp.zeros(nc, jnp.int32), jnp.int32(0))
        end = jax.lax.while_loop(cond, body_log, state)
        keys, vals, trips = end[5], end[6], end[8]
        # Dense reconstruction: per output column c, lower-bound
        # c*2+1 in the lane's monotone key row (branchless pow2
        # strides; total strides sum to log_cap-1, and the sentinel
        # tail means "all keys smaller" can only happen when c was
        # never emitted — the equality check then yields 0).
        targ = out_cols * 2 + 1
        pos = jnp.zeros((nc, cb * 64), jnp.int32)
        s = log_cap >> 1
        while s:
            kv = jnp.take_along_axis(keys, pos + (s - 1), axis=1)
            pos = jnp.where(kv < targ, pos + s, pos)
            s >>= 1
        kv = jnp.take_along_axis(keys, pos, axis=1)
        vv = jnp.take_along_axis(vals, pos, axis=1)
        out = jnp.where(kv == targ, vv, jnp.int16(0))
    else:
        state = (bit0, jnp.zeros(nc, jnp.int32),
                 jnp.zeros(nc, jnp.int32), jnp.zeros((nc, 3), jnp.int32),
                 jnp.zeros(nc, bool), jnp.zeros((nc, cb * 64), jnp.int16),
                 jnp.int32(0))
        end = jax.lax.while_loop(cond, body, state)
        out, trips = end[5], end[6]
    if dc_carry:
        # Each lane's final dcp (it started from 0) is the sum of its
        # DC diffs per component; the exclusive prefix across lanes is
        # each lane's true carry-in. Pad blocks past `target` decoded
        # nothing, and their (0 + carry) DCs are dropped with the pad.
        dcp_final = end[3]                               # (NC, 3)
        carry = jnp.cumsum(dcp_final, axis=0) - dcp_final
        comp_map = (np.zeros(cb, np.int32) if gray else
                    np.tile(np.array([0] * ypm + [1, 2], np.int32),
                            r_mcus))
        out = out.reshape(nc, cb, 64)
        out = out.at[:, :, 0].add(
            carry[:, comp_map].astype(jnp.int16))
    blocks = out.reshape(nc * r_mcus * bpm, 64)
    return (blocks, trips) if return_steps else blocks


def deinterleave_ycbcr_device(blocks, mcus_x: int, mcus_y: int,
                              hs: int = 2, vs: int = 2):
    """Inverse of the [Y*hs*vs, U, V] MCU interleave for luma sampling
    (hs, vs) with 1x1 chroma: MCU-ordered blocks -> per-component
    block grids (flattened row-major, ready for dequant_idct). blocks
    may carry trailing pad MCUs."""
    n = mcus_x * mcus_y
    bpm = hs * vs + 2
    bm = blocks[: n * bpm].reshape(n, bpm, 64)
    yb = bm[:, :hs * vs].reshape(mcus_y, mcus_x, vs, hs, 64)
    yz = yb.transpose(0, 2, 1, 3, 4).reshape(
        mcus_y * vs * mcus_x * hs, 64)
    uz = bm[:, hs * vs].reshape(mcus_y * mcus_x, 64)
    vz = bm[:, hs * vs + 1].reshape(mcus_y * mcus_x, 64)
    return yz, uz, vz


def deinterleave_yuv420_device(blocks, mcus_x: int, mcus_y: int):
    """4:2:0 compat wrapper (the JPEG/R fused decode path is pinned to
    2x2/1x1/1x1 sampling, matching the reference's decoder)."""
    return deinterleave_ycbcr_device(blocks, mcus_x, mcus_y, 2, 2)


# ---------------------------------------------------------------------------
# Full-image entry: parse + prep on host, everything else device-side.
# ---------------------------------------------------------------------------


class DeviceStream:
    """Host-parsed description of a device-decodable baseline JPEG.

    The entropy payload is carried as `dest` (contiguous destuffed
    bytes) + `starts_byte` (per-lane byte offsets) + `win_len` (the
    bucketed per-lane window width); the fused decode kernel gathers
    each lane's window on device, so only the real stream bytes are
    uploaded. start_bits is None for real restart-interval streams;
    for foreign restart-less streams it carries each synthesized
    lane's initial bit offset within its window, and the decode must
    run with dc_carry=True."""

    __slots__ = ("width", "height", "gray", "restart_interval", "dest",
                 "starts_byte", "win_len", "qtables", "icc", "exif",
                 "xmp", "mcus_x", "mcus_y", "tables_key", "start_bits",
                 "sampling", "_chunks")

    def __init__(self, **kw):
        self.start_bits = None
        self.sampling = (2, 2)   # luma (h, v); (1, 1) for grayscale
        self._chunks = None
        for k, v in kw.items():
            setattr(self, k, v)

    @property
    def n_lanes(self) -> int:
        return int(self.starts_byte.shape[0])

    @property
    def chunks(self) -> np.ndarray:
        """Host-materialized (n_lanes, win_len) windows — compat view
        for the kernel-bench and tests; the decode path gathers the
        same windows on device instead. For RST streams the bytes past
        each lane's own interval are zeroed (the old split_rst_stream
        invariant: deterministic tails even on corrupt input); foreign
        synthesized lanes keep their genuine continuation bytes."""
        if self._chunks is None:
            padded = np.concatenate(
                [self.dest, np.zeros(self.win_len, np.uint8)])
            idx = (self.starts_byte[:, None]
                   + np.arange(self.win_len, dtype=np.int32)[None, :])
            out = np.take(padded, idx)
            if self.start_bits is None:
                lens = np.diff(np.append(self.starts_byte,
                                         self.dest.size))
                out[np.arange(self.win_len,
                              dtype=np.int32)[None, :]
                    >= lens[:, None]] = 0
            self._chunks = out
        return self._chunks

    def padded_dest(self) -> np.ndarray:
        """dest padded so every lane's device window gather stays
        in-bounds, bucketed for compile reuse."""
        target = _bucket_len(self.dest.size + self.win_len)
        return np.pad(self.dest, (0, target - self.dest.size))


def parse_device_stream(data: bytes) -> DeviceStream | None:
    """Parse a JPEG and return a DeviceStream when the bitstream is
    device-decodable (baseline, Annex-K tables, restart intervals,
    4:2:0 2x2/1x1/1x1 with MCU-aligned dims, or grayscale with
    8-aligned dims); None otherwise."""
    from ..container import jfif

    try:
        segments, sos_end = jfif.scan_segments(data, 0)
    except Exception:
        return None
    qtables = {}
    htables = {}
    comps = []
    scan_sel = {}
    w = h = 0
    restart = 0
    icc = exif = xmp_b = None
    progressive = False
    nscans = 0
    for seg in segments:
        if seg.marker == 0xDB:
            p = seg.payload
            pos = 0
            while pos < len(p):
                pq, tq = p[pos] >> 4, p[pos] & 15
                pos += 1
                if pq == 0:
                    zz = np.frombuffer(p[pos:pos + 64], np.uint8)
                    pos += 64
                else:
                    zz = np.frombuffer(p[pos:pos + 128], ">u2")
                    pos += 128
                nat = np.zeros(64, np.int32)
                nat[tables.ZIGZAG] = zz
                qtables[tq] = nat.reshape(8, 8)
        elif seg.marker in (0xC0, 0xC1):
            p = seg.payload
            if len(p) < 6 or len(p) < 6 + p[5] * 3:
                return None
            h = (p[1] << 8) | p[2]
            w = (p[3] << 8) | p[4]
            comps = [(p[6 + i * 3], p[7 + i * 3] >> 4, p[7 + i * 3] & 15,
                      p[8 + i * 3]) for i in range(p[5])]
        elif seg.marker == 0xC2:
            progressive = True
        elif seg.marker == 0xC4:
            p = seg.payload
            pos = 0
            while pos + 17 <= len(p):
                tc, th = p[pos] >> 4, p[pos] & 15
                pos += 1
                bits = list(p[pos:pos + 16])
                pos += 16
                nvals = sum(bits)
                if nvals > 256 or pos + nvals > len(p):
                    return None
                htables[(tc, th)] = (bits, list(p[pos:pos + nvals]))
                pos += nvals
        elif seg.marker == 0xDD:
            restart = int.from_bytes(seg.payload[:2], "big")
        elif seg.marker == 0xDA:
            nscans += 1
            p = seg.payload
            if len(p) >= 1 + p[0] * 2:
                for i in range(p[0]):
                    scan_sel[p[1 + i * 2]] = (p[2 + i * 2] >> 4,
                                              p[2 + i * 2] & 15)
        elif seg.marker == 0xE1:
            if seg.payload.startswith(jfif.EXIF_SIG) and exif is None:
                exif = seg.payload
            elif seg.payload.startswith(jfif.XMP_SIG) and xmp_b is None:
                xmp_b = seg.payload
        elif seg.marker == 0xE2:
            if seg.payload.startswith(jfif.ICC_SIG) and icc is None:
                icc = seg.payload
    if progressive or nscans != 1 or not comps or w == 0 or h == 0:
        return None
    if len(comps) == 1:
        gray = True
        hs = vs = 1
        if comps[0][1:3] != (1, 1):
            return None
        mcus_x, mcus_y = -(-w // 8), -(-h // 8)
    elif len(comps) == 3:
        gray = False
        samp = [c[1:3] for c in comps]
        if samp[1:] != [(1, 1), (1, 1)]:
            return None
        hs, vs = samp[0]
        # 4:2:0, 4:2:2 and 4:4:4 (the wild's three samplings); the
        # rare transposed 1x2 falls back to the host decoder.
        if (hs, vs) not in ((2, 2), (2, 1), (1, 1)):
            return None
        mcus_x, mcus_y = -(-w // (8 * hs)), -(-h // (8 * vs))
    else:
        return None
    if any(c[3] not in qtables for c in comps):
        return None
    # Per-component Huffman selectors -> a table key the kernel cache
    # compiles against (Annex-K for our own streams; anything valid for
    # foreign restart-marker files). U and V must share tables (true of
    # essentially every encoder; fall back otherwise).
    try:
        sel = [scan_sel[c[0]] for c in comps]
    except KeyError:
        return None
    if gray:
        specs = (htables.get((0, sel[0][0])), htables.get((1, sel[0][1])),
                 None, None)
    else:
        if sel[1] != sel[2]:
            return None
        specs = (htables.get((0, sel[0][0])), htables.get((1, sel[0][1])),
                 htables.get((0, sel[1][0])), htables.get((1, sel[1][1])))
    if specs[0] is None or specs[1] is None or (
            not gray and (specs[2] is None or specs[3] is None)):
        return None
    # Degenerate (zero-codeword) tables would build empty select
    # chains and crash at kernel construction; let the host decoder
    # produce its proper error instead.
    if any(s is not None and sum(s[0]) == 0 for s in specs):
        return None
    tkey = serialize_tables(*specs)

    eoi = data.find(b"\xff\xd9", sos_end)
    entropy = data[sos_end:eoi if eoi >= 0 else len(data)]
    n_mcus = mcus_x * mcus_y
    start_bits = None
    if restart > 0:
        n_chunks = -(-n_mcus // restart)
        try:
            dest, starts_byte, win_len = split_rst_stream(entropy,
                                                          n_chunks)
        except ValueError:
            return None
    else:
        # Foreign restart-less stream: a host lengths-only scan
        # synthesizes one lane per `restart` MCUs (sized for the same
        # lane count our own encoder's restart intervals give).
        counters.bump("decode_foreign_stream_scan")
        restart = max(1, -(-n_mcus // 12288))
        scanned = scan_foreign_stream(entropy, n_mcus, gray, specs,
                                      restart, sampling=(hs, vs))
        if scanned is None:
            return None
        dest, starts_byte, start_bits, win_len = scanned
    return DeviceStream(
        width=w, height=h, gray=gray, restart_interval=restart,
        dest=dest, starts_byte=starts_byte, win_len=win_len,
        qtables=[qtables[c[3]] for c in comps],
        icc=icc, exif=exif, xmp=xmp_b, mcus_x=mcus_x, mcus_y=mcus_y,
        tables_key=tkey, start_bits=start_bits, sampling=(hs, vs))


@lru_cache(maxsize=None)
def _decode_to_planes_kernel(nc: int, L: int, r: int, n_mcus: int,
                             mcus_x: int, mcus_y: int, gray: bool,
                             qkey: bytes, tkey: bytes | None = None,
                             carry: bool = False,
                             sampling: tuple = (2, 2)):
    """Jitted chunks -> pixel planes (entropy decode + dequant/IDCT).
    With carry=True the kernel takes (chunks, start_bits) for foreign
    synthesized-segment streams. sampling = luma (h, v) factors for
    color streams (chroma always 1x1)."""
    from .dct import dequant_idct

    qts = np.frombuffer(qkey, np.int32).reshape(-1, 8, 8)
    chains = chains_from_key(tkey) if tkey else None
    mcb = min_code_len_from_key(tkey)
    hs, vs = sampling

    def impl(chunks, starts):
        blocks = decode_rst_chunks(chunks, r, n_mcus, gray, chains, mcb,
                                   start_bits=starts, dc_carry=carry,
                                   ypm=hs * vs)
        if gray:
            return (dequant_idct(blocks[: n_mcus], qts[0], mcus_y * 8,
                                 mcus_x * 8),)
        yz, uz, vz = deinterleave_ycbcr_device(blocks, mcus_x, mcus_y,
                                               hs, vs)
        y = dequant_idct(yz, qts[0], mcus_y * 8 * vs, mcus_x * 8 * hs)
        u = dequant_idct(uz, qts[1], mcus_y * 8, mcus_x * 8)
        v = dequant_idct(vz, qts[2], mcus_y * 8, mcus_x * 8)
        return y, u, v

    if carry:
        @jax.jit
        def kernel(chunks, starts):
            return impl(chunks, starts)
    else:
        @jax.jit
        def kernel(chunks):
            return impl(chunks, None)

    return kernel


def decode_jpeg_device(data: bytes):
    """Decode a device-decodable JPEG fully on device; returns
    (DeviceStream, tuple of device pixel planes) or None if the
    bitstream doesn't qualify."""
    ds = parse_device_stream(data)
    if ds is None:
        return None
    qkey = np.stack(ds.qtables).astype(np.int32).tobytes()
    carry = ds.start_bits is not None
    kernel = _decode_to_planes_kernel(
        ds.chunks.shape[0], ds.chunks.shape[1], ds.restart_interval,
        ds.mcus_x * ds.mcus_y, ds.mcus_x, ds.mcus_y, ds.gray, qkey,
        ds.tables_key, carry, ds.sampling)
    planes = (kernel(jnp.asarray(ds.chunks), jnp.asarray(ds.start_bits))
              if carry else kernel(jnp.asarray(ds.chunks)))
    return ds, planes
