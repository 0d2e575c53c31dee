"""JPEG Huffman entropy encoding ON the device.

The classic CPU formulation (and this framework's host fallback,
native/entropy.cpp) is a sequential bit-writer. Here the whole entropy
stage is reformulated as data-parallel XLA ops so the only bytes that
come back to the host are the compressed stream itself
(~1-2 MB for a 4K frame instead of ~36 MB of raw coefficients).

Shared front end (for both assembly paths):
1. every (block, position) pair maps to at most ONE emission unit:
     slot 0        : the DC code+extra (DC diffs from static lag
                     selects in per-component scan order)
     slots 1..63   : an AC code+extra at nonzero positions; at zero
                     positions, a ZRL exactly when the zero-run length
                     since the last nonzero hits a multiple of 16 and a
                     later nonzero exists (run-length semantics become
                     positional predicates)
     slot 64       : EOB when the block has trailing zeros
   All table lookups are fused select chains (no gather).

Assembly paths:
- encode_*_rst_stream (production): per-block word buffers via masked
  integer sums (exact: co-located bits are disjoint so sums stay
  carry-free), blocks -> restart-interval chunks via a doubling merge
  of vectorized bit/word shifts, chunks 1-filled to 32-bit alignment
  (legal pad bits + 0xFF fill before RSTn, T.81 B.1.1.2) so every word
  has a unique destination, then ONE parallel lax.sort compacts the
  stream. Byte-identical to the host bit-writer at the same restart
  interval. Dense content overflowing the per-block cap raises the
  overflow flag; callers fall back to the scatter path.
- encode_*_stream (fallback): cumsum bit offsets + sorted scatter-add.
  Exact for any content; whether it beats the sort on the GPU is an
  open measurement (ROADMAP speed item 6).

Host postprocessing is only byte stuffing + restart-marker insertion
over the ~1 MB result (finalize_rst_stream / _finalize).
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from . import tables


def _build_code_table(bits, vals):
    """(code[256] u32, size[256] u8) canonical tables (T.81 Annex C)."""
    code = np.zeros(256, np.uint32)
    size = np.zeros(256, np.uint8)
    c = 0
    k = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            sym = vals[k]
            code[sym] = c
            size[sym] = length
            c += 1
            k += 1
        c <<= 1
    return code, size


_DC_LUMA = _build_code_table(tables.DC_LUMA_BITS, tables.DC_LUMA_VALS)
_AC_LUMA = _build_code_table(tables.AC_LUMA_BITS, tables.AC_LUMA_VALS)
_DC_CHROMA = _build_code_table(tables.DC_CHROMA_BITS, tables.DC_CHROMA_VALS)
_AC_CHROMA = _build_code_table(tables.AC_CHROMA_BITS, tables.AC_CHROMA_VALS)


def _bitlen(v):
    """Number of bits of |v| (JPEG 'size' category), integer-exact via
    the f32 exponent field: int->f32 conversion is exact for
    |v| < 2^24 (every reachable JPEG magnitude), and the biased
    exponent of an exactly-converted integer is floor(log2)+127 by
    IEEE-754 construction — no rounding enters anywhere, unlike a
    float log2. One convert + shift instead of a 15-compare chain
    (~4x fewer elementwise passes over the (N, 63) coefficient array)."""
    av = jnp.abs(v)
    e = (jax.lax.bitcast_convert_type(av.astype(jnp.float32),
                                      jnp.int32) >> 23) - 126
    # Defensive saturation at 15 (the old compare chain's implicit
    # bound): an out-of-range coefficient from corrupt upstream state
    # must clamp rather than silently build an invalid bitstream.
    return jnp.minimum(jnp.where(av > 0, e, 0), 15)


def _scan_lanes(x, combine, reverse=False):
    """Inclusive log-doubling scan along axis=1 (prefix when
    reverse=False, suffix when True), 6 shifted passes for 63 lanes
    in place of jax's own cumulative ops (lax.cummax et al.). The
    pad fill is 0, a
    neutral element for every combine used here (max over
    non-negative values, or, add)."""
    n = x.shape[1]
    d = 1
    while d < n:
        if reverse:
            shifted = jnp.pad(x, ((0, 0), (0, d)))[:, d:]
        else:
            shifted = jnp.pad(x, ((0, 0), (d, 0)))[:, :n]
        x = combine(x, shifted)
        d <<= 1
    return x


def _cummax_incl_lanes(x):
    return _scan_lanes(x, jnp.maximum)


def _suffix_any_excl_lanes(nz):
    """has_later[k] = any(nz[j] for j > k)."""
    excl = jnp.pad(nz, ((0, 0), (0, 1)))[:, 1:]
    return _scan_lanes(excl, jnp.logical_or, reverse=True)


def _cumsum_incl_lanes(x):
    return _scan_lanes(x, jnp.add)


def _pack_table(code_size) -> np.ndarray:
    """(code, size) 256-entry tables packed as u32 (code << 5 | size):
    one lookup instead of two."""
    code, size = code_size
    return ((code.astype(np.uint32) << 5)
            | size.astype(np.uint32)).reshape(16, 16)


_DC_LUMA_PACKED = _pack_table(_DC_LUMA)
_AC_LUMA_PACKED = _pack_table(_AC_LUMA)
_DC_CHROMA_PACKED = _pack_table(_DC_CHROMA)
_AC_CHROMA_PACKED = _pack_table(_AC_CHROMA)


def _lookup256(packed_16x16: np.ndarray, idx):
    """256-entry table lookup without a gather.

    A (N, 16) row-take would materialize a 16x intermediate (OOM at 4K
    batch sizes); a flat jnp.take is the plain form whose H100 time is
    an open measurement (ROADMAP design debt 2). A chain of
    selects over the table's POPULATED entries fuses into a single
    elementwise pass: O(N) memory, ~1 ms for 74M lookups.
    Returns (code u32, size i32)."""
    flat = np.asarray(packed_16x16).reshape(-1)
    valid = np.flatnonzero(flat != 0)
    out = jnp.zeros(idx.shape, jnp.uint32)
    for sym in valid:
        out = jnp.where(idx == int(sym), np.uint32(flat[sym]), out)
    return out >> 5, (out & 31).astype(jnp.int32)


def _units_for_blocks(blocks, dc_prev, is_luma):
    """Per-block emission units for MCU-interleaved blocks.

    blocks: (N, 64) int32 zigzag coefficients.
    dc_prev: (N,) int32 predicted DC (previous same-component DC).
    is_luma: (N,) bool — which Huffman table pair each block uses.
    Returns (vals (N, 65) u32, lens (N, 65) i32).
    """
    n = blocks.shape[0]
    dc = blocks[:, 0]
    ac = blocks[:, 1:]

    if isinstance(is_luma, bool):
        # Static table selection: one select chain instead of two.
        dc_tbl = _DC_LUMA_PACKED if is_luma else _DC_CHROMA_PACKED
        ac_tbl = _AC_LUMA_PACKED if is_luma else _AC_CHROMA_PACKED

        def lookup_dc(sym):
            return _lookup256(dc_tbl, sym)

        def lookup_ac(sym):
            return _lookup256(ac_tbl, sym)
    else:
        def lookup_dc(sym):
            cl, ll = _lookup256(_DC_LUMA_PACKED, sym)
            cc, lc = _lookup256(_DC_CHROMA_PACKED, sym)
            lum = is_luma if sym.ndim == 1 else is_luma[:, None]
            return jnp.where(lum, cl, cc), jnp.where(lum, ll, lc)

        def lookup_ac(sym):
            cl, ll = _lookup256(_AC_LUMA_PACKED, sym)
            cc, lc = _lookup256(_AC_CHROMA_PACKED, sym)
            lum = is_luma if sym.ndim == 1 else is_luma[:, None]
            return jnp.where(lum, cl, cc), jnp.where(lum, ll, lc)

    # --- DC ---
    diff = dc - dc_prev
    s = _bitlen(diff)
    extra = jnp.where(diff >= 0, diff, diff + (1 << s) - 1).astype(
        jnp.uint32) & ((jnp.uint32(1) << s.astype(jnp.uint32)) - 1)
    dc_code, dcl = lookup_dc(s)
    dc_val = (dc_code << s.astype(jnp.uint32)) | extra
    dc_len = dcl + s

    # --- AC positions 1..63 ---
    k = jnp.arange(1, 64, dtype=jnp.int32)[None, :]
    nz = ac != 0
    # previous nonzero position (or 0): positions fit int8, so the
    # running max runs at 4x lane density.
    k8 = jnp.arange(1, 64, dtype=jnp.int8)[None, :]
    posmask8 = jnp.where(nz, k8, jnp.int8(0))
    prev_incl8 = _cummax_incl_lanes(posmask8)
    prevnz = jnp.pad(prev_incl8, ((0, 0), (1, 0)))[:, :-1].astype(
        jnp.int32)
    rel = k - prevnz
    has_later = _suffix_any_excl_lanes(nz)

    run = rel - 1
    sa = _bitlen(ac)
    # One fused lookup covers the AC symbol, ZRL (0xF0) and EOB (0x00)
    # cases: pick the symbol per position, then mask lengths.
    is_zrl = (~nz) & (rel > 0) & (rel % 16 == 0) & has_later
    sym = jnp.where(nz, ((run % 16) << 4) | sa,
                    jnp.where(is_zrl, 0xF0, 0))
    a_codes, a_sizes = lookup_ac(sym)
    a_extra = jnp.where(ac >= 0, ac, ac + (1 << sa) - 1).astype(
        jnp.uint32) & ((jnp.uint32(1) << sa.astype(jnp.uint32)) - 1)
    sa_u = jnp.where(nz, sa, 0)
    vals_ac = jnp.where(nz | is_zrl,
                        (a_codes << sa_u.astype(jnp.uint32))
                        | jnp.where(nz, a_extra, 0), 0)
    lens_ac = jnp.where(nz | is_zrl, a_sizes + sa_u, 0)

    # --- EOB (slot 64) ---
    last_nz = jnp.max(posmask8, axis=1).astype(jnp.int32)  # 0 if all-zero AC
    need_eob = last_nz < 63
    eob_code, eob_len = lookup_ac(jnp.zeros_like(dc))
    eob_val = jnp.where(need_eob, eob_code, 0)
    eob_lens = jnp.where(need_eob, eob_len, 0)

    vals = jnp.concatenate(
        [dc_val[:, None], vals_ac, eob_val[:, None]], axis=1)
    lens = jnp.concatenate(
        [dc_len[:, None], lens_ac, eob_lens[:, None]], axis=1)
    return vals.astype(jnp.uint32), lens


def _assemble_bits(vals, lens):
    """Scatter units into a big-endian bitstream. Returns
    (words u32 big-endian-bit-order, total_bits scalar)."""
    flat_vals = vals.reshape(-1)
    flat_lens = lens.reshape(-1)
    ends = jnp.cumsum(flat_lens)
    total_bits = ends[-1]
    starts = ends - flat_lens

    word0 = (starts >> 5).astype(jnp.int32)
    bitpos = (starts & 31).astype(jnp.int32)
    shift = 32 - bitpos - flat_lens  # may be negative (word-crossing)

    pos_shift = jnp.clip(shift, 0, 31).astype(jnp.uint32)
    neg_shift = jnp.clip(-shift, 0, 31).astype(jnp.uint32)
    hi = jnp.where(shift >= 0, flat_vals << pos_shift,
                   flat_vals >> neg_shift)
    # (32 - neg_shift) & 31 keeps the discarded branch's shift amount
    # defined when neg_shift == 0 (shift-by-32 is UB for u32).
    lo = jnp.where(shift >= 0, jnp.uint32(0),
                   flat_vals << ((32 - neg_shift) & 31))
    hi = jnp.where(flat_lens > 0, hi, 0)
    lo = jnp.where(flat_lens > 0, lo, 0)

    n_units = flat_vals.shape[0]
    # Worst case bits: 27 per unit.
    n_words = (n_units * 27) // 32 + 2
    out = jnp.zeros(n_words, jnp.uint32)
    out = out.at[word0].add(hi, indices_are_sorted=True, mode="drop")
    out = out.at[word0 + 1].add(lo, indices_are_sorted=True, mode="drop")
    return out, total_bits


def _dc_prev_interleaved(blocks, pattern_len, y_per_mcu):
    """Previous-same-component DC for the [Y*ypm, U, V] MCU pattern:
    slot 0 Y links to the previous MCU's last Y (lag pattern_len -
    y_per_mcu + 1); U/V link back one MCU (lag pattern_len). Expressed
    as static shifts + selects — no gather."""
    dc = blocks[:, 0]
    n = dc.shape[0]

    def lag(k):
        return jnp.concatenate([jnp.zeros(k, dc.dtype), dc[:-k]])

    slot = jnp.arange(n, dtype=jnp.int32) % pattern_len
    return jnp.where((slot > 0) & (slot < y_per_mcu), lag(1),
                     jnp.where(slot == 0,
                               lag(pattern_len - y_per_mcu + 1),
                               lag(pattern_len)))


def encode_yuv420_stream(blocks_i16):
    """Traceable: (n_mcus*6, 64) MCU-interleaved zigzag blocks
    (4 Y + U + V per MCU) -> (words u32, total_bits). Usable inside a
    larger jit (e.g. the fused batched encode)."""
    blocks = blocks_i16.astype(jnp.int32)
    dc_prev = _dc_prev_interleaved(blocks, 6, 4)
    n = blocks.shape[0]
    is_luma = (jnp.arange(n, dtype=jnp.int32) % 6) < 4
    vals, lens = _units_for_blocks(blocks, dc_prev, is_luma)
    return _assemble_bits(vals, lens)


def encode_gray_stream(blocks_i16):
    """Traceable grayscale variant of encode_yuv420_stream."""
    blocks = blocks_i16.astype(jnp.int32)
    dc = blocks[:, 0]
    dc_prev = jnp.concatenate([jnp.zeros(1, jnp.int32), dc[:-1]])
    vals, lens = _units_for_blocks(blocks, dc_prev, True)
    return _assemble_bits(vals, lens)


@lru_cache(maxsize=None)
def _encode_kernel_yuv420(n_mcus: int):
    return jax.jit(encode_yuv420_stream)


@lru_cache(maxsize=None)
def _encode_kernel_gray(n_blocks: int):
    return jax.jit(encode_gray_stream)


def _finalize(words, total_bits) -> bytes:
    """Host tail: trim, big-endian bytes, 1-pad the final byte, stuff
    0xFF with 0x00."""
    total_bits = int(total_bits)
    n_bytes = (total_bits + 7) // 8
    raw = np.asarray(words[: (n_bytes + 3) // 4]).astype(">u4").tobytes()
    buf = bytearray(raw[:n_bytes])
    rem = total_bits % 8
    if rem:
        buf[-1] |= (1 << (8 - rem)) - 1
    arr = np.frombuffer(bytes(buf), np.uint8)
    ff = np.flatnonzero(arr == 0xFF)
    if ff.size:
        arr = np.insert(arr, ff + 1, 0)
    return arr.tobytes()


# ---------------------------------------------------------------------------
# Scatter-free assembly (the production encode path).
#
# The stream is assembled without a scatter:
#   1. per-block word buffers via masked integer sums (exact: byte
#      planes stay < 256 because co-located bits are disjoint)
#   2. blocks -> restart-interval chunks via a doubling merge (5 levels
#      of vectorized bit/word shifts, no gathers)
#   3. chunks are 1-filled to 32-bit alignment (legal: pad bits + 0xFF
#      fill bytes before an RSTn marker, T.81 B.1.1.2), making every
#      chunk word's destination unique -> compaction is ONE
#      jax.lax.sort (bitonic, fully parallel) by destination word
#
# Restart markers every R MCUs cost ~2-5 bytes per interval (~3% at 4K
# with R=4) and reset DC prediction, in exchange for a fully parallel
# encoder (and, later, parallel decode of our own streams).
# ---------------------------------------------------------------------------

_BLOCK_WORDS = 20          # per-block buffer: 640 bits (overflow-checked)
_BLOCK_BIT_CAP = (_BLOCK_WORDS - 1) * 32


def _block_word_buffers(vals, lens):
    """(N, 65) units -> per-block (N, _BLOCK_WORDS) u32 word buffers +
    (N,) bit lengths + overflow flag, via masked integer sums."""
    n = vals.shape[0]
    ends = _cumsum_incl_lanes(lens)
    blen = ends[:, -1]
    starts = ends - lens
    overflow = jnp.any(blen > _BLOCK_BIT_CAP)

    w = jnp.clip(starts >> 5, 0, _BLOCK_WORDS - 2)
    shift = 32 - (starts & 31) - lens
    ps = jnp.clip(shift, 0, 31).astype(jnp.uint32)
    ns = jnp.clip(-shift, 0, 31).astype(jnp.uint32)
    hi = jnp.where(shift >= 0, vals << ps, vals >> ns)
    lo = jnp.where(shift >= 0, jnp.uint32(0), vals << ((32 - ns) & 31))
    live = lens > 0
    hi = jnp.where(live, hi, 0)
    lo = jnp.where(live, lo, 0)

    # Masked integer sum over the unit axis. Exact because co-located
    # bits are disjoint (sum == OR, no carries); elementwise work, no
    # matrix product.
    cols = np.arange(_BLOCK_WORDS, dtype=np.int32)
    contrib = (jnp.where(w[..., None] == cols, hi[..., None],
                         jnp.uint32(0))
               | jnp.where((w + 1)[..., None] == cols, lo[..., None],
                           jnp.uint32(0)))
    words = jnp.sum(contrib, axis=1, dtype=jnp.uint32)
    return words, blen.astype(jnp.int32), overflow


def _merge_level(buf, lens):
    """One doubling-merge level: concatenate segment pairs bitwise.

    buf: (..., S, W) u32, lens: (..., S) i32 -> (..., S//2, 2W), lens/2.
    """
    w_in = buf.shape[-1]
    left, right = buf[..., 0::2, :], buf[..., 1::2, :]
    l_left = lens[..., 0::2]
    l_right = lens[..., 1::2]

    bitoff = (l_left & 31).astype(jnp.uint32)[..., None]
    wordoff = (l_left >> 5)[..., None]

    zero = jnp.zeros_like(left[..., :1])
    ext = jnp.concatenate([right, zero], axis=-1)
    prev = jnp.concatenate([zero, right], axis=-1)
    sr = (ext >> bitoff) | jnp.where(
        bitoff > 0, prev << ((32 - bitoff) & 31), 0)

    w_out = 2 * w_in
    placed = jnp.concatenate(
        [sr, jnp.zeros(sr.shape[:-1] + (w_out - sr.shape[-1],),
                       jnp.uint32)], axis=-1)
    nbits_idx = max(int(np.ceil(np.log2(w_out))), 1)
    for b in range(nbits_idx):
        shifted = jnp.concatenate(
            [jnp.zeros(placed.shape[:-1] + (1 << b,), jnp.uint32),
             placed[..., : w_out - (1 << b)]], axis=-1)
        placed = jnp.where((wordoff >> b) & 1 == 1, shifted, placed)

    merged = jnp.concatenate(
        [left, jnp.zeros(left.shape[:-1] + (w_in,), jnp.uint32)],
        axis=-1) | placed
    return merged, l_left + l_right


# Sort-input cap: words per block (224 bits/block). 6 was enough for
# most natural content but a single busy 4K frame (bench seed 0)
# overflowed it, forcing the production ladder's FULL-WIDTH retry —
# i.e. the whole batch encoded twice. One extra word (~17% more sort
# input, ~1 ms/4K frame) keeps that content on the first attempt.
DEFAULT_CHUNK_CAP = 7


def _rst_assemble(words, blen, cb: int, cap_per_block: int | None):
    """Shared tail of the RST paths: group per-block buffers into
    cb-block chunks, doubling-merge, word-align, clamp, sort-compact.
    Returns (sorted_words, chunk_bits, total_words, overflow).

    The merge produces (nc, cb*_BLOCK_WORDS) chunk buffers, but typical
    q95 content uses ~1-2 words per block — feeding the full padded
    width to lax.sort wastes ~4x sort time. Chunks are clamped to
    _CHUNK_WORD_CAP words/block before the sort; denser chunks raise
    the overflow flag (callers fall back to the exact scatter path)."""
    n = words.shape[0]
    nc = -(-n // cb)
    pad_blocks = nc * cb - n
    if pad_blocks:
        words = jnp.concatenate(
            [words, jnp.zeros((pad_blocks, _BLOCK_WORDS), jnp.uint32)])
        blen = jnp.concatenate([blen, jnp.zeros(pad_blocks, jnp.int32)])

    p = 1 << int(np.ceil(np.log2(max(cb, 2))))
    buf = words.reshape(nc, cb, _BLOCK_WORDS)
    seg_lens = blen.reshape(nc, cb)
    if p != cb:
        buf = jnp.concatenate(
            [buf, jnp.zeros((nc, p - cb, _BLOCK_WORDS), jnp.uint32)],
            axis=1)
        seg_lens = jnp.concatenate(
            [seg_lens, jnp.zeros((nc, p - cb), jnp.int32)], axis=1)
    for _ in range(int(np.log2(p))):
        buf, seg_lens = _merge_level(buf, seg_lens)
    cbuf = buf[:, 0, :]
    clen = seg_lens[:, 0]

    # 1-fill to the 32-bit boundary (pad bits + 0xFF fill bytes).
    rem = (clen & 31).astype(jnp.uint32)
    fill = jnp.where(rem > 0,
                     (jnp.uint32(1) << ((32 - rem) & 31)) - 1,
                     jnp.uint32(0))
    cap = cbuf.shape[1]
    if cap_per_block is not None:
        cap = min(cap, cap_per_block * cb + 1)
    cbuf = cbuf[:, :cap]
    wcols = np.arange(cap, dtype=np.int32)
    cbuf = cbuf | jnp.where(wcols[None, :] == (clen >> 5)[:, None],
                            fill[:, None], 0)
    cwords = ((clen + 31) >> 5).astype(jnp.int32)
    overflow = jnp.any(cwords > cap)

    # Unique word destinations -> ONE parallel sort compacts the stream.
    bases = jnp.cumsum(cwords) - cwords
    keys = jnp.where(wcols[None, :] < cwords[:, None],
                     bases[:, None] + wcols[None, :],
                     jnp.int32(2**31 - 1))
    keys_s, vals_s = jax.lax.sort(
        (keys.reshape(-1), cbuf.reshape(-1)), num_keys=1)
    return vals_s, clen, jnp.sum(cwords), overflow


def encode_ycbcr_rst_stream(blocks_i16, r_mcus: int,
                            cap_per_block: int | None = None,
                            ypm: int = 4):
    """Traceable scatter-free encode of MCU-interleaved YCbCr blocks
    ([Y*ypm, U, V] pattern; ypm = 4 for 4:2:0, 2 for 4:2:2, 1 for
    4:4:4) with a restart interval of r_mcus.

    Luma and chroma blocks are processed as separate slices (static
    strided views of the MCU pattern) so each subset runs only its
    own table's select chains — the per-position symbol work halves
    vs computing both variants and selecting.

    Returns (stream_words sorted-compact, chunk_bits (NC,),
    total_words scalar, overflow flag)."""
    blocks = blocks_i16.astype(jnp.int32)
    n = blocks.shape[0]
    bpm = ypm + 2
    assert n % bpm == 0
    cb = bpm * r_mcus
    by_mcu = blocks.reshape(-1, bpm, 64)
    luma = by_mcu[:, :ypm].reshape(-1, 64)     # (ypm*n_mcus, 64)
    chroma = by_mcu[:, ypm:].reshape(-1, 64)   # (2*n_mcus, 64)

    # DC predictions with per-restart-interval resets (T.81 E.2.4).
    ldc = luma[:, 0]
    ldc_prev = jnp.concatenate([jnp.zeros(1, jnp.int32), ldc[:-1]])
    lidx = jnp.arange(luma.shape[0], dtype=jnp.int32)
    ldc_prev = jnp.where(lidx % (ypm * r_mcus) == 0, 0, ldc_prev)
    cdc = chroma.reshape(-1, 2, 64)[:, :, 0]   # (n_mcus, [U, V])
    cdc_prev = jnp.concatenate(
        [jnp.zeros((1, 2), jnp.int32), cdc[:-1]], axis=0)
    midx = jnp.arange(cdc.shape[0], dtype=jnp.int32)
    cdc_prev = jnp.where((midx % r_mcus == 0)[:, None], 0, cdc_prev)

    lvals, llens = _units_for_blocks(luma, ldc_prev, True)
    cvals, clens = _units_for_blocks(chroma, cdc_prev.reshape(-1), False)

    # Re-interleave per-MCU: [ypm luma, 2 chroma] unit rows.
    vals = jnp.concatenate(
        [lvals.reshape(-1, ypm, 65), cvals.reshape(-1, 2, 65)],
        axis=1).reshape(-1, 65)
    lens = jnp.concatenate(
        [llens.reshape(-1, ypm, 65), clens.reshape(-1, 2, 65)],
        axis=1).reshape(-1, 65)

    words, blen, overflow = _block_word_buffers(vals, lens)
    sw, clen, total, covf = _rst_assemble(words, blen, cb, cap_per_block)
    return sw, clen, total, overflow | covf


def encode_yuv420_rst_stream(blocks_i16, r_mcus: int,
                             cap_per_block: int | None = None):
    """4:2:0 entry (the batched JPEG/R production path)."""
    return encode_ycbcr_rst_stream(blocks_i16, r_mcus, cap_per_block,
                                   ypm=4)


def encode_gray_rst_stream(blocks_i16, r_mcus: int,
                           cap_per_block: int | None = None):
    """Grayscale variant of the scatter-free path: MCU = 1 block."""
    blocks = blocks_i16.astype(jnp.int32)
    n = blocks.shape[0]
    dc = blocks[:, 0]
    dc_prev = jnp.concatenate([jnp.zeros(1, jnp.int32), dc[:-1]])
    gidx = jnp.arange(n, dtype=jnp.int32)
    dc_prev = jnp.where(gidx % r_mcus == 0, 0, dc_prev)
    vals, lens = _units_for_blocks(blocks, dc_prev, True)
    words, blen, overflow = _block_word_buffers(vals, lens)
    sw, clen, total, covf = _rst_assemble(words, blen, r_mcus,
                                          cap_per_block)
    return sw, clen, total, overflow | covf


@lru_cache(maxsize=None)
def _rst_kernel_ycbcr(n_blocks: int, r_mcus: int, ypm: int = 4):
    return jax.jit(partial(encode_ycbcr_rst_stream, r_mcus=r_mcus,
                           ypm=ypm))


def _rst_kernel_yuv420(n_blocks: int, r_mcus: int):
    return _rst_kernel_ycbcr(n_blocks, r_mcus, 4)


@lru_cache(maxsize=None)
def _rst_kernel_gray(n_blocks: int, r_mcus: int):
    return jax.jit(partial(encode_gray_rst_stream, r_mcus=r_mcus))


def finalize_rst_stream(stream_words: np.ndarray, chunk_bits: np.ndarray,
                        r_mcus: int) -> bytes:
    """Host tail for the RST path: split compact words into chunks,
    strip word-alignment fill, byte-stuff data, join with RSTn markers.
    Fully vectorized (a per-chunk Python loop costs ~100 ms/frame at
    4K). stream_words: the used prefix (>= total words)."""
    chunk_bits = np.asarray(chunk_bits, np.int64)
    nc = len(chunk_bits)
    cwords = (chunk_bits + 31) >> 5
    dbytes = (chunk_bits + 7) >> 3
    word_bases = np.concatenate([[0], np.cumsum(cwords)])[:-1]
    raw = np.frombuffer(
        np.ascontiguousarray(stream_words).astype(">u4").tobytes(),
        np.uint8)

    # Keep only data bytes (drop per-chunk word-alignment fill).
    byte_idx = np.arange(len(raw), dtype=np.int64)
    chunk_of = np.zeros(len(raw), np.int64)
    np.add.at(chunk_of, word_bases[1:] * 4, 1)
    chunk_of = np.cumsum(chunk_of)
    rel = byte_idx - word_bases[chunk_of] * 4
    data = raw[rel < dbytes[chunk_of]]

    # Byte-stuff: 0x00 after every data 0xFF (applies inside chunks;
    # chunk boundaries tracked through stuffed lengths).
    chunk_of_data = chunk_of[rel < dbytes[chunk_of]]
    ff_pos = np.flatnonzero(data == 0xFF)
    nff_per_chunk = np.bincount(chunk_of_data[ff_pos], minlength=nc) \
        if ff_pos.size else np.zeros(nc, np.int64)
    if ff_pos.size:
        data = np.insert(data, ff_pos + 1, 0)

    if nc == 1:
        return data.tobytes()

    # Insert RSTn between chunks at stuffed boundaries.
    stuffed = dbytes + nff_per_chunk
    bounds = np.cumsum(stuffed)[:-1]
    markers = np.empty((nc - 1, 2), np.uint8)
    markers[:, 0] = 0xFF
    markers[:, 1] = 0xD0 + (np.arange(nc - 1) % 8)
    out = np.insert(data, np.repeat(bounds, 2),
                    markers.reshape(-1))
    return out.tobytes()


def interleave_blocks_device(yz, uz, vz, mcus_x: int, mcus_y: int,
                             hs: int = 2, vs: int = 2):
    """Device-side MCU interleave of per-plane zigzag block arrays
    for luma sampling (hs, vs) with 1x1 chroma ([Y*hs*vs, U, V]).

    yz: (mcus_y*vs * mcus_x*hs, 64) row-major luma blocks;
    uz/vz: chroma block arrays covering at least (mcus_y, mcus_x).
    """
    n = mcus_x * mcus_y
    yb = yz.reshape(mcus_y, vs, mcus_x, hs, 64).transpose(0, 2, 1, 3, 4)
    yb = yb.reshape(n, hs * vs, 64)
    ub = uz.reshape(mcus_y, mcus_x, 64)[:, :, None, :].reshape(n, 1, 64)
    vb = vz.reshape(mcus_y, mcus_x, 64)[:, :, None, :].reshape(n, 1, 64)
    return jnp.concatenate([yb, ub, vb], axis=1).reshape(-1, 64)


def entropy_encode_yuv420_device(blocks_interleaved) -> bytes:
    """Entropy-encode MCU-interleaved 4:2:0 blocks on device; returns
    the stuffed entropy-coded byte segment."""
    n = blocks_interleaved.shape[0]
    assert n % 6 == 0
    kernel = _encode_kernel_yuv420(n // 6)
    words, total_bits = kernel(blocks_interleaved)
    return _finalize(words, total_bits)


def entropy_encode_gray_device(blocks) -> bytes:
    kernel = _encode_kernel_gray(blocks.shape[0])
    words, total_bits = kernel(blocks)
    return _finalize(words, total_bits)
