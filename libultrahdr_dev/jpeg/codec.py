"""In-framework baseline JPEG codec.

Replaces the reference's libjpeg-turbo wrappers
(/root/reference/lib/src/jpegencoderhelper.cpp,
 /root/reference/lib/src/jpegdecoderhelper.cpp) with a split design:
DCT/quantization run on the accelerator (dct.py, batched matmuls), the
sequential Huffman bit stage runs in native C++ on the host
(native/entropy.cpp), and all marker/container work is host Python.

Encoder emits baseline JFIF: YCbCr 4:2:0 with 2x2/1x1/1x1 sampling or
single-component grayscale — the same shapes the reference produces
(jpegencoderhelper.cpp:120-136). Decoder handles baseline sequential
JPEGs (single- or multi-scan) and progressive SOF2, restart intervals
included, with the Huffman stage in native C++ or the pure-Python
fallback (huffman.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..types import err
from ..utils import counters
from . import tables
from .dct import dequant_idct, fdct_quant
from .native import get_lib

MAX_DIM = 8192  # jpegdecoderhelper.h:42-43


# ---------------------------------------------------------------------------
# Shared helpers.
# ---------------------------------------------------------------------------

def _pad_plane(plane: np.ndarray, mult) -> np.ndarray:
    """Edge-replicate pad a plane so dims are multiples of mult
    (an int, or an (hmult, wmult) pair)."""
    hm, wm = (mult, mult) if isinstance(mult, int) else mult
    h, w = plane.shape
    ph = (hm - h % hm) % hm
    pw = (wm - w % wm) % wm
    if ph == 0 and pw == 0:
        return plane
    return np.pad(plane, ((0, ph), (0, pw)), mode="edge")


def _np(x) -> np.ndarray:
    # ascontiguousarray, not asarray: decoded planes feed ctypes
    # consumers (libheif/libavif) that read raw row-major bytes, and a
    # sliced or transposed view is not C-ordered. No copy when it is.
    return np.ascontiguousarray(x)


def _huff_arrays(selections):
    """Pack (bits, vals) table definitions into the [4][17]/[4][256]
    arrays the native codec takes. selections: list of (bits, vals) or
    None per slot."""
    bits = np.zeros((4, 17), np.uint8)
    vals = np.zeros((4, 256), np.uint8)
    for i, sel in enumerate(selections):
        if sel is None:
            continue
        b, v = tables.pack_huff_table(*sel)
        bits[i] = b
        vals[i] = v
    return bits, vals


def _native():
    """The C++ entropy codec, or None (callers use the pure-Python
    fallback in huffman.py)."""
    return get_lib()


def _as_u8p(a):
    import ctypes
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _as_i16p(a):
    import ctypes
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))


def entropy_encode(blocks_zz: np.ndarray, comp_ids: np.ndarray,
                   dc_sel, ac_sel, dc_tables, ac_tables,
                   restart_interval: int, mcu_blocks: int) -> bytes:
    lib = _native()
    if lib is None:
        from . import huffman
        return huffman.huff_encode(
            np.asarray(blocks_zz, np.int64), comp_ids, dc_sel, ac_sel,
            dc_tables, ac_tables, restart_interval, mcu_blocks)
    blocks_zz = np.ascontiguousarray(blocks_zz, np.int16)
    comp_ids = np.ascontiguousarray(comp_ids, np.uint8)
    dcb, dcv = _huff_arrays(dc_tables)
    acb, acv = _huff_arrays(ac_tables)
    dc_sel = np.asarray(dc_sel, np.uint8)
    ac_sel = np.asarray(ac_sel, np.uint8)
    cap = blocks_zz.shape[0] * 64 * 4 + 4096
    out = np.empty(cap, np.uint8)
    n = lib.uhdr_huff_encode(
        _as_i16p(blocks_zz), blocks_zz.shape[0], _as_u8p(comp_ids),
        len(dc_sel), _as_u8p(dc_sel), _as_u8p(ac_sel),
        _as_u8p(dcb), _as_u8p(dcv), _as_u8p(acb), _as_u8p(acv),
        restart_interval, mcu_blocks, _as_u8p(out), cap)
    if n < 0:
        raise err("UHDR_CODEC_ERROR", "entropy encode overflow")
    return out[:n].tobytes()


def entropy_decode(data: bytes, nblocks: int, comp_ids: np.ndarray,
                   dc_sel, ac_sel, dc_tables, ac_tables,
                   restart_interval: int, mcu_blocks: int) -> np.ndarray:
    lib = _native()
    if lib is None:
        from . import huffman
        try:
            return huffman.huff_decode(
                data, nblocks, comp_ids, dc_sel, ac_sel, dc_tables,
                ac_tables, restart_interval, mcu_blocks)
        except (ValueError, IndexError) as e:
            raise err("UHDR_CODEC_ERROR", f"entropy decode failed: {e}")
    buf = np.frombuffer(data, np.uint8)
    comp_ids = np.ascontiguousarray(comp_ids, np.uint8)
    dcb, dcv = _huff_arrays(dc_tables)
    acb, acv = _huff_arrays(ac_tables)
    dc_sel = np.asarray(dc_sel, np.uint8)
    ac_sel = np.asarray(ac_sel, np.uint8)
    out = np.zeros((nblocks, 64), np.int16)
    rc = lib.uhdr_huff_decode(
        _as_u8p(buf), len(buf), nblocks, _as_u8p(comp_ids),
        len(dc_sel), _as_u8p(dc_sel), _as_u8p(ac_sel),
        _as_u8p(dcb), _as_u8p(dcv), _as_u8p(acb), _as_u8p(acv),
        restart_interval, mcu_blocks, _as_i16p(out))
    if rc != 0:
        raise err("UHDR_CODEC_ERROR", f"entropy decode failed at block {-rc}")
    return out


# ---------------------------------------------------------------------------
# Encoder.
# ---------------------------------------------------------------------------

def _marker(m: int, payload: bytes) -> bytes:
    length = len(payload) + 2
    return bytes([0xFF, m, length >> 8, length & 0xFF]) + payload


def _dqt(tbl_id: int, q_natural: np.ndarray) -> bytes:
    zz = q_natural.reshape(64)[tables.ZIGZAG]
    return bytes([tbl_id]) + bytes(int(v) for v in zz)


def _dht(cls: int, tbl_id: int, bits, vals) -> bytes:
    return bytes([(cls << 4) | tbl_id]) + bytes(bits) + bytes(vals)


def _sof0(w: int, h: int, comps) -> bytes:
    # comps: list of (id, h_samp, v_samp, qtbl)
    out = bytes([8, h >> 8, h & 0xFF, w >> 8, w & 0xFF, len(comps)])
    for cid, hs, vs, q in comps:
        out += bytes([cid, (hs << 4) | vs, q])
    return out


def _sos(comps) -> bytes:
    # comps: list of (id, dc_tbl, ac_tbl)
    out = bytes([len(comps)])
    for cid, dc, ac in comps:
        out += bytes([cid, (dc << 4) | ac])
    out += bytes([0, 63, 0])
    return out


def _jfif_app0() -> bytes:
    return _marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")


def _interleave_ycbcr(yb, ub, vb, mcus_x: int, mcus_y: int,
                      hs: int, vs: int):
    """Build the MCU-interleaved block array for hsxvs/1x1/1x1 sampling
    (4:2:0, 4:2:2 or 4:4:4).

    yb: (mcus_y*vs, mcus_x*hs, 64) block grid; ub/vb: (mcus_y, mcus_x,
    64). Returns (blocks, comp_ids) with hs*vs+2 blocks per MCU.
    """
    n = mcus_x * mcus_y
    yl = (yb.reshape(mcus_y, vs, mcus_x, hs, 64)
          .transpose(0, 2, 1, 3, 4)          # (my, mx, vy, vx, 64)
          .reshape(n, hs * vs, 64))
    blocks = np.concatenate(
        [yl, ub.reshape(n, 1, 64), vb.reshape(n, 1, 64)], axis=1)
    comp_ids = np.tile(
        np.array([0] * (hs * vs) + [1, 2], np.uint8), n)
    return blocks.reshape(-1, 64), comp_ids


def gray_jpeg_headers(w: int, h: int, quality: int,
                      icc: bytes | None = None,
                      restart_interval: int = 0,
                      arithmetic: bool = False) -> bytes:
    """All markers up to (and including) SOS for a grayscale image."""
    ql = tables.scale_quant_table(tables.STD_LUMINANCE_QUANT, quality)
    out = bytearray()
    out += b"\xff\xd8"
    out += _jfif_app0()
    if icc:
        out += _marker(0xE2, icc)
    out += _marker(0xDB, _dqt(0, ql))
    if arithmetic:
        out += _marker(0xC9, _sof0(w, h, [(1, 1, 1, 0)]))
        out += _marker(0xCC, bytes([0x00, 0x10, 0x10, 5]))
    else:
        out += _marker(0xC0, _sof0(w, h, [(1, 1, 1, 0)]))
        out += _marker(0xC4, _dht(0, 0, tables.DC_LUMA_BITS,
                                  tables.DC_LUMA_VALS))
        out += _marker(0xC4, _dht(1, 0, tables.AC_LUMA_BITS,
                                  tables.AC_LUMA_VALS))
    if restart_interval:
        out += _marker(0xDD, restart_interval.to_bytes(2, "big"))
    out += _marker(0xDA, _sos([(1, 0, 0)]))
    return bytes(out)


def yuv420_jpeg_headers(w: int, h: int, quality: int,
                        icc: bytes | None = None,
                        restart_interval: int = 0) -> bytes:
    """All markers up to (and including) SOS for 4:2:0 YCbCr."""
    return ycbcr_jpeg_headers(w, h, quality, (2, 2), icc,
                              restart_interval)


def ycbcr_jpeg_headers(w: int, h: int, quality: int,
                       sampling: tuple[int, int],
                       icc: bytes | None = None,
                       restart_interval: int = 0,
                       arithmetic: bool = False) -> bytes:
    """All markers up to (and including) SOS for YCbCr with luma
    sampling factors `sampling` = (h, v) in {(2,2), (2,1), (1,1)}
    (4:2:0 / 4:2:2 / 4:4:4); chroma is always 1x1."""
    hs, vs = sampling
    ql = tables.scale_quant_table(tables.STD_LUMINANCE_QUANT, quality)
    qc = tables.scale_quant_table(tables.STD_CHROMINANCE_QUANT, quality)
    out = bytearray()
    out += b"\xff\xd8"
    out += _jfif_app0()
    if icc:
        out += _marker(0xE2, icc)
    out += _marker(0xDB, _dqt(0, ql))
    out += _marker(0xDB, _dqt(1, qc))
    sof = _sof0(w, h, [(1, hs, vs, 0), (2, 1, 1, 1), (3, 1, 1, 1)])
    if arithmetic:
        out += _marker(0xC9, sof)
        out += _marker(0xCC, bytes([0x00, 0x10, 0x01, 0x10,
                                    0x10, 5, 0x11, 5]))
    else:
        out += _marker(0xC0, sof)
        out += _marker(0xC4, _dht(0, 0, tables.DC_LUMA_BITS,
                                  tables.DC_LUMA_VALS))
        out += _marker(0xC4, _dht(1, 0, tables.AC_LUMA_BITS,
                                  tables.AC_LUMA_VALS))
        out += _marker(0xC4, _dht(0, 1, tables.DC_CHROMA_BITS,
                                  tables.DC_CHROMA_VALS))
        out += _marker(0xC4, _dht(1, 1, tables.AC_CHROMA_BITS,
                                  tables.AC_CHROMA_VALS))
    if restart_interval:
        out += _marker(0xDD, restart_interval.to_bytes(2, "big"))
    out += _marker(0xDA, _sos([(1, 0, 0), (2, 1, 1), (3, 1, 1)]))
    return bytes(out)


# Below this pixel count the host native entropy encoder's single-
# digit-ms cost beats the device dispatch; above it the scatter-free
# device assembly runs (its output is byte-identical, tested).
_DEVICE_ENCODE_MIN_PIXELS = 1 << 20

# The device codec paths only pay off on an accelerator: on the CPU
# backend the "device" kernels are XLA while-loops that compile per
# geometry and run far slower than the native C++ codec. Tests set
# this True to exercise the device paths on the CPU mesh.
_DEVICE_CODEC_ON_CPU = False


def _accel_backend() -> bool:
    """True when the live default JAX backend is an accelerator."""
    if _DEVICE_CODEC_ON_CPU:
        return True
    import jax

    return jax.default_backend() != "cpu"


def _device_entropy_route(w: int, h: int, restart_interval: int,
                          arithmetic: bool) -> bool:
    """True when a frame's restart-marker entropy coding runs on the
    device. Frames below _DEVICE_ENCODE_MIN_PIXELS stay on the host
    encoder, and the counter says how many did."""
    if arithmetic or not restart_interval or not _accel_backend():
        return False
    if w * h < _DEVICE_ENCODE_MIN_PIXELS:
        counters.bump("encode_entropy_host_small_frame")
        return False
    return True


def _device_rst_entropy(blocks: np.ndarray, restart_interval: int,
                        ypm: int | None) -> bytes | None:
    """Entropy-code MCU-interleaved zigzag blocks on device via the
    scatter-free restart-marker assembly (Annex-K tables — the only
    tables this encoder emits). ypm = luma blocks per MCU, None for
    grayscale. Returns the stuffed entropy segment (RSTn markers
    included), or None when dense content overflows the device word
    buffers (the caller then encodes on the host)."""
    import jax.numpy as jnp

    from . import device_entropy as de

    b = jnp.asarray(np.ascontiguousarray(blocks, np.int16))
    if ypm is None:
        kern = de._rst_kernel_gray(blocks.shape[0], restart_interval)
    else:
        kern = de._rst_kernel_ycbcr(blocks.shape[0], restart_interval,
                                    ypm)
    sw, cbits, total, ovf = kern(b)
    if bool(ovf):
        counters.bump("encode_entropy_overflow_host")
        return None
    return de.finalize_rst_stream(np.asarray(sw[:int(total)]),
                                  np.asarray(cbits), restart_interval)


def assemble_gray_jpeg(yz: np.ndarray, w: int, h: int, quality: int,
                       icc: bytes | None = None,
                       restart_interval: int = 0,
                       arithmetic: bool = False) -> bytes:
    """Host stage: marker emission + entropy coding for a grayscale
    image whose zigzag coefficients (for the 8-padded plane) were
    already computed on device."""
    out = bytearray(gray_jpeg_headers(w, h, quality, icc,
                                      restart_interval, arithmetic))
    comp_ids = np.zeros(yz.shape[0], np.uint8)
    if _device_entropy_route(w, h, restart_interval, arithmetic):
        seg = _device_rst_entropy(yz, restart_interval, None)
        if seg is not None:
            out += seg
            out += b"\xff\xd9"
            return bytes(out)
    if arithmetic:
        from . import arith as ar
        out += ar.encode_seq_scan(
            np.ascontiguousarray(yz, np.int16), comp_ids, [0], [0],
            {0: ar.DEFAULT_DC_COND}, {0: ar.DEFAULT_AC_COND},
            restart_interval, 1)
    else:
        out += entropy_encode(
            yz, comp_ids, [0], [0],
            [(tables.DC_LUMA_BITS, tables.DC_LUMA_VALS)],
            [(tables.AC_LUMA_BITS, tables.AC_LUMA_VALS)],
            restart_interval, 1)
    out += b"\xff\xd9"
    return bytes(out)


def assemble_yuv420_jpeg(yz: np.ndarray, uz: np.ndarray, vz: np.ndarray,
                         w: int, h: int, quality: int,
                         icc: bytes | None = None,
                         restart_interval: int = 0) -> bytes:
    return assemble_ycbcr_jpeg(yz, uz, vz, w, h, quality, (2, 2), icc,
                               restart_interval)


def assemble_ycbcr_jpeg(yz: np.ndarray, uz: np.ndarray, vz: np.ndarray,
                        w: int, h: int, quality: int,
                        sampling: tuple[int, int] = (2, 2),
                        icc: bytes | None = None,
                        restart_interval: int = 0,
                        arithmetic: bool = False) -> bytes:
    """Host stage for YCbCr: MCU interleave + markers + entropy.
    sampling = luma (h, v) factors; yz covers the MCU-aligned luma
    plane, uz/vz the 8-aligned chroma planes at their natural size."""
    hs, vs = sampling
    yp_h, yp_w = _align(h, 8 * vs), _align(w, 8 * hs)
    cp_h = _align(-(-h // vs), 8)
    cp_w = _align(-(-w // hs), 8)
    mcus_x, mcus_y = yp_w // (8 * hs), yp_h // (8 * vs)
    yb = yz.reshape(yp_h // 8, yp_w // 8, 64)
    ub = uz.reshape(cp_h // 8, cp_w // 8, 64)
    vb = vz.reshape(cp_h // 8, cp_w // 8, 64)
    blocks, comp_ids = _interleave_ycbcr(
        yb, ub[:mcus_y, :mcus_x], vb[:mcus_y, :mcus_x], mcus_x, mcus_y,
        hs, vs)

    out = bytearray(ycbcr_jpeg_headers(w, h, quality, sampling, icc,
                                       restart_interval, arithmetic))
    if _device_entropy_route(w, h, restart_interval, arithmetic):
        seg = _device_rst_entropy(blocks, restart_interval, hs * vs)
        if seg is not None:
            out += seg
            out += b"\xff\xd9"
            return bytes(out)
    if arithmetic:
        from . import arith as ar
        out += ar.encode_seq_scan(
            np.ascontiguousarray(blocks, np.int16), comp_ids,
            [0, 1, 1], [0, 1, 1],
            {0: ar.DEFAULT_DC_COND, 1: ar.DEFAULT_DC_COND},
            {0: ar.DEFAULT_AC_COND, 1: ar.DEFAULT_AC_COND},
            restart_interval, hs * vs + 2)
    else:
        out += entropy_encode(
            blocks, comp_ids, [0, 1, 1], [0, 1, 1],
            [(tables.DC_LUMA_BITS, tables.DC_LUMA_VALS),
             (tables.DC_CHROMA_BITS, tables.DC_CHROMA_VALS)],
            [(tables.AC_LUMA_BITS, tables.AC_LUMA_VALS),
             (tables.AC_CHROMA_BITS, tables.AC_CHROMA_VALS)],
            restart_interval, hs * vs + 2)
    out += b"\xff\xd9"
    return bytes(out)


def _align(x: int, m: int) -> int:
    return -(-x // m) * m


def _infer_sampling(y_shape, u_shape) -> tuple[int, int]:
    """Luma sampling factors from the chroma plane's size relative to
    luma: (2,2)=4:2:0, (2,1)=4:2:2, (1,1)=4:4:4. For odd luma dims
    both ceil-half and floor-half chroma planes count as subsampled
    (RawImage carries floor-half planes; assembly edge-pads the
    missing row/column)."""
    h, w = y_shape
    ch, cw = u_shape
    hs = (2 if w > 1 and cw in ((w + 1) // 2, w // 2)
          else 1 if cw == w else 0)
    vs = (2 if h > 1 and ch in ((h + 1) // 2, h // 2)
          else 1 if ch == h else 0)
    if not hs or not vs or (hs, vs) == (1, 2):
        raise err("UHDR_CODEC_INVALID_PARAM",
                  f"unsupported chroma geometry {cw}x{ch} for luma "
                  f"{w}x{h} (expected 4:2:0, 4:2:2 or 4:4:4)")
    return hs, vs


def encode_jpeg(planes: dict, quality: int, icc: bytes | None = None,
                restart_interval: int = 0,
                sampling: tuple[int, int] | None = None,
                arithmetic: bool = False) -> bytes:
    """Encode YCbCr planes {y,u,v} or grayscale {y} to baseline JFIF.

    Chroma subsampling is inferred from the chroma planes' shape
    (half/half = 4:2:0, half-width = 4:2:2, full = 4:4:4) unless
    `sampling` pins the luma factors explicitly. The reference encodes
    4:2:0 and grayscale only (jpegencoderhelper.cpp:120-136); 4:2:2 and
    4:4:4 are this framework's extension (its decoder — like the
    reference's libjpeg — accepts all three).

    Emits the same structure the reference's encoder produces: optional
    ICC as a single APP2 right after APP0 (jpegencoderhelper.cpp:98-100).
    """
    y = _np(planes["y"])
    h, w = y.shape
    if h > MAX_DIM or w > MAX_DIM:
        raise err("UHDR_CODEC_INVALID_PARAM", f"dims too large {w}x{h}")
    gray = "u" not in planes

    ql = tables.scale_quant_table(tables.STD_LUMINANCE_QUANT, quality)
    if gray:
        yz = _np(fdct_quant(_pad_plane(y, 8), ql))
        return assemble_gray_jpeg(yz, w, h, quality, icc,
                                  restart_interval, arithmetic)

    qc = tables.scale_quant_table(tables.STD_CHROMINANCE_QUANT, quality)
    u = _np(planes["u"])
    v = _np(planes["v"])
    if u.shape != v.shape:
        raise err("UHDR_CODEC_INVALID_PARAM", "u/v shape mismatch")
    hs, vs = _infer_sampling(y.shape, u.shape)
    if sampling is not None and tuple(sampling) != (hs, vs):
        raise err("UHDR_CODEC_INVALID_PARAM",
                  f"requested sampling {tuple(sampling)} inconsistent "
                  f"with plane geometry (implies {(hs, vs)})")
    yp = _pad_plane(y, (8 * vs, 8 * hs))
    # Chroma planes must cover yp at their sampling, 8-block aligned.
    ch, cw = yp.shape[0] // vs, yp.shape[1] // hs
    up = _pad_plane(np.pad(u, ((0, ch - u.shape[0]),
                               (0, cw - u.shape[1])), mode="edge"), 8)
    vp = _pad_plane(np.pad(v, ((0, ch - v.shape[0]),
                               (0, cw - v.shape[1])), mode="edge"), 8)
    yz = _np(fdct_quant(yp, ql))
    uz = _np(fdct_quant(up, qc))
    vz = _np(fdct_quant(vp, qc))
    return assemble_ycbcr_jpeg(yz, uz, vz, w, h, quality, (hs, vs),
                               icc, restart_interval, arithmetic)


# ---------------------------------------------------------------------------
# Decoder.
# ---------------------------------------------------------------------------

@dataclass
class _Component:
    cid: int
    h: int
    v: int
    qtbl: int
    dc_tbl: int = 0
    ac_tbl: int = 0


@dataclass
class DecodedJpeg:
    width: int
    height: int
    ncomp: int
    planes: list = field(default_factory=list)  # u8 arrays, natural sizes
    sampling: list = field(default_factory=list)  # (h, v) per component
    icc: bytes | None = None
    exif: bytes | None = None
    xmp: bytes | None = None


@dataclass
class DecodedCoefs:
    """Entropy-decoded (host) stage output: per-component zigzag
    coefficient block grids, ready for device dequant/IDCT."""

    width: int
    height: int
    ncomp: int
    # per component: (coefs (bh, bw, 64) int16 zigzag, qtable 8x8,
    #                 crop_h, crop_w, (h_samp, v_samp))
    comps: list = field(default_factory=list)
    icc: bytes | None = None
    exif: bytes | None = None
    xmp: bytes | None = None



def _parse_dht(payload: bytes, dc_tables: dict, ac_tables: dict):
    """Parse one DHT payload with full validation — the native table
    builder trusts bits[]/vals[] shapes, so corrupt definitions
    (sum(bits) > 256, truncated vals, non-canonical code counts) must
    be rejected here, not segfault there."""
    pos = 0
    while pos < len(payload):
        tc, th = payload[pos] >> 4, payload[pos] & 15
        pos += 1
        if tc > 1 or th > 3 or pos + 16 > len(payload):
            raise err("UHDR_CODEC_ERROR", "bad DHT header")
        bits = list(payload[pos:pos + 16])
        pos += 16
        nvals = sum(bits)
        if nvals > 256 or pos + nvals > len(payload):
            raise err("UHDR_CODEC_ERROR", "bad DHT code counts")
        code = 0
        for length in range(1, 17):
            code += bits[length - 1]
            if code > (1 << length):
                raise err("UHDR_CODEC_ERROR",
                          "non-canonical DHT code counts")
            code <<= 1
        vals = list(payload[pos:pos + nvals])
        pos += nvals
        (dc_tables if tc == 0 else ac_tables)[th] = (bits, vals)


def decode_jpeg_coefs(data: bytes) -> DecodedCoefs:
    """Host stage of decode: marker parse + native Huffman decode +
    MCU de-interleave. No device work — callers fuse dequant/IDCT with
    downstream pixel math in one jit (e.g. JpegR decode)."""
    from ..container import jfif

    segments, sos_end = jfif.scan_segments(data, 0)
    qtables: dict[int, np.ndarray] = {}
    dc_tables: dict[int, tuple] = {}
    ac_tables: dict[int, tuple] = {}
    comps: list[_Component] = []
    w = h = 0
    restart_interval = 0
    progressive = False
    arith = False
    result = DecodedCoefs(0, 0, 0)
    scan_comps: list[int] = []

    for seg in segments:
        if seg.marker == 0xDB:  # DQT
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
        elif seg.marker == 0xC4:  # DHT
            _parse_dht(seg.payload, dc_tables, ac_tables)
        elif seg.marker in (0xC0, 0xC1):  # SOF0/1 baseline(-ish)
            p = seg.payload
            if len(p) < 6 or len(p) < 6 + p[5] * 3:
                raise err("UHDR_CODEC_ERROR", "truncated SOF header")
            h = (p[1] << 8) | p[2]
            w = (p[3] << 8) | p[4]
            nc = p[5]
            comps = []
            for i in range(nc):
                cid, samp, qt = p[6 + i * 3], p[7 + i * 3], p[8 + i * 3]
                comps.append(_Component(cid, samp >> 4, samp & 15, qt))
        elif seg.marker in (0xC2, 0xC9, 0xCA):
            # SOF2 progressive Huffman; SOF9/SOF10 sequential/
            # progressive arithmetic (T.81 Annex D/F/G — the reference
            # decodes these through libjpeg-turbo's jdarith,
            # jpegdecoderhelper.cpp:422).
            p = seg.payload
            if len(p) < 6 or len(p) < 6 + p[5] * 3:
                raise err("UHDR_CODEC_ERROR", "truncated SOF header")
            h = (p[1] << 8) | p[2]
            w = (p[3] << 8) | p[4]
            comps = []
            for i in range(p[5]):
                cid, samp, qt = p[6 + i * 3], p[7 + i * 3], p[8 + i * 3]
                comps.append(_Component(cid, samp >> 4, samp & 15, qt))
            progressive = seg.marker in (0xC2, 0xCA)
            arith = seg.marker in (0xC9, 0xCA)
        elif seg.marker in set(range(0xC3, 0xD0)) - {0xC4, 0xC8, 0xCC}:
            raise err("UHDR_CODEC_UNSUPPORTED_FEATURE",
                      f"SOF marker {seg.marker:#x} not supported")
        elif seg.marker == 0xDD:  # DRI
            restart_interval = int.from_bytes(seg.payload[:2], "big")
        elif seg.marker == 0xDA:  # SOS
            p = seg.payload
            if len(p) < 1 or len(p) < 1 + p[0] * 2:
                raise err("UHDR_CODEC_ERROR", "truncated SOS header")
            ns = p[0]
            scan_comps = []
            for i in range(ns):
                cid, sel = p[1 + i * 2], p[2 + i * 2]
                for c in comps:
                    if c.cid == cid:
                        c.dc_tbl, c.ac_tbl = sel >> 4, sel & 15
                        scan_comps.append(comps.index(c))
        elif seg.marker == 0xE1:
            if seg.payload.startswith(jfif.EXIF_SIG) and result.exif is None:
                result.exif = seg.payload
            elif seg.payload.startswith(jfif.XMP_SIG) and result.xmp is None:
                result.xmp = seg.payload
        elif seg.marker == 0xE2:
            if seg.payload.startswith(jfif.ICC_SIG) and result.icc is None:
                result.icc = seg.payload

    if not comps or w == 0 or h == 0:
        raise err("UHDR_CODEC_ERROR", "no frame header found")
    if w > MAX_DIM or h > MAX_DIM:
        raise err("UHDR_CODEC_ERROR", f"image too large {w}x{h}")
    if progressive or arith:
        # Arithmetic files (even single-scan sequential) share the
        # scan-by-scan orchestration so DAC markers between scans are
        # honored.
        result.width, result.height = w, h
        return _decode_multiscan(data, result, comps, w, h, qtables,
                                 progressive=progressive, arith=arith)
    if len(scan_comps) != len(comps):
        # Multi-scan baseline (T.81 allows several SOS, each covering a
        # component subset); decode scan-by-scan like progressive.
        result.width, result.height = w, h
        return _decode_multiscan(data, result, comps, w, h, qtables,
                                 progressive=False)

    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    mcus_x = -(-w // (8 * hmax))
    mcus_y = -(-h // (8 * vmax))

    if len(comps) == 1:
        # Non-interleaved single-component scan: MCU = one block.
        c = comps[0]
        bw = -(-w // 8)
        bh = -(-h // 8)
        nblocks = bw * bh
        comp_ids = np.zeros(nblocks, np.uint8)
        mcu_blocks = 1
        per_comp_layout = [(bh, bw)]
    else:
        per_comp_layout = [(mcus_y * c.v, mcus_x * c.h) for c in comps]
        mcu_blocks = sum(c.h * c.v for c in comps)
        nblocks = mcus_x * mcus_y * mcu_blocks
        pattern = []
        for i, c in enumerate(comps):
            pattern += [i] * (c.h * c.v)
        comp_ids = np.tile(np.asarray(pattern, np.uint8), mcus_x * mcus_y)

    entropy = data[sos_end:]
    dc_sel = [c.dc_tbl for c in comps]
    ac_sel = [c.ac_tbl for c in comps]

    def table_list(src: dict, sels):
        out = [None] * 4
        for s in sels:
            if s not in src:
                raise err("UHDR_CODEC_ERROR", f"missing huffman table {s}")
            out[s] = src[s]
        return out

    blocks = entropy_decode(
        entropy, nblocks, comp_ids, dc_sel, ac_sel,
        table_list(dc_tables, dc_sel), table_list(ac_tables, ac_sel),
        restart_interval, mcu_blocks)

    result.width, result.height, result.ncomp = w, h, len(comps)

    if len(comps) == 1:
        c = comps[0]
        if c.qtbl not in qtables:
            raise err("UHDR_CODEC_ERROR", "missing quant table")
        bh, bw = per_comp_layout[0]
        result.comps = [(blocks.reshape(bh, bw, 64), qtables[c.qtbl],
                         h, w, (c.h, c.v))]
        return result

    # De-interleave per component.
    grid = blocks.reshape(mcus_y, mcus_x, mcu_blocks, 64)
    off = 0
    for i, c in enumerate(comps):
        nb = c.h * c.v
        sub = grid[:, :, off:off + nb, :].reshape(mcus_y, mcus_x, c.v, c.h,
                                                  64)
        sub = sub.transpose(0, 2, 1, 3, 4).reshape(mcus_y * c.v,
                                                   mcus_x * c.h, 64)
        off += nb
        if c.qtbl not in qtables:
            raise err("UHDR_CODEC_ERROR", "missing quant table")
        cw = -(-w * c.h // hmax)
        ch = -(-h * c.v // vmax)
        result.comps.append((sub, qtables[c.qtbl], ch, cw, (c.h, c.v)))
    return result


# ---------------------------------------------------------------------------
# Progressive JPEG (SOF2) decoding: multi-scan orchestration over the
# native per-scan decoders (T.81 Annex G.2). The reference inherits
# progressive support from libjpeg (jpegdecoderhelper.cpp uses the
# full jpeg_read_* API); here each scan refines per-component
# coefficient grids host-side and the final dequant/IDCT still runs on
# the device.
# ---------------------------------------------------------------------------

def _entropy_end(data: bytes, start: int) -> int:
    """Offset of the first real marker after entropy data at start.

    Fully vectorized: inside entropy data the second byte of any
    FF-pair is never 0xFF (stuffing pairs are FF 00, restarts FF Dn,
    fill runs chain FF FF.. until the marker byte), so the first 0xFF
    whose successor is not {00, D0-D7, FF} IS the next real marker —
    no left-to-right overlap resolution needed (same argument as
    jfif.find_eoi)."""
    arr = np.frombuffer(data, np.uint8)
    cand = np.flatnonzero(arr[start:len(data) - 1] == 0xFF) + start
    nxt = arr[cand + 1]
    real = cand[(nxt != 0x00) & (nxt != 0xFF)
                & ~((nxt >= 0xD0) & (nxt <= 0xD7))]
    return int(real[0]) if real.size else len(data)


def _parse_dac(payload: bytes, dc_cond: dict, ac_cond: dict):
    """DAC marker (T.81 B.2.4.3): per table class/slot one
    conditioning byte — DC: L = low nibble, U = high nibble
    (0 <= L <= U <= 15); AC: Kx in [1, 63]."""
    pos = 0
    while pos + 1 < len(payload):
        tc, tb = payload[pos] >> 4, payload[pos] & 15
        cs = payload[pos + 1]
        pos += 2
        if tc > 1 or tb > 3:
            raise err("UHDR_CODEC_ERROR", "bad DAC header")
        if tc == 0:
            low, up = cs & 15, cs >> 4
            if low > up:
                raise err("UHDR_CODEC_ERROR",
                          f"bad DC conditioning L={low} U={up}")
            dc_cond[tb] = (low, up)
        else:
            if not 1 <= cs <= 63:
                raise err("UHDR_CODEC_ERROR", f"bad AC conditioning {cs}")
            ac_cond[tb] = cs
    if pos != len(payload):
        # A dangling odd byte is a truncated conditioning entry; the
        # reference's libjpeg errors on a bogus DAC segment length
        # rather than decoding with default conditioning.
        raise err("UHDR_CODEC_ERROR", "truncated DAC segment")


def _decode_multiscan(data: bytes, result: DecodedCoefs,
                      comps: list, w: int, h: int,
                      qtables: dict, progressive: bool,
                      arith: bool = False) -> DecodedCoefs:
    """Run all scans of a progressive (SOF2/SOF10), multi-scan
    baseline, or arithmetic-coded (SOF9/SOF10) JPEG into
    per-component grids."""
    lib = _native()
    import ctypes

    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    mcus_x = -(-w // (8 * hmax))
    mcus_y = -(-h // (8 * vmax))
    if len(comps) == 1:
        grid_dims = [(-(-h // 8), -(-w // 8))]
    else:
        grid_dims = [(mcus_y * c.v, mcus_x * c.h) for c in comps]
    grids = [np.zeros((gh, gw, 64), np.int16) for gh, gw in grid_dims]

    dc_tables: dict[int, tuple] = {}
    ac_tables: dict[int, tuple] = {}
    dc_cond: dict[int, tuple] = {}   # arith DC (L, U) per slot
    ac_cond: dict[int, int] = {}     # arith AC Kx per slot
    restart = 0
    # Cross-scan threading (Huffman progressive only): scans touching
    # disjoint (component, spectral band) state are data-independent
    # — AC scans write only their own component's band, DC scans only
    # band [0,0] — so on a multi-core host they run concurrently
    # (ctypes releases the GIL during the native scan decoders). The
    # reference gets its ingest throughput from libjpeg-turbo's SIMD
    # serial decode; this is the multi-core analog (VERDICT r3 §6).
    prog_tasks = [] if (progressive and not arith
                        and _scan_threads() > 1) else None
    pos = 2
    n = len(data)
    while pos + 4 <= n:
        if data[pos] != 0xFF:
            raise err("UHDR_CODEC_ERROR", "marker sync lost")
        marker = data[pos + 1]
        if marker == 0xFF:  # fill byte before a marker (T.81 B.1.1.2)
            pos += 1
            continue
        if marker == 0xD9:
            break
        if marker in _STANDALONE_PROG:
            pos += 2
            continue
        seg_len = (data[pos + 2] << 8) | data[pos + 3]
        payload = data[pos + 4: pos + 2 + seg_len]
        pos += 2 + seg_len
        if marker == 0xC4:  # DHT
            _parse_dht(payload, dc_tables, ac_tables)
        elif marker == 0xCC:  # DAC (arith conditioning)
            _parse_dac(payload, dc_cond, ac_cond)
        elif marker == 0xDB:  # DQT may be (re)defined between scans
            p2 = 0
            while p2 < len(payload):
                pq, tq = payload[p2] >> 4, payload[p2] & 15
                p2 += 1
                if pq == 0:
                    zz = np.frombuffer(payload[p2:p2 + 64], np.uint8)
                    p2 += 64
                else:
                    zz = np.frombuffer(payload[p2:p2 + 128], ">u2")
                    p2 += 128
                nat = np.zeros(64, np.int32)
                nat[tables.ZIGZAG] = zz
                qtables[tq] = nat.reshape(8, 8)
        elif marker == 0xDD:
            restart = int.from_bytes(payload[:2], "big")
        elif marker == 0xDA:  # SOS
            if len(payload) < 1:
                raise err("UHDR_CODEC_ERROR", "truncated SOS")
            ns = payload[0]
            # Bound-check everything the scan decoders trust: corrupt
            # spectral params (se > 63) would otherwise drive
            # out-of-bounds coefficient writes in the native decoder.
            if not 1 <= ns <= 4 or len(payload) < 4 + ns * 2:
                raise err("UHDR_CODEC_ERROR", f"bad SOS ns={ns}")
            scan = []
            for i in range(ns):
                cid, sel = payload[1 + i * 2], payload[2 + i * 2]
                matches = [i2 for i2, c in enumerate(comps)
                           if c.cid == cid]
                if not matches:
                    raise err("UHDR_CODEC_ERROR",
                              f"SOS references unknown component {cid}")
                if (sel >> 4) > 3 or (sel & 15) > 3:
                    raise err("UHDR_CODEC_ERROR",
                              f"bad table selector {sel:#x}")
                scan.append((matches[0], sel >> 4, sel & 15))
            ss, se = payload[1 + ns * 2], payload[2 + ns * 2]
            a = payload[3 + ns * 2]
            ah, al = a >> 4, a & 15
            if not (ss <= se <= 63 and ah <= 13 and al <= 13):
                raise err("UHDR_CODEC_ERROR",
                          f"bad spectral selection {ss}..{se} "
                          f"ah={ah} al={al}")
            e0 = pos
            e1 = _entropy_end(data, e0)
            pos = e1
            entropy = np.frombuffer(data, np.uint8,
                                    count=e1 - e0, offset=e0)
            arith_cond = (dc_cond, ac_cond) if arith else None
            if progressive and prog_tasks is not None:
                # Deferred for the cross-scan thread scheduler below.
                # Tables/restart can be redefined between scans, so
                # each task snapshots them as-of its SOS.
                prog_tasks.append((entropy, list(scan), ss, se, ah, al,
                                   restart, dict(dc_tables),
                                   dict(ac_tables)))
            elif progressive:
                _run_scan(lib, entropy, scan, comps, grids, grid_dims,
                          mcus_x, mcus_y, ss, se, ah, al, restart,
                          dc_tables, ac_tables, w, h, hmax, vmax,
                          arith_cond)
            else:
                _run_baseline_scan(entropy.tobytes(), scan, comps,
                                   grids, mcus_x, mcus_y, restart,
                                   dc_tables, ac_tables, w, h, hmax,
                                   vmax, arith_cond)

    if prog_tasks:
        _run_prog_tasks_threaded(lib, prog_tasks, comps, grids,
                                 grid_dims, mcus_x, mcus_y, w, h,
                                 hmax, vmax)

    for i, c in enumerate(comps):
        if c.qtbl not in qtables:
            raise err("UHDR_CODEC_ERROR", "missing quant table")
        cw = -(-w * c.h // hmax)
        ch = -(-h * c.v // vmax)
        result.comps.append((grids[i], qtables[c.qtbl], ch, cw,
                             (c.h, c.v)))
    result.ncomp = len(comps)
    return result


def _scan_threads() -> int:
    """Worker count for cross-scan progressive decode; override with
    UHDR_SCAN_THREADS (0/1 = serial)."""
    from ..utils.workers import worker_count

    return worker_count("UHDR_SCAN_THREADS")


def _run_prog_tasks_threaded(lib, tasks, comps, grids, grid_dims,
                             mcus_x, mcus_y, w, h, hmax, vmax):
    """Execute deferred progressive scans on a thread pool, ordering
    only genuinely dependent pairs: scan j waits on earlier scan i iff
    their component sets intersect. Scans on disjoint components write
    disjoint coefficient grids, so they run concurrently (e.g. the
    luma AC scans ∥ both chroma components' scans). Same-component
    scans stay ordered even when their spectral bands are disjoint:
    _run_scan stages through a full-grid copy-in/copy-out, so a
    concurrent same-grid scan would clobber the other band's writes.
    Dependencies always point to earlier submissions, so FIFO workers
    cannot deadlock; errors propagate through the futures."""
    from concurrent.futures import ThreadPoolExecutor

    metas = []     # component sets
    futures = []

    def run_after(deps, task):
        for d in deps:
            d.result()     # re-raises a failed dependency
        entropy, scan, ss, se, ah, al, restart, dcs, acs = task
        _run_scan(lib, entropy, scan, comps, grids, grid_dims,
                  mcus_x, mcus_y, ss, se, ah, al, restart,
                  dcs, acs, w, h, hmax, vmax, None)

    with ThreadPoolExecutor(_scan_threads()) as ex:
        for task in tasks:
            cset = {ci for ci, _, _ in task[1]}
            deps = [futures[i] for i, mc in enumerate(metas)
                    if mc & cset]
            futures.append(ex.submit(run_after, deps, task))
            metas.append(cset)
        for f in futures:
            f.result()


_STANDALONE_PROG = set(range(0xD0, 0xD8)) | {0x01}


def _wrap_prog(fn, *args):
    """Run a pure-Python progressive-scan decoder, mapping its internal
    errors (bad Huffman code / truncated stream) to the library's
    error contract like entropy_decode does for the baseline path."""
    try:
        return fn(*args)
    except (ValueError, IndexError) as e:
        raise err("UHDR_CODEC_ERROR",
                  f"progressive scan failed: {e}") from e


def _scan_order_indices(scan, comps, grid_dims, mcus_x, mcus_y):
    """Flat grid indices (per comp) of blocks in interleaved MCU scan
    order; returns list of (comp_idx, flat_index_array)."""
    out = []
    for ci, _, _ in scan:
        c = comps[ci]
        gh, gw = grid_dims[ci]
        my, mx = np.meshgrid(np.arange(mcus_y), np.arange(mcus_x),
                             indexing="ij")
        vy, hx = np.meshgrid(np.arange(c.v), np.arange(c.h),
                             indexing="ij")
        rows = (my[..., None, None] * c.v + vy)  # (my, mx, v, h)
        colsx = (mx[..., None, None] * c.h + hx)
        out.append((ci, (rows * gw + colsx).reshape(mcus_y, mcus_x, -1)))
    return out


def _run_scan(lib, entropy, scan, comps, grids, grid_dims, mcus_x,
              mcus_y, ss, se, ah, al, restart, dc_tables, ac_tables,
              w, h, hmax, vmax, arith_cond=None):
    import ctypes

    u8p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    i16p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))

    if ss == 0:  # DC scan
        if len(scan) > 1:
            idxmaps = _scan_order_indices(scan, comps, grid_dims,
                                          mcus_x, mcus_y)
            mcu_blocks = sum(comps[ci].h * comps[ci].v
                             for ci, _, _ in scan)
            n_mcus = mcus_x * mcus_y
            nblocks = n_mcus * mcu_blocks
            buf = np.zeros((nblocks, 64), np.int16)
            comp_ids = np.zeros(nblocks, np.uint8)
            # columns occupied by each scan component within an MCU,
            # plus the flat grid index of every block in scan order.
            layout = []  # (ci, buf_row_selector, grid_flat_indices)
            col = 0
            for ci, idx in idxmaps:
                nb = idx.shape[-1]
                sel = (np.arange(n_mcus)[:, None] * mcu_blocks
                       + np.arange(col, col + nb)).reshape(-1)
                gidx = idx.reshape(-1)
                comp_ids[sel] = ci
                buf[sel] = grids[ci].reshape(-1, 64)[gidx]
                layout.append((ci, sel, gidx))
                col += nb
        else:
            # Non-interleaved scan: the block grid is ceil(comp/8) per
            # T.81 A.2.2 — NOT the MCU-padded grid (which overreads
            # blocks when luma dims aren't multiples of 16).
            ci = scan[0][0]
            c = comps[ci]
            cw_b = -(-(-(-w * c.h // hmax)) // 8)
            ch_b = -(-(-(-h * c.v // vmax)) // 8)
            nblocks = ch_b * cw_b
            buf = np.ascontiguousarray(
                grids[ci][:ch_b, :cw_b]).reshape(-1, 64)
            # dc_sel below is indexed by FRAME component id, so a
            # non-interleaved scan must carry its real component index
            # (a chroma DC scan with comp_ids=0 would decode with the
            # luma component's table slot / conditioning).
            comp_ids = np.full(nblocks, ci, np.uint8)
            mcu_blocks = 1

        if ah == 0 and arith_cond is not None:
            from . import arith as ar

            dcd = arith_cond[0]
            dc_sel = np.zeros(len(comps), np.uint8)
            for ci, dsel, _ in scan:
                dc_sel[ci] = dsel
            cond = {s: dcd.get(s, ar.DEFAULT_DC_COND)
                    for s in set(int(x) for x in dc_sel)}
            rc = _wrap_prog(ar.prog_dc_first, entropy.tobytes(), buf,
                            comp_ids, dc_sel, cond, al, restart,
                            mcu_blocks)
        elif ah != 0 and arith_cond is not None:
            from . import arith as ar

            rc = _wrap_prog(ar.prog_dc_refine, entropy.tobytes(), buf,
                            al, restart, mcu_blocks)
        elif ah == 0:
            dcb = np.zeros((4, 17), np.uint8)
            dcv = np.zeros((4, 256), np.uint8)
            dc_sel = np.zeros(len(comps), np.uint8)
            for ci, dsel, _ in scan:
                if dsel not in dc_tables:
                    raise err("UHDR_CODEC_ERROR", "missing DC table")
                b, v = tables.pack_huff_table(*dc_tables[dsel])
                dcb[dsel] = b
                dcv[dsel] = v
                dc_sel[ci] = dsel
            if lib is None:
                from . import huffman
                dct = [None] * 4
                for _, dsel, _ in scan:
                    dct[dsel] = dc_tables[dsel]
                rc = _wrap_prog(huffman.prog_dc_first,
                                entropy.tobytes(), buf, comp_ids,
                                dc_sel, dct, al, restart, mcu_blocks)
            else:
                rc = lib.uhdr_prog_dc_first(
                    u8p(entropy), len(entropy), nblocks, u8p(comp_ids),
                    len(comps), u8p(dc_sel), u8p(dcb.reshape(-1)),
                    u8p(dcv.reshape(-1)), al, restart, mcu_blocks,
                    i16p(buf))
        else:
            if lib is None:
                from . import huffman
                rc = _wrap_prog(huffman.prog_dc_refine,
                                entropy.tobytes(), buf, al, restart,
                                mcu_blocks)
            else:
                rc = lib.uhdr_prog_dc_refine(
                    u8p(entropy), len(entropy), nblocks, al, restart,
                    mcu_blocks, i16p(buf))
        if rc != 0:
            raise err("UHDR_CODEC_ERROR", f"progressive DC scan failed {rc}")

        # write back
        if len(scan) > 1:
            for ci, sel, gidx in layout:
                grids[ci].reshape(-1, 64)[gidx] = buf[sel]
        else:
            grids[ci][:ch_b, :cw_b] = buf.reshape(ch_b, cw_b, 64)
        return

    # AC scan: single component, over its ceil-dims block grid.
    if len(scan) != 1:
        raise err("UHDR_CODEC_ERROR", "interleaved AC scan is illegal")
    ci, _, asel = scan[0]
    c = comps[ci]
    cw_b = -(-(-(-w * c.h // hmax)) // 8)
    ch_b = -(-(-(-h * c.v // vmax)) // 8)
    sub = np.ascontiguousarray(grids[ci][:ch_b, :cw_b])
    if arith_cond is not None:
        from . import arith as ar

        kx = arith_cond[1].get(asel, ar.DEFAULT_AC_COND)
        fn = ar.prog_ac_first if ah == 0 else ar.prog_ac_refine
        args = ((entropy.tobytes(), sub.reshape(-1, 64), kx, ss, se,
                 al, restart) if ah == 0 else
                (entropy.tobytes(), sub.reshape(-1, 64), ss, se, al,
                 restart))
        rc = _wrap_prog(fn, *args)
        if rc != 0:
            raise err("UHDR_CODEC_ERROR",
                      f"progressive AC scan failed {rc}")
        grids[ci][:ch_b, :cw_b] = sub
        return
    if asel not in ac_tables:
        raise err("UHDR_CODEC_ERROR", "missing AC table")
    if lib is None:
        from . import huffman
        fn = (huffman.prog_ac_first if ah == 0
              else huffman.prog_ac_refine)
        rc = _wrap_prog(fn, entropy.tobytes(), sub.reshape(-1, 64),
                        ac_tables[asel], ss, se, al, restart)
    else:
        b, v = tables.pack_huff_table(*ac_tables[asel])
        fn = (lib.uhdr_prog_ac_first if ah == 0
              else lib.uhdr_prog_ac_refine)
        rc = fn(u8p(entropy), len(entropy), ch_b * cw_b, u8p(b), u8p(v),
                ss, se, al, restart, i16p(sub))
    if rc != 0:
        raise err("UHDR_CODEC_ERROR", f"progressive AC scan failed {rc}")
    grids[ci][:ch_b, :cw_b] = sub


def _run_baseline_scan(entropy: bytes, scan, comps, grids, mcus_x,
                       mcus_y, restart, dc_tables, ac_tables, w, h,
                       hmax, vmax, arith_cond=None):
    """Decode one full-precision sequential scan (one SOS of a
    multi-scan SOF0 file, or any SOF9 arithmetic scan when
    `arith_cond` carries the (dc, ac) conditioning dicts) into the
    per-component grids."""
    if len(scan) > 1:
        # Interleaved: the frame's global MCU grid, scan components
        # only (T.81 A.2.3).
        mcu_blocks = sum(comps[ci].h * comps[ci].v for ci, _, _ in scan)
        n_mcus = mcus_x * mcus_y
        nblocks = n_mcus * mcu_blocks
        pattern = []
        for si, (ci, _, _) in enumerate(scan):
            pattern += [si] * (comps[ci].h * comps[ci].v)
        comp_ids = np.tile(np.asarray(pattern, np.uint8), n_mcus)
    else:
        ci = scan[0][0]
        c = comps[ci]
        cw_b = -(-(-(-w * c.h // hmax)) // 8)
        ch_b = -(-(-(-h * c.v // vmax)) // 8)
        nblocks = ch_b * cw_b
        comp_ids = np.zeros(nblocks, np.uint8)
        mcu_blocks = 1

    def table_list(src: dict, sels):
        out = [None] * 4
        for s in sels:
            if s not in src:
                raise err("UHDR_CODEC_ERROR", f"missing huffman table {s}")
            out[s] = src[s]
        return out

    dc_sel = [d for _, d, _ in scan]
    ac_sel = [a for _, _, a in scan]
    if arith_cond is not None:
        from . import arith as ar

        dcd, acd = arith_cond
        blocks = np.zeros((nblocks, 64), np.int16)
        try:
            ar.decode_seq_scan(
                entropy, blocks, comp_ids, dc_sel, ac_sel,
                {s: dcd.get(s, ar.DEFAULT_DC_COND) for s in dc_sel},
                {s: acd.get(s, ar.DEFAULT_AC_COND) for s in ac_sel},
                restart, mcu_blocks)
        except ar.ArithError as e:
            raise err("UHDR_CODEC_ERROR",
                      f"arith decode failed: {e}") from e
    else:
        blocks = entropy_decode(
            entropy, nblocks, comp_ids, dc_sel, ac_sel,
            table_list(dc_tables, dc_sel), table_list(ac_tables, ac_sel),
            restart, mcu_blocks)

    if len(scan) == 1:
        grids[ci][:ch_b, :cw_b] = blocks.reshape(ch_b, cw_b, 64)
        return
    grid = blocks.reshape(mcus_y, mcus_x, mcu_blocks, 64)
    off = 0
    for ci, _, _ in scan:
        c = comps[ci]
        nb = c.h * c.v
        sub = grid[:, :, off:off + nb, :].reshape(
            mcus_y, mcus_x, c.v, c.h, 64)
        sub = sub.transpose(0, 2, 1, 3, 4).reshape(
            mcus_y * c.v, mcus_x * c.h, 64)
        grids[ci][: mcus_y * c.v, : mcus_x * c.h] = sub
        off += nb


# Below this pixel count the host entropy decode costs single-digit
# ms and the device dispatch + per-shape compile would dominate; the
# device path only pays off on large frames.
_DEVICE_DECODE_MIN_PIXELS = 1 << 20


def _decode_jpeg_device_path(data: bytes) -> DecodedJpeg | None:
    """Lane-parallel device decode for qualifying baseline streams (any
    of the three wild samplings, restart markers or not): entropy
    decode + dequant/IDCT fully on device, only the ~stream-sized
    destuffed bytes are uploaded. Returns None when the stream doesn't
    qualify (the caller then decodes on the host)."""
    from . import device_decode as dd

    res = dd.decode_jpeg_device(data)
    if res is None:
        counters.bump("decode_host_unqualified_stream")
        return None
    ds, planes = res
    w, h = ds.width, ds.height
    result = DecodedJpeg(w, h, 1 if ds.gray else 3,
                         icc=ds.icc, exif=ds.exif, xmp=ds.xmp)
    if ds.gray:
        result.planes.append(_np(planes[0])[:h, :w])
        result.sampling.append((1, 1))
        return result
    hs, vs = ds.sampling
    ch, cw = -(-h // vs), -(-w // hs)
    for plane, (ph, pw), samp in zip(
            planes, ((h, w), (ch, cw), (ch, cw)),
            (ds.sampling, (1, 1), (1, 1))):
        result.planes.append(_np(plane)[:ph, :pw])
        result.sampling.append(samp)
    return result


def decode_jpeg(data: bytes) -> DecodedJpeg:
    """Decode a baseline or progressive JPEG to per-component planes
    (no chroma upsampling — JPEG/R consumes 4:2:0 planes directly,
    matching the reference's jpeg_read_raw_data path).

    Large qualifying baseline streams take the device path
    (bit-identical to the host decode, tested); everything else —
    progressive, arithmetic, exotic sampling, corrupt or tiny streams
    — goes through the host entropy decoder."""
    # Cheap size probe (marker walk only): the device path re-parses,
    # so gate just on the SOF dims it would accept.
    from ..container import jfif

    dev = None
    try:
        hdr = jfif.parse_jpeg_info(data)
        big = hdr.width * hdr.height >= _DEVICE_DECODE_MIN_PIXELS
    except Exception:
        big = False
    if _accel_backend():
        if big:
            dev = _decode_jpeg_device_path(data)
        else:
            counters.bump("decode_host_small_frame")
    if dev is not None:
        return dev
    coefs = decode_jpeg_coefs(data)
    result = DecodedJpeg(coefs.width, coefs.height, coefs.ncomp,
                         icc=coefs.icc, exif=coefs.exif, xmp=coefs.xmp)
    for grid, q, ch, cw, samp in coefs.comps:
        bh, bw = grid.shape[0], grid.shape[1]
        plane = _np(dequant_idct(grid.reshape(-1, 64), q, bh * 8, bw * 8))
        result.planes.append(plane[:ch, :cw])
        result.sampling.append(samp)
    return result
