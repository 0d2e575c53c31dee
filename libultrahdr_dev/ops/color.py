"""Color science for the Ultra HDR gain-map codec, as pure JAX.

Re-implements the transfer functions, luminance weights, YUV<->RGB and
gamut-conversion matrices of the reference C++ gainmapmath
(/root/reference/lib/src/gainmapmath.cpp:112-520,
 /root/reference/lib/include/ultrahdr/gainmapmath.h:230-440), redesigned
for the accelerator: every function is vectorized over whole image
planes (structure-of-arrays: separate r/g/b (or y/u/v) float32 arrays
of any broadcastable shape), so XLA fuses the entire pixel pipeline
into a few elementwise loops instead of the reference's scalar
per-pixel function pointers.

The reference evaluates most transfer functions through lookup tables
(gainmapmath.cpp:21-64).  Here the analytic forms replace the table
gathers and are the default throughout the codec; LUT
variants with identical index arithmetic (round-half-up, clamped) are
provided for parity testing against reference behavior.
"""

from __future__ import annotations

import math
from functools import partial

import jax.numpy as jnp
import numpy as np

# ISO/TS 22028-5 suggested default reference diffuse white
# (gainmapmath.h:34-36).
SDR_WHITE_NITS = 203.0
HLG_MAX_NITS = 1000.0
PQ_MAX_NITS = 10000.0

# LUT sizes used by the reference (gainmapmath.h:268-369).
SRGB_INV_OETF_NUM_ENTRIES = 1 << 10
HLG_OETF_NUM_ENTRIES = 1 << 16
HLG_INV_OETF_NUM_ENTRIES = 1 << 12
PQ_OETF_NUM_ENTRIES = 1 << 16
PQ_INV_OETF_NUM_ENTRIES = 1 << 12
GAIN_FACTOR_NUM_ENTRIES = 1 << 10

RGB = tuple  # (r, g, b) arrays; also used for (y, u, v)


def _f32(x):
    return jnp.asarray(x, jnp.float32)


def clamp01(x):
    """Clamp a pixel channel to [0, 1] (gainmapmath.cpp:115-118)."""
    return jnp.clip(x, 0.0, 1.0)


# ---------------------------------------------------------------------------
# Luminance (linear light), per gamut.
# ---------------------------------------------------------------------------

# IEC 61966-2-1/Amd 1:2003 Eq. F.7 (gainmapmath.cpp:121).
SRGB_LUM = (0.2126, 0.7152, 0.0722)
# SMPTE EG 432-1 Eq. 7-8 (gainmapmath.cpp:177).
P3_LUM = (0.20949, 0.72160, 0.06891)
# ITU-R BT.2100-2 Table 5 (gainmapmath.cpp:208).
BT2100_LUM = (0.2627, 0.6780, 0.0593)


def _luminance(coeffs, rgb):
    r, g, b = rgb
    kr, kg, kb = coeffs
    return kr * _f32(r) + kg * _f32(g) + kb * _f32(b)


srgb_luminance = partial(_luminance, SRGB_LUM)
p3_luminance = partial(_luminance, P3_LUM)
bt2100_luminance = partial(_luminance, BT2100_LUM)


# ---------------------------------------------------------------------------
# YUV <-> RGB (gamma-encoded signals), per gamut.
#
# The reference derives each YUV<->RGB pair from (luma coefficients,
# Cb/Cr scale): rgb->yuv computes y = lum(rgb), u = (b-y)/cb, v = (r-y)/cr;
# yuv->rgb inverts it with clamping (gainmapmath.cpp:129-254).
# sRGB uses BT.709 luma, P3 uses BT.601 luma, BT2100 its own.
# ---------------------------------------------------------------------------

_YUV_PARAMS = {
    "bt709": (SRGB_LUM, 1.8556, 1.5748),     # gainmapmath.cpp:129
    "bt601": ((0.299, 0.587, 0.114), 1.772, 1.402),  # gainmapmath.cpp:184-185
    "bt2100": (BT2100_LUM, 1.8814, 1.4746),  # gainmapmath.cpp:215
}


def _rgb_to_yuv(params, rgb):
    (kr, kg, kb), cb, cr = params
    r, g, b = (_f32(c) for c in rgb)
    y = kr * r + kg * g + kb * b
    return (y, (b - y) / cb, (r - y) / cr)


def _yuv_to_rgb(params, yuv):
    (kr, kg, kb), cb, cr = params
    y, u, v = (_f32(c) for c in yuv)
    gcb = kb * cb / kg
    gcr = kr * cr / kg
    r = clamp01(y + cr * v)
    g = clamp01(y - gcb * u - gcr * v)
    b = clamp01(y + cb * u)
    return (r, g, b)


srgb_rgb_to_yuv = partial(_rgb_to_yuv, _YUV_PARAMS["bt709"])
srgb_yuv_to_rgb = partial(_yuv_to_rgb, _YUV_PARAMS["bt709"])
p3_rgb_to_yuv = partial(_rgb_to_yuv, _YUV_PARAMS["bt601"])
p3_yuv_to_rgb = partial(_yuv_to_rgb, _YUV_PARAMS["bt601"])
bt2100_rgb_to_yuv = partial(_rgb_to_yuv, _YUV_PARAMS["bt2100"])
bt2100_yuv_to_rgb = partial(_yuv_to_rgb, _YUV_PARAMS["bt2100"])


# ---------------------------------------------------------------------------
# Transfer functions.
# ---------------------------------------------------------------------------

def srgb_inv_oetf(e_gamma):
    """sRGB gamma -> linear, IEC 61966-2-1 Eq. F.5/F.6
    (gainmapmath.cpp:149-155)."""
    e = _f32(e_gamma)
    lo = e / 12.92
    hi = jnp.power((e + 0.055) / 1.055, 2.4)
    return jnp.where(e <= 0.04045, lo, hi)


def srgb_oetf(x):
    """sRGB linear -> gamma (inverse of srgb_inv_oetf)."""
    x = _f32(x)
    lo = x * 12.92
    hi = 1.055 * jnp.power(jnp.maximum(x, 1e-12), 1.0 / 2.4) - 0.055
    return jnp.where(x <= 0.0031308, lo, hi)


_HLG_A = 0.17883277
_HLG_B = 0.28466892
_HLG_C = 0.55991073


def hlg_oetf(e):
    """Scene linear -> HLG signal, BT.2100-2 Table 5 (gainmapmath.cpp:259-265)."""
    e = _f32(e)
    lo = jnp.sqrt(jnp.maximum(3.0 * e, 0.0))
    hi = _HLG_A * jnp.log(jnp.maximum(12.0 * e - _HLG_B, 1e-12)) + _HLG_C
    return jnp.where(e <= 1.0 / 12.0, lo, hi)


def hlg_inv_oetf(e_gamma):
    """HLG signal -> scene linear, BT.2100-2 Table 5 (gainmapmath.cpp:280-286)."""
    e = _f32(e_gamma)
    lo = (e * e) / 3.0
    hi = (jnp.exp((e - _HLG_C) / _HLG_A) + _HLG_B) / 12.0
    return jnp.where(e <= 0.5, lo, hi)


_PQ_M1 = 2610.0 / 16384.0
_PQ_M2 = 2523.0 / 4096.0 * 128.0
_PQ_C1 = 3424.0 / 4096.0
_PQ_C2 = 2413.0 / 4096.0 * 32.0
_PQ_C3 = 2392.0 / 4096.0 * 32.0


def pq_oetf(e):
    """Normalized linear -> PQ signal, BT.2100-2 Table 4 (gainmapmath.cpp:309-312)."""
    e = _f32(e)
    ep = jnp.power(jnp.maximum(e, 0.0), _PQ_M1)
    out = jnp.power((_PQ_C1 + _PQ_C2 * ep) / (1.0 + _PQ_C3 * ep), _PQ_M2)
    return jnp.where(e <= 0.0, 0.0, out)


_PQ_INV_A = 128.0
_PQ_INV_B = 107.0
_PQ_INV_C = 2413.0
_PQ_INV_D = 2392.0
_PQ_INV_E = 6.2773946361
_PQ_INV_F = 0.0126833


def pq_inv_oetf(e_gamma):
    """PQ signal -> normalized linear (gainmapmath.cpp:330-338).

    Matches the reference's crush-to-zero below 1e-4.
    """
    e = _f32(e_gamma)
    ef = jnp.power(jnp.maximum(e, 1e-5), _PQ_INV_F)
    num = _PQ_INV_A * ef - _PQ_INV_B
    den = _PQ_INV_C - _PQ_INV_D * ef
    out = jnp.power(jnp.maximum(num / den, 0.0), _PQ_INV_E)
    return jnp.where(e <= 0.0001, 0.0, out)


def identity(x):
    return _f32(x)


def apply_channelwise(fn, rgb):
    """Apply a scalar transfer function to each channel of an (r, g, b) tuple."""
    return tuple(fn(c) for c in rgb)


# ---------------------------------------------------------------------------
# LUT variants — identical quantization to the reference tables
# (index = round-half-up(x * (N-1)), clamped), for parity tests.
# ---------------------------------------------------------------------------

# Host-side numpy replicas of the transfer functions, used only to
# build LUT constants (tables must be materialized with concrete math —
# calling the jnp forms during a jit trace would capture tracers).

def _np_srgb_inv_oetf(x):
    x = np.asarray(x, np.float32)
    return np.where(x <= 0.04045, x / np.float32(12.92),
                    ((x + np.float32(0.055)) / np.float32(1.055))
                    ** np.float32(2.4)).astype(np.float32)


def _np_hlg_oetf(x):
    x = np.asarray(x, np.float32)
    return np.where(x <= 1.0 / 12.0, np.sqrt(np.maximum(3.0 * x, 0.0)),
                    _HLG_A * np.log(np.maximum(12.0 * x - _HLG_B, 1e-12))
                    + _HLG_C).astype(np.float32)


def _np_hlg_inv_oetf(x):
    x = np.asarray(x, np.float32)
    return np.where(x <= 0.5, x * x / 3.0,
                    (np.exp((x - _HLG_C) / _HLG_A) + _HLG_B) / 12.0
                    ).astype(np.float32)


def _np_pq_oetf(x):
    x = np.asarray(x, np.float32)
    ep = np.maximum(x, 0.0) ** _PQ_M1
    out = ((_PQ_C1 + _PQ_C2 * ep) / (1.0 + _PQ_C3 * ep)) ** _PQ_M2
    return np.where(x <= 0.0, 0.0, out).astype(np.float32)


def _np_pq_inv_oetf(x):
    x = np.asarray(x, np.float32)
    ef = np.maximum(x, 1e-5) ** _PQ_INV_F
    out = np.maximum((_PQ_INV_A * ef - _PQ_INV_B)
                     / (_PQ_INV_C - _PQ_INV_D * ef), 0.0) ** _PQ_INV_E
    return np.where(x <= 0.0001, 0.0, out).astype(np.float32)


_LUTS: dict = {}


def _lut_lookup(name, np_fn, n, x):
    if name not in _LUTS:
        xs = np.arange(n, dtype=np.float32) / np.float32(n - 1)
        _LUTS[name] = np.asarray(np_fn(xs), np.float32)
    table = jnp.asarray(_LUTS[name])
    idx = jnp.clip((_f32(x) * (n - 1) + 0.5).astype(jnp.int32), 0, n - 1)
    return jnp.take(table, idx)


def srgb_inv_oetf_lut(x):
    return _lut_lookup("srgb_inv", _np_srgb_inv_oetf,
                       SRGB_INV_OETF_NUM_ENTRIES, x)


def hlg_oetf_lut(x):
    return _lut_lookup("hlg_oetf", _np_hlg_oetf, HLG_OETF_NUM_ENTRIES, x)


def hlg_inv_oetf_lut(x):
    return _lut_lookup("hlg_inv", _np_hlg_inv_oetf,
                       HLG_INV_OETF_NUM_ENTRIES, x)


def pq_oetf_lut(x):
    return _lut_lookup("pq_oetf", _np_pq_oetf, PQ_OETF_NUM_ENTRIES, x)


def pq_inv_oetf_lut(x):
    return _lut_lookup("pq_inv", _np_pq_inv_oetf, PQ_INV_OETF_NUM_ENTRIES, x)


# ---------------------------------------------------------------------------
# Gamut conversions on linear RGB (gainmapmath.cpp:359-393).
# ---------------------------------------------------------------------------

BT709_TO_P3 = ((0.82254, 0.17755, 0.00006),
               (0.03312, 0.96684, -0.00001),
               (0.01706, 0.07240, 0.91049))
BT709_TO_BT2100 = ((0.62740, 0.32930, 0.04332),
                   (0.06904, 0.91958, 0.01138),
                   (0.01636, 0.08799, 0.89555))
P3_TO_BT709 = ((1.22482, -0.22490, -0.00007),
               (-0.04196, 1.04199, 0.00001),
               (-0.01961, -0.07865, 1.09831))
P3_TO_BT2100 = ((0.75378, 0.19862, 0.04754),
                (0.04576, 0.94177, 0.01250),
                (-0.00121, 0.01757, 0.98359))
BT2100_TO_BT709 = ((1.66045, -0.58764, -0.07286),
                   (-0.12445, 1.13282, -0.00837),
                   (-0.01811, -0.10057, 1.11878))
BT2100_TO_P3 = ((1.34369, -0.28223, -0.06135),
                (-0.06533, 1.07580, -0.01051),
                (0.00283, -0.01957, 1.01679))


def apply_matrix3(m, rgb):
    """y_i = sum_j m[i][j] * x_j, elementwise over planes."""
    a, b, c = (_f32(x) for x in rgb)
    return tuple(m[i][0] * a + m[i][1] * b + m[i][2] * c for i in range(3))


# YUV-encoding cross-conversions (gainmapmath.cpp:447-481).
YUV_709_TO_601 = ((1.0, 0.101579, 0.196076),
                  (0.0, 0.989854, -0.110653),
                  (0.0, -0.072453, 0.983398))
YUV_709_TO_2100 = ((1.0, -0.016969, 0.096312),
                   (0.0, 0.995306, -0.051192),
                   (0.0, 0.011507, 1.002637))
YUV_601_TO_709 = ((1.0, -0.118188, -0.212685),
                  (0.0, 1.018640, 0.114618),
                  (0.0, 0.075049, 1.025327))
YUV_601_TO_2100 = ((1.0, -0.128245, -0.115879),
                   (0.0, 1.010016, 0.061592),
                   (0.0, 0.086969, 1.029350))
YUV_2100_TO_709 = ((1.0, 0.018149, -0.095132),
                   (0.0, 1.004123, 0.051267),
                   (0.0, -0.011524, 0.996782))
YUV_2100_TO_601 = ((1.0, 0.117887, 0.105521),
                   (0.0, 0.995211, -0.059549),
                   (0.0, -0.084085, 0.976518))

# Gamut name -> YUV matrix-encoding name (DataSpace convention: sRGB uses
# BT.709 YUV, Display-P3 uses BT.601, BT2100 its own; gainmapmath.h:245-317).
GAMUT_YUV_ENCODING = {"bt709": "709", "p3": "601", "bt2100": "2100"}

_YUV_CONVERSIONS = {
    ("709", "601"): YUV_709_TO_601,
    ("709", "2100"): YUV_709_TO_2100,
    ("601", "709"): YUV_601_TO_709,
    ("601", "2100"): YUV_601_TO_2100,
    ("2100", "709"): YUV_2100_TO_709,
    ("2100", "601"): YUV_2100_TO_601,
}


def yuv_conversion_matrix(src_gamut: str, dst_gamut: str):
    """Matrix converting YUV signals between gamut encodings, or None if
    identity (jpegr.cpp:1132-1206 convertYuv dispatch)."""
    src = GAMUT_YUV_ENCODING[src_gamut]
    dst = GAMUT_YUV_ENCODING[dst_gamut]
    if src == dst:
        return None
    return _YUV_CONVERSIONS[(src, dst)]


_GAMUT_CONVERSIONS = {
    ("bt709", "p3"): P3_TO_BT709,
    ("bt709", "bt2100"): BT2100_TO_BT709,
    ("p3", "bt709"): BT709_TO_P3,
    ("p3", "bt2100"): BT2100_TO_P3,
    ("bt2100", "bt709"): BT709_TO_BT2100,
    ("bt2100", "p3"): P3_TO_BT2100,
}


def hdr_gamut_conversion_matrix(sdr_gamut: str, hdr_gamut: str):
    """Matrix converting linear HDR RGB into the SDR gamut, or None for
    identity (gainmapmath.cpp:397-440 getHdrConversionFn)."""
    if sdr_gamut == hdr_gamut:
        return None
    return _GAMUT_CONVERSIONS[(sdr_gamut, hdr_gamut)]


_LUMINANCE_FNS = {
    "bt709": srgb_luminance,
    "p3": p3_luminance,
    "bt2100": bt2100_luminance,
}

_YUV_TO_RGB_FNS = {
    "bt709": srgb_yuv_to_rgb,
    "p3": p3_yuv_to_rgb,
    "bt2100": bt2100_yuv_to_rgb,
}

_RGB_TO_YUV_FNS = {
    "bt709": srgb_rgb_to_yuv,
    "p3": p3_rgb_to_yuv,
    "bt2100": bt2100_rgb_to_yuv,
}


def luminance_fn(gamut: str):
    return _LUMINANCE_FNS[gamut]


def yuv_to_rgb_fn(gamut: str):
    return _YUV_TO_RGB_FNS[gamut]


def rgb_to_yuv_fn(gamut: str):
    return _RGB_TO_YUV_FNS[gamut]


def hdr_inv_oetf_fn(tf: str):
    """Inverse OETF + peak white nits for an HDR transfer function
    (ultrahdr.cpp:220-245)."""
    if tf == "linear":
        return identity, HLG_MAX_NITS
    if tf == "hlg":
        return hlg_inv_oetf, HLG_MAX_NITS
    if tf == "pq":
        return pq_inv_oetf, PQ_MAX_NITS
    raise ValueError(f"unsupported hdr transfer function: {tf}")


def hdr_oetf_fn(tf: str):
    if tf == "hlg":
        return hlg_oetf
    if tf == "pq":
        return pq_oetf
    if tf == "linear":
        return identity
    raise ValueError(f"unsupported hdr transfer function: {tf}")


# ---------------------------------------------------------------------------
# Gain computation (gainmapmath.cpp:524-560).
# ---------------------------------------------------------------------------

def encode_gain(y_sdr_nits, y_hdr_nits, min_content_boost: float,
                max_content_boost: float):
    """Per-pixel u8 gain: quantized position of log2(hdr/sdr) within
    [log2(min_boost), log2(max_boost)] (gainmapmath.cpp:529-541).

    Matches the reference bit-for-bit at the clamp boundaries: there,
    the numerator log2(gain) evaluates in double while log2MaxBoost was
    rounded to float32, so the saturated code is typically 254, not 255
    (e.g. encodeGain(sdr, hdr, maxBoost=1000/203) == 254 at clamp).
    The boundary codes are computed host-side in float64 and selected
    by mask.
    """
    min_b = float(np.float32(min_content_boost))
    max_b = float(np.float32(max_content_boost))
    log2_min = float(np.float32(math.log2(min_b)))
    log2_max = float(np.float32(math.log2(max_b)))
    denom = log2_max - log2_min

    def _boundary_code(boost: float) -> int:
        v = (math.log2(boost) - log2_min) / denom * 255.0
        return int(min(max(v, 0.0), 255.0))

    sat_code = _boundary_code(max_b)
    floor_code = _boundary_code(min_b)

    y_sdr = _f32(y_sdr_nits)
    y_hdr = _f32(y_hdr_nits)
    gain = jnp.where(y_sdr > 0.0, y_hdr / jnp.maximum(y_sdr, 1e-30), 1.0)
    scaled = (jnp.log2(jnp.clip(gain, min_b, max_b)) - log2_min) \
        / denom * 255.0
    code = jnp.clip(scaled, 0.0, 255.0).astype(jnp.uint8)
    code = jnp.where(gain >= max_b, jnp.uint8(sat_code), code)
    code = jnp.where(gain <= min_b, jnp.uint8(floor_code), code)
    return code


def gain_factor(gain01, min_content_boost: float, max_content_boost: float,
                display_boost: float | None = None):
    """Multiplier for a normalized [0,1] gain sample
    (gainmapmath.cpp:543-555).

    With display_boost, the exponent is weighted by
    display_boost / max_content_boost (the 'boost factor').
    """
    g = _f32(gain01)
    log_boost = (math.log2(min_content_boost) * (1.0 - g)
                 + math.log2(max_content_boost) * g)
    if display_boost is not None:
        log_boost = log_boost * (display_boost / max_content_boost)
    return jnp.exp2(log_boost)


def gain_factor_lut(gain01, min_content_boost: float, max_content_boost: float,
                    display_boost: float | None = None):
    """LUT variant matching GainLUT quantization (gainmapmath.h:149-182)."""
    n = GAIN_FACTOR_NUM_ENTRIES
    xs = np.arange(n, dtype=np.float32) / np.float32(n - 1)
    log_boost = (math.log2(min_content_boost) * (1.0 - xs)
                 + math.log2(max_content_boost) * xs)
    if display_boost is not None:
        boost_factor = (display_boost / max_content_boost
                        if display_boost > 0 else 1.0)
        log_boost = log_boost * boost_factor
    table = jnp.asarray(np.exp2(log_boost).astype(np.float32))
    idx = jnp.clip((_f32(gain01) * (n - 1) + 0.5).astype(jnp.int32), 0, n - 1)
    return jnp.take(table, idx)


# ---------------------------------------------------------------------------
# Pixel packing (gainmapmath.cpp:722-732).
# ---------------------------------------------------------------------------

def pack_rgba1010102(rgb):
    """Pack gamma-encoded RGB into RGBA1010102 u32, alpha=3
    (gainmapmath.cpp:722-727; truncating cast like the reference)."""
    r, g, b = (_f32(c) for c in rgb)
    ri = (jnp.clip(r, 0.0, 1.0) * 1023.0).astype(jnp.uint32) & 0x3FF
    gi = (jnp.clip(g, 0.0, 1.0) * 1023.0).astype(jnp.uint32) & 0x3FF
    bi = (jnp.clip(b, 0.0, 1.0) * 1023.0).astype(jnp.uint32) & 0x3FF
    return ri | (gi << 10) | (bi << 20) | jnp.uint32(0xC0000000)


def pack_rgba_f16(rgb):
    """Pack linear RGB into RGBA half-float channel bits, alpha=1.0
    (gainmapmath.cpp:729-732 packs the same four halves into a u64;
    here the result is a (..., 4) u16 array [r, g, b, a] — JAX runs
    with 32-bit ints, and a u16x4 view of the reference's
    little-endian u64 is identical memory). Hardware RTNE f32->f16."""
    r, g, b = (_f32(c) for c in rgb)
    to_bits = lambda x: x.astype(jnp.float16).view(jnp.uint16)
    one = jnp.full(r.shape, np.float16(1.0).view(np.uint16).item(),
                   jnp.uint16)
    return jnp.stack([to_bits(r), to_bits(g), to_bits(b), one], axis=-1)
