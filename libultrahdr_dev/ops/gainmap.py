"""Gain-map generation / application / tone-mapping on the device.

Re-designs the reference's per-pixel scalar loops
(/root/reference/lib/src/ultrahdr.cpp:185-558 generateGainMap /
applyGainMap / toneMap) as whole-plane JAX programs: the 4x4 box
sampling becomes a reshape+mean, the YUV->RGB->linear->luminance chain
becomes fused elementwise math, and the Shepard's
inverse-distance-weight gain-map upsampling
(/root/reference/lib/src/gainmapmath.cpp:66-110, 686-720) is computed
analytically per pixel from (x mod s, y mod s) instead of gathering
from precomputed weight tables — no gathers, everything fuses into a
handful of XLA fusions.

The reference parallelizes over 16-row bands with a thread pool
(ultrahdr.cpp:131-183); here parallelism comes from XLA's grid and, for
batches, from sharding the batch axis over the device mesh
(libultrahdr_dev.parallel).
"""

from __future__ import annotations

import math
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from . import color
from ..types import (GainMapMetadata, MAP_DIMENSION_SCALE_FACTOR,
                     GAIN_MAP_VERSION)

SCALE = MAP_DIMENSION_SCALE_FACTOR


# ---------------------------------------------------------------------------
# Plane normalization helpers.
# ---------------------------------------------------------------------------

def p010_to_float(y_u16, uv_u16):
    """Narrow-range P010 planes -> normalized float (y, u, v) at full res.

    P010 stores 10-bit values MSB-aligned in u16; narrow range maps
    Y [64..940]/876 and UV [64..960]/896 - 0.5
    (gainmapmath.cpp:583-601 getP010Pixel).
    Returns y (H,W), u/v (H//2, W//2) floats (chroma NOT upsampled).
    """
    y10 = (y_u16 >> 6).astype(jnp.float32)
    uv10 = (uv_u16 >> 6).astype(jnp.float32)
    y = (y10 - 64.0) * (1.0 / 876.0)
    u = (uv10[:, 0::2] - 64.0) * (1.0 / 896.0) - 0.5
    v = (uv10[:, 1::2] - 64.0) * (1.0 / 896.0) - 0.5
    return y, u, v


def yuv420_to_float(y_u8, u_u8, v_u8):
    """JPEG-convention YUV420 planes -> normalized floats; 128-bias chroma
    (gainmapmath.cpp:562-581 getYuv420Pixel)."""
    y = y_u8.astype(jnp.float32) * (1.0 / 255.0)
    u = (u_u8.astype(jnp.float32) - 128.0) * (1.0 / 255.0)
    v = (v_u8.astype(jnp.float32) - 128.0) * (1.0 / 255.0)
    return y, u, v


def _box_mean(x, factor):
    """Mean over non-overlapping factor x factor blocks (crops remainder).

    lax.reduce_window (a pooling primitive XLA lowers to fused strided
    reductions) instead of reshape+mean, which splits the minor
    dimension (W -> W/f, f). Whether the reshape form is as fast on
    the GPU is an open measurement (ROADMAP design debt 2)."""
    h, w = x.shape[-2], x.shape[-1]
    hh, ww = (h // factor) * factor, (w // factor) * factor
    x = x[..., :hh, :ww]
    win = (1,) * (x.ndim - 2) + (factor, factor)
    s = jax.lax.reduce_window(x, np.float32(0), jax.lax.add, win, win,
                              "VALID")
    return s * (1.0 / (factor * factor))


def _upsample2(x):
    """Nearest 2x upsample of a chroma plane (each sample covers 2x2 lumas)."""
    return jnp.repeat(jnp.repeat(x, 2, axis=-2), 2, axis=-1)


# ---------------------------------------------------------------------------
# Tone map: P010 -> YUV420 by 10->8 bit truncation (ultrahdr.cpp:517-558).
# ---------------------------------------------------------------------------

@jax.jit
def tonemap_p010(y_u16, uv_u16):
    """Returns (y8, u8, v8) planes. 10-bit code >> 2, i.e. u16 >> 8."""
    y8 = (y_u16 >> 8).astype(jnp.uint8)
    u8 = (uv_u16[:, 0::2] >> 8).astype(jnp.uint8)
    v8 = (uv_u16[:, 1::2] >> 8).astype(jnp.uint8)
    return y8, u8, v8


# ---------------------------------------------------------------------------
# Gain map generation (ultrahdr.cpp:185-358).
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _generate_kernel(sdr_gamut: str, hdr_gamut: str, hdr_tf: str,
                     sdr_is_601: bool, use_luts: bool):
    """Build the jitted gain-map generation kernel for a static config."""
    hdr_inv_oetf, hdr_white_nits = color.hdr_inv_oetf_fn(hdr_tf)
    if use_luts and hdr_tf == "hlg":
        hdr_inv_oetf = color.hlg_inv_oetf_lut
    elif use_luts and hdr_tf == "pq":
        hdr_inv_oetf = color.pq_inv_oetf_lut
    srgb_inv = color.srgb_inv_oetf_lut if use_luts else color.srgb_inv_oetf

    luminance = color.luminance_fn(sdr_gamut)
    sdr_yuv_to_rgb = (color.p3_yuv_to_rgb if sdr_is_601
                      else color.yuv_to_rgb_fn(sdr_gamut))
    hdr_yuv_to_rgb = color.yuv_to_rgb_fn(hdr_gamut)
    gamut_m = color.hdr_gamut_conversion_matrix(sdr_gamut, hdr_gamut)

    max_boost = hdr_white_nits / color.SDR_WHITE_NITS
    min_boost = 1.0

    @jax.jit
    def kernel(sdr_y, sdr_u, sdr_v, hdr_y, hdr_uv):
        # Box-sample both inputs down to map resolution.  Plane-to-float
        # conversion is affine, so sampling commutes with it; a 4x4 luma
        # box covers exactly a 2x2 chroma box at 4:2:0.
        sy, su, sv = yuv420_to_float(sdr_y, sdr_u, sdr_v)
        sy = _box_mean(sy, SCALE)
        su = _box_mean(su, SCALE // 2)
        sv = _box_mean(sv, SCALE // 2)

        hy, hu, hv = p010_to_float(hdr_y, hdr_uv)
        hy = _box_mean(hy, SCALE)
        hu = _box_mean(hu, SCALE // 2)
        hv = _box_mean(hv, SCALE // 2)

        sdr_rgb = color.apply_channelwise(srgb_inv, sdr_yuv_to_rgb((sy, su, sv)))
        sdr_nits = luminance(sdr_rgb) * color.SDR_WHITE_NITS

        hdr_rgb = color.apply_channelwise(hdr_inv_oetf, hdr_yuv_to_rgb((hy, hu, hv)))
        if gamut_m is not None:
            hdr_rgb = color.apply_matrix3(gamut_m, hdr_rgb)
        hdr_nits = luminance(hdr_rgb) * hdr_white_nits

        return color.encode_gain(sdr_nits, hdr_nits, min_boost, max_boost)

    return kernel, max_boost


def generate_gainmap(sdr_y, sdr_u, sdr_v, hdr_y, hdr_uv, *, sdr_gamut: str,
                     hdr_gamut: str, hdr_tf: str, sdr_is_601: bool = False,
                     use_luts: bool = False):
    """Compute the u8 gain map plus its metadata.

    Inputs: YUV420 u8 planes (y (H,W), u/v (H/2,W/2)) and P010 u16
    planes (y (H,W), uv (H/2,W) interleaved).  Output map is
    (H//4, W//4) u8.  Metadata defaults follow ultrahdr.cpp:247-257.
    """
    kernel, max_boost = _generate_kernel(sdr_gamut, hdr_gamut, hdr_tf,
                                         bool(sdr_is_601), bool(use_luts))
    gainmap = kernel(jnp.asarray(sdr_y), jnp.asarray(sdr_u),
                     jnp.asarray(sdr_v), jnp.asarray(hdr_y),
                     jnp.asarray(hdr_uv))
    metadata = GainMapMetadata(
        version=GAIN_MAP_VERSION,
        max_content_boost=max_boost,
        min_content_boost=1.0,
        gamma=1.0,
        offset_sdr=0.0,
        offset_hdr=0.0,
        hdr_capacity_min=1.0,
        hdr_capacity_max=max_boost,
    )
    return gainmap, metadata


# ---------------------------------------------------------------------------
# Shepard's inverse-distance-weight gain-map upsampling.
# ---------------------------------------------------------------------------

def idw_weights_numpy(scale: int, inc_r: int, inc_b: int) -> np.ndarray:
    """Reference weight table for one edge configuration, shape
    (scale, scale, 4) (gainmapmath.cpp:73-110 fillShepardsIDW).
    Used for parity tests; the kernel computes these analytically."""
    w = np.zeros((scale, scale, 4), np.float32)
    for yy in range(scale):
        for xx in range(scale):
            px, py = xx / scale, yy / scale
            d1 = math.hypot(px, py)
            if d1 == 0.0:
                w[yy, xx] = (1.0, 0.0, 0.0, 0.0)
                continue
            d2 = math.hypot(px, py - inc_b)
            d3 = math.hypot(px - inc_r, py)
            d4 = math.hypot(px - inc_r, py - inc_b)
            ws = np.array([1.0 / d1, 1.0 / d2, 1.0 / d3, 1.0 / d4],
                          np.float32)
            w[yy, xx] = ws / ws.sum()
    return w


def _idw_upsample(gmap01, scale: int, out_h: int, out_w: int):
    """Upsample a (mh, mw) [0,1] gain map to (out_h, out_w) with
    Shepard's IDW over the 4 surrounding map samples, matching
    sampleMap(..., ShepardsIDW&) (gainmapmath.cpp:686-720) including
    its NR/NB/C edge tables.

    Design: ONE jnp.repeat upsample (repeats split the minor dim, so
    it is done once, not 4x), then the other three corner
    maps are clamp-shifts of it at FULL resolution (cheap strided
    copies; bit-identical to upsampling the shifted map since cells
    are scale-aligned). Weights are recomputed per output pixel from
    (x mod s, y mod s) and edge masks — pure elementwise math that
    XLA fuses with the surrounding pixel pipeline.
    """
    mh, mw = gmap01.shape
    e1 = jnp.repeat(jnp.repeat(gmap01, scale, axis=0)[:out_h], scale,
                    axis=1)[:, :out_w]

    def shift(a, dy, dx):
        if dy:
            a = jnp.concatenate(
                [a[dy:], jnp.broadcast_to(a[-1:], (dy,) + a.shape[1:])],
                axis=0)
        if dx:
            a = jnp.concatenate(
                [a[:, dx:], jnp.broadcast_to(a[:, -1:],
                                             (a.shape[0], dx))], axis=1)
        return a

    e2 = shift(e1, scale, 0)
    e3 = shift(e1, 0, scale)
    e4 = shift(e1, scale, scale)

    xs = jax.lax.broadcasted_iota(jnp.int32, (out_h, out_w), 1)
    ys = jax.lax.broadcasted_iota(jnp.int32, (out_h, out_w), 0)
    px = (xs % scale).astype(jnp.float32) / scale
    py = (ys % scale).astype(jnp.float32) / scale
    # Edge configs: the rightmost/bottom map cell clamps x_upper/y_upper,
    # so next_x/next_y collapse onto curr (incR/incB = 0).
    inc_r = jnp.where(xs // scale >= mw - 1, 0.0, 1.0)
    inc_b = jnp.where(ys // scale >= mh - 1, 0.0, 1.0)

    d1 = jnp.sqrt(px * px + py * py)
    d2 = jnp.sqrt(px * px + (py - inc_b) ** 2)
    d3 = jnp.sqrt((px - inc_r) ** 2 + py * py)
    d4 = jnp.sqrt((px - inc_r) ** 2 + (py - inc_b) ** 2)

    eps = 1e-12
    w1 = 1.0 / jnp.maximum(d1, eps)
    w2 = 1.0 / jnp.maximum(d2, eps)
    w3 = 1.0 / jnp.maximum(d3, eps)
    w4 = 1.0 / jnp.maximum(d4, eps)
    # At the bottom/right edges d2/d3/d4 can also hit zero (inc=0 with
    # offset 0); the reference's table fill only special-cases d1==0
    # (which covers those, since offset 0 implies d1==0 there too).
    total = w1 + w2 + w3 + w4
    exact = d1 <= 0.0
    blended = (e1 * w1 + e2 * w2 + e3 * w3 + e4 * w4) / total
    return jnp.where(exact, e1, blended)


def planes_composite(y8, u8, v8, gmap_u8):
    """Stack the decode's integer intermediates into ONE u8 composite
    plane for the planar Rice readback (packio.fetch_planes_u8):
    rows [0,h) Y, rows [h,h+ch) U|V side by side, rows [h+ch,..) the
    gain map — edge-replicated padding (costs ~0 residual bits), row
    count padded to a multiple of 3 so the readback's third-geometry
    applies. The host reapplies the gain map natively
    (jpeg/native/apply.cpp), shipping ~2-4x fewer link bytes than any
    packed-output-pixel readback."""
    h, w = y8.shape
    ch, cw = u8.shape
    gh, gw = gmap_u8.shape
    wc = max(w, 2 * cw)

    def padw(a):
        return jnp.pad(a, ((0, 0), (0, wc - a.shape[1])), mode="edge")

    comp = jnp.concatenate([
        padw(y8), padw(jnp.concatenate([u8, v8], axis=1)),
        padw(gmap_u8)])
    pad = (-(h + ch + gh)) % 3
    if pad:
        comp = jnp.concatenate(
            [comp, jnp.broadcast_to(comp[-1:], (pad, wc))])
    return comp.astype(jnp.uint8)


# ---------------------------------------------------------------------------
# Gain map application (ultrahdr.cpp:360-515).
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _apply_kernel(output_format: str, scale: int, use_luts: bool):
    srgb_inv = color.srgb_inv_oetf_lut if use_luts else color.srgb_inv_oetf

    @jax.jit
    def kernel(y8, u8, v8, gmap_u8, log2_min, log2_max, boost_factor,
               display_boost):
        h, w = y8.shape
        y, u, v = yuv420_to_float(y8, u8, v8)
        u = _upsample2(u)[:h, :w]
        v = _upsample2(v)[:h, :w]
        # Decoded JPEG base: always BT.601 YUV, sRGB transfer
        # (ultrahdr.cpp:437-445).
        rgb = color.apply_channelwise(srgb_inv, color.p3_yuv_to_rgb((y, u, v)))

        gain01 = _idw_upsample(gmap_u8.astype(jnp.float32) / 255.0, scale,
                               h, w)
        log_boost = log2_min * (1.0 - gain01) + log2_max * gain01
        factor = jnp.exp2(log_boost * boost_factor) / display_boost
        rgb = tuple(c * factor for c in rgb)

        if output_format == "hdr_linear":
            return color.pack_rgba_f16(rgb)
        if output_format == "hdr_linear_rgb_10bit":
            chans = [(jnp.clip(c, 0.0, 1.0) * 1023.0).astype(jnp.uint16)
                     for c in rgb]
            return jnp.stack(chans, axis=0)
        if output_format == "hdr_hlg":
            oetf = color.hlg_oetf_lut if use_luts else color.hlg_oetf
            return color.pack_rgba1010102(color.apply_channelwise(oetf, rgb))
        if output_format == "hdr_pq":
            oetf = color.pq_oetf_lut if use_luts else color.pq_oetf
            return color.pack_rgba1010102(color.apply_channelwise(oetf, rgb))
        raise ValueError(f"unsupported output format {output_format}")

    return kernel


def apply_gainmap(y8, u8, v8, gmap_u8, metadata: GainMapMetadata,
                  output_format: str, max_display_boost: float,
                  use_luts: bool = False):
    """Reconstruct HDR from an SDR YUV420 base + u8 gain map.

    Validates metadata constraints as the reference does
    (ultrahdr.cpp:369-406): gamma 1, offsets 0, capacity == boosts.
    Output: (H,W,4) u16 RGBA F16 halves / u32 (H,W) RGBA1010102 /
    (3,H,W) u16 10-bit planes.
    """
    from ..types import err

    if metadata.version != GAIN_MAP_VERSION:
        raise err("UHDR_CODEC_UNSUPPORTED_FEATURE",
                  f"unsupported metadata version {metadata.version}")
    if metadata.gamma != 1.0:
        raise err("UHDR_CODEC_UNSUPPORTED_FEATURE",
                  f"unsupported gamma {metadata.gamma}")
    if metadata.offset_sdr != 0.0 or metadata.offset_hdr != 0.0:
        raise err("UHDR_CODEC_UNSUPPORTED_FEATURE", "nonzero offsets")
    if (metadata.hdr_capacity_min != metadata.min_content_boost
            or metadata.hdr_capacity_max != metadata.max_content_boost):
        raise err("UHDR_CODEC_UNSUPPORTED_FEATURE",
                  "hdr capacity != content boost")

    h, w = y8.shape
    mh, mw = gmap_u8.shape
    if h % mh or w % mw or (w * mh != h * mw):
        raise err("UHDR_CODEC_UNSUPPORTED_FEATURE",
                  f"non-integer map scale {w}x{h} vs {mw}x{mh}")
    scale = w // mw

    display_boost = min(max_display_boost, metadata.max_content_boost)
    boost_factor = (display_boost / metadata.max_content_boost
                    if display_boost > 0 else 1.0)
    kernel = _apply_kernel(output_format, scale, bool(use_luts))
    return kernel(jnp.asarray(y8), jnp.asarray(u8), jnp.asarray(v8),
                  jnp.asarray(gmap_u8),
                  jnp.float32(math.log2(metadata.min_content_boost)),
                  jnp.float32(math.log2(metadata.max_content_boost)),
                  jnp.float32(boost_factor), jnp.float32(display_boost))


# ---------------------------------------------------------------------------
# SDR RGBA8888 output: libjpeg-style decode to RGB. The reference gets
# this from libjpeg itself (DECODE_TO_RGBA, jpegr.cpp:692-697 +
# 770-788); here the same triangular ("fancy") h2v2 chroma upsample and
# full-range BT.601 YCbCr->RGB run as one fused XLA program.
# ---------------------------------------------------------------------------

def _fancy_upsample2(c):
    """libjpeg h2v2 fancy (triangle) upsample of one chroma plane, in
    the same integer arithmetic as jdsample.c h2v2_fancy_upsample."""
    c = c.astype(jnp.int32)

    def pad_edge(a, axis):
        first = jax.lax.slice_in_dim(a, 0, 1, axis=axis)
        last = jax.lax.slice_in_dim(a, a.shape[axis] - 1, a.shape[axis],
                                    axis=axis)
        return jnp.concatenate([first, a, last], axis=axis)

    cp = pad_edge(c, 0)
    up = 3 * c + cp[:-2]     # colsum toward the row above
    down = 3 * c + cp[2:]    # colsum toward the row below
    rows = jnp.stack([up, down], axis=1).reshape(-1, c.shape[1])

    rp = pad_edge(rows, 1)
    left = (3 * rows + rp[:, :-2] + 8) >> 4
    right = (3 * rows + rp[:, 2:] + 7) >> 4
    out = jnp.stack([left, right], axis=2).reshape(rows.shape[0], -1)
    return out


@jax.jit
def yuv420_to_rgba8888(y8, u8, v8):
    """Full-range BT.601 YCbCr 4:2:0 -> packed RGBA8888 u32 (alpha FF),
    matching the reference's SDR output packing (jpegr.cpp:779-786)."""
    h, w = y8.shape
    y = y8.astype(jnp.float32)
    cb = _fancy_upsample2(u8)[:h, :w].astype(jnp.float32) - 128.0
    cr = _fancy_upsample2(v8)[:h, :w].astype(jnp.float32) - 128.0
    r = y + 1.40200 * cr
    g = y - 0.34414 * cb - 0.71414 * cr
    b = y + 1.77200 * cb
    to8 = lambda x: jnp.clip(jnp.round(x), 0, 255).astype(jnp.uint32)
    return (to8(r) | (to8(g) << 8) | (to8(b) << 16)
            | jnp.uint32(0xFF000000))


# ---------------------------------------------------------------------------
# In-place YUV gamut-encoding conversion (jpegr.cpp:1132-1206 convertYuv,
# gainmapmath.cpp:483-520 transformYuv420).
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _convert_yuv_kernel(src_gamut: str, dst_gamut: str):
    m = color.yuv_conversion_matrix(src_gamut, dst_gamut)
    if m is None:
        return None

    @jax.jit
    def kernel(y8, u8, v8):
        y, u, v = yuv420_to_float(y8, u8, v8)
        # The YUV cross matrices leave row 0 = (1, a, b) and have zero
        # y-coefficients in rows 1-2, so the 2x2 chroma-shared transform
        # (transformYuv420) reduces to: per-pixel luma shift from the
        # shared chroma, chroma from chroma alone (the 4-pixel average
        # of transformed values equals the transform of the shared uv).
        y_shift = m[0][1] * u + m[0][2] * v
        y_new = y + _upsample2(y_shift)[: y.shape[0], : y.shape[1]]
        u_new = m[1][1] * u + m[1][2] * v
        v_new = m[2][1] * u + m[2][2] * v
        y_out = jnp.clip(y_new * 255.0 + 0.5, 0, 255).astype(jnp.uint8)
        u_out = jnp.clip(u_new * 255.0 + 128.5, 0, 255).astype(jnp.uint8)
        v_out = jnp.clip(v_new * 255.0 + 128.5, 0, 255).astype(jnp.uint8)
        return y_out, u_out, v_out

    return kernel


def convert_yuv_encoding(y8, u8, v8, src_gamut: str, dst_gamut: str):
    """Re-encode YUV planes from one gamut's YUV matrix to another's."""
    kernel = _convert_yuv_kernel(src_gamut, dst_gamut)
    if kernel is None:
        return y8, u8, v8
    return kernel(jnp.asarray(y8), jnp.asarray(u8), jnp.asarray(v8))
