"""JpegR codec orchestrator: the five encode APIs + decode + info.

Re-implements JpegR (/root/reference/lib/src/jpegr.cpp) over the device
pixel core (ops/gainmap.py), the in-framework JPEG codec (jpeg/) and
the host container codecs (container/):

  API-0 (encode_api0): P010 HDR only            jpegr.cpp:167-247
  API-1 (encode_api1): P010 + YUV420 SDR        jpegr.cpp:250-383
  API-2 (encode_api2): raws + base JPEG         jpegr.cpp:386-435
  API-3 (encode_api3): P010 + base JPEG         jpegr.cpp:438-517
  API-4 (encode_api4): pure mux                 jpegr.cpp:520-561
  API-x (encode_apix): YUV420 + raw gain map    jpegr.cpp:564-622
  decode / get_info                             jpegr.cpp:624-804
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from .container import icc as icc_mod
from .container import jfif, mux, xmp
from .jpeg import codec
from .ops import gainmap as gm
from .types import (ColorGamut, ColorTransfer,
                    GainMapMetadata, MAP_COMPRESS_QUALITY, MAX_HEIGHT,
                    MAX_WIDTH, MIN_HEIGHT, MIN_WIDTH, OutputFormat,
                    PixelFormat, RawImage, err)

_GAMUT = {ColorGamut.BT709: "bt709", ColorGamut.P3: "p3",
          ColorGamut.BT2100: "bt2100"}
_TF = {ColorTransfer.LINEAR: "linear", ColorTransfer.HLG: "hlg",
       ColorTransfer.PQ: "pq"}
_OUT_PIXEL_FMT = {
    OutputFormat.SDR: PixelFormat.RGBA8888,
    OutputFormat.HDR_LINEAR: PixelFormat.RGBA_F16,
    OutputFormat.HDR_PQ: PixelFormat.RGBA1010102,
    OutputFormat.HDR_HLG: PixelFormat.RGBA1010102,
    OutputFormat.HDR_LINEAR_RGB_10BIT: PixelFormat.RGB_10BIT_PLANAR,
}
_OUT_TRANSFER = {
    OutputFormat.SDR: ColorTransfer.UNSPECIFIED,
    OutputFormat.HDR_LINEAR: ColorTransfer.LINEAR,
    OutputFormat.HDR_PQ: ColorTransfer.PQ,
    OutputFormat.HDR_HLG: ColorTransfer.HLG,
    OutputFormat.HDR_LINEAR_RGB_10BIT: ColorTransfer.LINEAR,
}


def _validate_p010(img: RawImage):
    if img.fmt != PixelFormat.P010:
        raise err("UHDR_CODEC_INVALID_PARAM", "expected P010 input")
    if img.width % 2 or img.height % 2:
        raise err("UHDR_CODEC_INVALID_PARAM",
                  f"odd dimensions {img.width}x{img.height}")
    if img.width < MIN_WIDTH or img.height < MIN_HEIGHT:
        raise err("UHDR_CODEC_INVALID_PARAM",
                  f"image too small {img.width}x{img.height}")
    if img.width > MAX_WIDTH or img.height > MAX_HEIGHT:
        raise err("UHDR_CODEC_INVALID_PARAM",
                  f"image too large {img.width}x{img.height}")
    if img.gamut not in _GAMUT:
        raise err("UHDR_CODEC_INVALID_PARAM", "unspecified color gamut")


def _validate_tf(tf: ColorTransfer):
    if tf not in _TF:
        raise err("UHDR_CODEC_INVALID_PARAM",
                  f"invalid hdr transfer function {tf}")


def _validate_quality(quality: int):
    if not 0 <= quality <= 100:
        raise err("UHDR_CODEC_INVALID_PARAM",
                  f"quality {quality} outside [0, 100]")


def _compress_gainmap(gmap_u8: np.ndarray) -> bytes:
    """Grayscale JPEG at the fixed gain-map quality (jpegr.cpp:41,
    806-821)."""
    return codec.encode_jpeg({"y": np.asarray(gmap_u8)},
                             quality=MAP_COMPRESS_QUALITY)


def _compress_base(y8, u8, v8, gamut: str, quality: int) -> bytes:
    """ICC + BT.601 conversion + base JPEG compress
    (jpegr.cpp:217-241 and the API-1 equivalent)."""
    icc = icc_mod.write_icc_profile("srgb", gamut)
    y8, u8, v8 = gm.convert_yuv_encoding(y8, u8, v8, gamut, "p3")
    return codec.encode_jpeg(
        {"y": np.asarray(y8), "u": np.asarray(u8), "v": np.asarray(v8)},
        quality=quality, icc=icc)


@lru_cache(maxsize=None)
def _fused_decode_kernel_dev(output_format: str, base_shape, gm_shape,
                             r_base: int, r_gm: int, w: int, h: int,
                             bmx: int, bmy: int, gmx: int, gmy: int,
                             gw: int, gh: int, scale: int,
                             use_luts: bool, qkey: bytes,
                             base_tkey: bytes = b"",
                             gm_tkey: bytes = b"",
                             base_carry: bool = False,
                             gm_carry: bool = False,
                             *, base_dlen: int, gm_dlen: int):
    """Fully-on-device decode: parallel RST entropy decode of the base
    (and gain map) bitstreams + dequant/IDCT + gain-map apply (or SDR
    conversion), one jit. See jpeg/device_decode.py for the
    entropy-decode formulation.

    The upload is the CONTIGUOUS destuffed streams (base then gain
    map, padded to base_dlen/gm_dlen) plus a (2, lanes) i32 starts
    array: row 0 per-lane byte offsets (the kernel gathers each lane's
    window on device — ~2x fewer link bytes than shipping padded
    window matrices), row 1 per-lane initial bit offsets (nonzero only
    for foreign restart-less streams; with base_carry/gm_carry the
    shared DC-prediction chain is fixed up on device).
    base_shape/gm_shape are the (lanes, window) geometries."""
    from .jpeg.dct import dequant_idct
    from .jpeg.device_decode import (decode_rst_chunks,
                                     deinterleave_yuv420_device)

    from .jpeg.device_decode import chains_from_key

    qts = np.frombuffer(qkey, np.int32).reshape(-1, 8, 8)
    ql, qc, qg = qts[0], qts[1], qts[2]
    ncb, lb = base_shape
    ncg, lg = gm_shape
    n_mcus = bmx * bmy
    g_mcus = gmx * gmy
    base_chains = chains_from_key(base_tkey) if base_tkey else None
    gm_chains = chains_from_key(gm_tkey) if gm_tkey else None
    from .jpeg.device_decode import min_code_len_from_key
    base_mcb = min_code_len_from_key(base_tkey or None)
    gm_mcb = min_code_len_from_key(gm_tkey or None)

    @jax.jit
    def kernel(combined_u8, scalars, starts2):
        bdest = combined_u8[:base_dlen]
        bidx = (starts2[0, :ncb][:, None]
                + jnp.arange(lb, dtype=jnp.int32)[None, :])
        bch = jnp.take(bdest, bidx)
        bstarts = starts2[1, :ncb] if base_carry else None
        blocks = decode_rst_chunks(bch, r_base, n_mcus, gray=False,
                                   chains=base_chains,
                                   min_code_bits=base_mcb,
                                   start_bits=bstarts,
                                   dc_carry=base_carry)
        yz, uz, vz = deinterleave_yuv420_device(blocks, bmx, bmy)
        y8 = dequant_idct(yz, ql, bmy * 16, bmx * 16)[:h, :w]
        u8 = dequant_idct(uz, qc, bmy * 8, bmx * 8)[:(h + 1) // 2,
                                                    :(w + 1) // 2]
        v8 = dequant_idct(vz, qc, bmy * 8, bmx * 8)[:(h + 1) // 2,
                                                    :(w + 1) // 2]
        if output_format == "sdr":
            return gm.yuv420_to_rgba8888(y8, u8, v8)
        gdest = combined_u8[base_dlen:]
        gidx = (starts2[0, ncb:][:, None]
                + jnp.arange(lg, dtype=jnp.int32)[None, :])
        gch = jnp.take(gdest, gidx)
        gstarts = starts2[1, ncb:] if gm_carry else None
        gblocks = decode_rst_chunks(gch, r_gm, g_mcus, gray=True,
                                    chains=gm_chains,
                                    min_code_bits=gm_mcb,
                                    start_bits=gstarts,
                                    dc_carry=gm_carry)
        gmap = dequant_idct(gblocks[:g_mcus], qg, gmy * 8,
                            gmx * 8)[:gh, :gw]
        if output_format == "planes":
            return gm.planes_composite(y8, u8, v8, gmap)
        apply_k = gm._apply_kernel(output_format, scale, use_luts)
        return apply_k(y8, u8, v8, gmap, scalars[0], scalars[1],
                       scalars[2], scalars[3])

    return kernel


@lru_cache(maxsize=None)
def _fused_decode_kernel(output_format: str, y_shape, c_shape, g_shape,
                         w: int, h: int, scale: int, use_luts: bool,
                         qtables_key: bytes):
    """One jit for the whole device side of decode: dequant+IDCT of
    base planes (and gain map), then gain-map application or SDR RGB
    conversion. ALL coefficients arrive as ONE flat i16 upload (the
    chip link has ~150 ms fixed cost per transfer) and quant tables are
    compile-time constants keyed into the cache."""
    from .jpeg.dct import dequant_idct

    ql, qc, qg = (np.frombuffer(qtables_key, np.int32)
                  .reshape(3, 8, 8)).astype(np.int32)

    ny = int(np.prod(y_shape))
    nc = int(np.prod(c_shape))
    ng = int(np.prod(g_shape))

    def idct(flat, off, shape, q):
        grid = jax.lax.dynamic_slice(flat, (off,), (int(np.prod(shape)),))
        grid = grid.reshape(shape)
        bh, bw = shape[0], shape[1]
        return dequant_idct(grid.reshape(-1, 64), q, bh * 8, bw * 8)

    @jax.jit
    def kernel(coefs_flat, scalars):
        y8 = idct(coefs_flat, 0, y_shape, ql)[:h, :w]
        u8 = idct(coefs_flat, ny, c_shape, qc)[:(h + 1) // 2,
                                               :(w + 1) // 2]
        v8 = idct(coefs_flat, ny + nc, c_shape, qc)[:(h + 1) // 2,
                                                    :(w + 1) // 2]
        if output_format == "sdr":
            return gm.yuv420_to_rgba8888(y8, u8, v8)
        gmap = idct(coefs_flat, ny + 2 * nc, g_shape,
                    qg)[:h // scale, :w // scale]
        if output_format == "planes":
            return gm.planes_composite(y8, u8, v8, gmap)
        apply_k = gm._apply_kernel(output_format, scale, use_luts)
        return apply_k(y8, u8, v8, gmap, scalars[0], scalars[1],
                       scalars[2], scalars[3])

    return kernel


class JpegR:
    """Stateless codec entry points (mirrors class JpegR,
    lib/include/ultrahdr/jpegr.h:59-368)."""

    # ------------------------------------------------------------------
    # Encode
    # ------------------------------------------------------------------

    def encode_api0(self, p010: RawImage, hdr_tf: ColorTransfer,
                    quality: int = 95, exif: bytes | None = None) -> bytes:
        _validate_p010(p010)
        _validate_tf(hdr_tf)
        _validate_quality(quality)
        gamut = _GAMUT[p010.gamut]

        # Fast path: fully on-device encode (entropy coding included)
        # for 16-aligned frames without external EXIF; the bitstream
        # carries restart markers (see docs/jpegr_format.md).
        if p010.width % 16 == 0 and p010.height % 16 == 0 and exif is None:
            from .parallel import sharding

            return sharding.batched_encode_api0(
                np.asarray(p010.planes["y"])[None],
                np.asarray(p010.planes["uv"])[None],
                sharding.single_device_mesh(), gamut=gamut,
                hdr_tf=_TF[hdr_tf], quality=quality)[0]

        y8, u8, v8 = gm.tonemap_p010(p010.planes["y"], p010.planes["uv"])
        gmap, metadata = gm.generate_gainmap(
            y8, u8, v8, p010.planes["y"], p010.planes["uv"],
            sdr_gamut=gamut, hdr_gamut=gamut, hdr_tf=_TF[hdr_tf])
        gainmap_jpeg = _compress_gainmap(np.asarray(gmap))
        base_jpeg = _compress_base(y8, u8, v8, gamut, quality)
        return mux.append_gainmap(base_jpeg, gainmap_jpeg, metadata,
                                  exif=exif)

    def encode_api1(self, p010: RawImage, yuv420: RawImage,
                    hdr_tf: ColorTransfer, quality: int = 95,
                    exif: bytes | None = None) -> bytes:
        _validate_p010(p010)
        _validate_tf(hdr_tf)
        _validate_quality(quality)
        if yuv420.fmt != PixelFormat.YUV420:
            raise err("UHDR_CODEC_INVALID_PARAM", "expected YUV420 SDR")
        if (yuv420.width, yuv420.height) != (p010.width, p010.height):
            raise err("UHDR_CODEC_INVALID_PARAM",
                      "SDR/HDR resolution mismatch")
        if yuv420.gamut not in _GAMUT:
            raise err("UHDR_CODEC_INVALID_PARAM", "unspecified SDR gamut")
        sdr_gamut = _GAMUT[yuv420.gamut]
        hdr_gamut = _GAMUT[p010.gamut]

        y8 = np.asarray(yuv420.planes["y"])
        u8 = np.asarray(yuv420.planes["u"])
        v8 = np.asarray(yuv420.planes["v"])

        # Fast path: fully on-device (restart-marker bitstream), with
        # host fallback on dense-content overflow.
        if p010.width % 16 == 0 and p010.height % 16 == 0 and exif is None:
            from .parallel import sharding

            try:
                return sharding.batched_encode_api1(
                    np.asarray(p010.planes["y"])[None],
                    np.asarray(p010.planes["uv"])[None],
                    y8[None], u8[None], v8[None],
                    sharding.single_device_mesh(), sdr_gamut=sdr_gamut,
                    hdr_gamut=hdr_gamut, hdr_tf=_TF[hdr_tf],
                    quality=quality)[0]
            except OverflowError:
                pass
        gmap, metadata = gm.generate_gainmap(
            y8, u8, v8, p010.planes["y"], p010.planes["uv"],
            sdr_gamut=sdr_gamut, hdr_gamut=hdr_gamut, hdr_tf=_TF[hdr_tf])
        gainmap_jpeg = _compress_gainmap(np.asarray(gmap))
        base_jpeg = _compress_base(y8, u8, v8, sdr_gamut, quality)
        return mux.append_gainmap(base_jpeg, gainmap_jpeg, metadata,
                                  exif=exif)

    def encode_api2(self, p010: RawImage, yuv420: RawImage,
                    base_jpeg: bytes, hdr_tf: ColorTransfer) -> bytes:
        """Gain map from the raw pair; base bitstream used as-is
        (jpegr.cpp:386-435)."""
        _validate_p010(p010)
        _validate_tf(hdr_tf)
        if yuv420.fmt != PixelFormat.YUV420:
            raise err("UHDR_CODEC_INVALID_PARAM", "expected YUV420 SDR")
        if (yuv420.width, yuv420.height) != (p010.width, p010.height):
            raise err("UHDR_CODEC_INVALID_PARAM",
                      "SDR/HDR resolution mismatch")
        if yuv420.gamut not in _GAMUT:
            raise err("UHDR_CODEC_INVALID_PARAM", "unspecified SDR gamut")
        sdr_gamut = _GAMUT[yuv420.gamut]
        gmap, metadata = gm.generate_gainmap(
            np.asarray(yuv420.planes["y"]), np.asarray(yuv420.planes["u"]),
            np.asarray(yuv420.planes["v"]), p010.planes["y"],
            p010.planes["uv"], sdr_gamut=sdr_gamut,
            hdr_gamut=_GAMUT[p010.gamut], hdr_tf=_TF[hdr_tf])
        gainmap_jpeg = _compress_gainmap(np.asarray(gmap))
        return self.encode_api4(base_jpeg, gainmap_jpeg, metadata)

    def encode_api3(self, p010: RawImage, base_jpeg: bytes,
                    hdr_tf: ColorTransfer) -> bytes:
        """Decode the given JPEG for the SDR rendition; its YUV is
        BT.601-encoded so generation uses sdr_is_601
        (jpegr.cpp:438-517)."""
        _validate_p010(p010)
        _validate_tf(hdr_tf)
        dec = codec.decode_jpeg(base_jpeg)
        if dec.ncomp != 3 or dec.sampling[0] != (2, 2):
            raise err("UHDR_CODEC_INVALID_PARAM",
                      "base JPEG must be YCbCr 4:2:0")
        if (dec.width, dec.height) != (p010.width, p010.height):
            raise err("UHDR_CODEC_INVALID_PARAM",
                      "JPEG/HDR resolution mismatch")
        gamut = ColorGamut.UNSPECIFIED
        if dec.icc is not None:
            g = icc_mod.read_icc_color_gamut(dec.icc)
            if g != "unspecified":
                gamut = ColorGamut(g)
        if gamut == ColorGamut.UNSPECIFIED:
            gamut = p010.gamut
        gmap, metadata = gm.generate_gainmap(
            dec.planes[0], dec.planes[1], dec.planes[2],
            p010.planes["y"], p010.planes["uv"],
            sdr_gamut=_GAMUT[gamut], hdr_gamut=_GAMUT[p010.gamut],
            hdr_tf=_TF[hdr_tf], sdr_is_601=True)
        gainmap_jpeg = _compress_gainmap(np.asarray(gmap))
        return self.encode_api4(base_jpeg, gainmap_jpeg, metadata)

    def encode_api4(self, base_jpeg: bytes, gainmap_jpeg: bytes,
                    metadata: GainMapMetadata,
                    exif: bytes | None = None) -> bytes:
        """Pure container mux (jpegr.cpp:520-561)."""
        if not base_jpeg or not gainmap_jpeg:
            raise err("UHDR_CODEC_INVALID_PARAM", "empty bitstream")
        return mux.append_gainmap(base_jpeg, gainmap_jpeg, metadata,
                                  exif=exif)

    def encode_apix(self, yuv420: RawImage, gainmap_u8: np.ndarray,
                    metadata: GainMapMetadata, quality: int = 95,
                    exif: bytes | None = None) -> bytes:
        """Transcode variant: SDR raw + raw gain map + metadata
        (jpegr.cpp:564-622)."""
        _validate_quality(quality)
        if yuv420.fmt != PixelFormat.YUV420:
            raise err("UHDR_CODEC_INVALID_PARAM", "expected YUV420 SDR")
        gainmap_jpeg = _compress_gainmap(np.asarray(gainmap_u8))
        gamut = _GAMUT.get(yuv420.gamut)
        icc = icc_mod.write_icc_profile("srgb", gamut) if gamut else None
        base_jpeg = codec.encode_jpeg(
            {"y": np.asarray(yuv420.planes["y"]),
             "u": np.asarray(yuv420.planes["u"]),
             "v": np.asarray(yuv420.planes["v"])},
            quality=quality, icc=icc)
        return mux.append_gainmap(base_jpeg, gainmap_jpeg, metadata,
                                  exif=exif)

    # ------------------------------------------------------------------
    # Probe / decode
    # ------------------------------------------------------------------

    @staticmethod
    def _check_gainmap_metadata(metadata: GainMapMetadata):
        """Decode-side metadata restrictions (ultrahdr.cpp:369-406)."""
        if metadata.version != "1.0":
            raise err("UHDR_CODEC_UNSUPPORTED_FEATURE",
                      f"unsupported metadata version {metadata.version}")
        if metadata.gamma != 1.0 or metadata.offset_sdr != 0.0 \
                or metadata.offset_hdr != 0.0:
            raise err("UHDR_CODEC_UNSUPPORTED_FEATURE",
                      "unsupported gamma/offsets")
        if (metadata.hdr_capacity_min != metadata.min_content_boost
                or metadata.hdr_capacity_max != metadata.max_content_boost):
            raise err("UHDR_CODEC_UNSUPPORTED_FEATURE",
                      "hdr capacity != content boost")

    def _decode_device_path(self, primary_bytes: bytes,
                            gainmap_bytes: bytes,
                            output_format: OutputFormat,
                            max_display_boost: float,
                            use_luts: bool) -> "JpegRDecodeResult | None":
        """Fully-on-device decode for bitstreams this framework encodes
        (baseline, Annex-K tables, restart intervals): entropy decode +
        IDCT + apply in one jit, one small upload. Returns None when
        either bitstream doesn't qualify (caller falls back to the host
        Huffman path)."""
        from .jpeg import device_decode as dd

        ds = dd.parse_device_stream(primary_bytes)
        # Non-4:2:0 bases bail to the host path, which raises the
        # reference's "not YCbCr 4:2:0" error (jpegr.cpp decode
        # requires 2x2/1x1/1x1; the general device decoder accepts
        # 4:2:2/4:4:4 for plain-JPEG ingest only).
        if ds is None or ds.gray or ds.sampling != (2, 2):
            return None
        dsg = dd.parse_device_stream(gainmap_bytes)
        if dsg is None or not dsg.gray:
            return None

        w, h = ds.width, ds.height
        gw, gh = dsg.width, dsg.height
        result = JpegRDecodeResult(width=w, height=h)
        result.exif = ds.exif
        result.icc = ds.icc
        if ds.icc is not None:
            g = icc_mod.read_icc_color_gamut(ds.icc)
            result.gamut = (ColorGamut(g) if g != "unspecified"
                            else ColorGamut.UNSPECIFIED)

        qkey = np.stack([ds.qtables[0], ds.qtables[1],
                         dsg.qtables[0]]).astype(np.int32).tobytes()
        bpad, gpad = ds.padded_dest(), dsg.padded_dest()
        combined = np.concatenate([bpad, gpad])
        base_carry = ds.start_bits is not None
        gm_carry = dsg.start_bits is not None
        starts2 = np.stack([
            np.concatenate([ds.starts_byte, dsg.starts_byte]),
            np.concatenate([
                ds.start_bits if base_carry
                else np.zeros(ds.n_lanes, np.int32),
                dsg.start_bits if gm_carry
                else np.zeros(dsg.n_lanes, np.int32)])])

        if output_format == OutputFormat.SDR:
            kernel = _fused_decode_kernel_dev(
                "sdr", (ds.n_lanes, ds.win_len),
                (dsg.n_lanes, dsg.win_len),
                ds.restart_interval, dsg.restart_interval, w, h,
                ds.mcus_x, ds.mcus_y, dsg.mcus_x, dsg.mcus_y, gw, gh, 1,
                bool(use_luts), qkey, ds.tables_key, dsg.tables_key,
                base_carry, gm_carry, base_dlen=bpad.size,
                gm_dlen=gpad.size)
            rgba = kernel(combined, np.zeros(4, np.float32), starts2)
            result.image = RawImage(
                fmt=PixelFormat.RGBA8888, width=w, height=h,
                gamut=result.gamut, planes={"rgba": rgba})
            return result

        # Gain-map metadata is only required for HDR reconstruction;
        # the SDR branch above must succeed without it (the host path
        # never touches the gain map for SDR output either).
        if dsg.xmp is None:
            raise err("UHDR_CODEC_ERROR", "gain map carries no XMP")
        metadata = xmp.get_metadata_from_xmp(dsg.xmp)
        result.metadata = metadata
        if w % gw or h % gh or (w * gh != h * gw):
            raise err("UHDR_CODEC_UNSUPPORTED_FEATURE",
                      f"non-integer map scale {w}x{h} vs {gw}x{gh}")
        scale = w // gw
        self._check_gainmap_metadata(metadata)

        display_boost = min(max_display_boost, metadata.max_content_boost)
        boost_factor = (display_boost / metadata.max_content_boost
                        if display_boost > 0 else 1.0)
        kernel = _fused_decode_kernel_dev(
            output_format.value, (ds.n_lanes, ds.win_len),
            (dsg.n_lanes, dsg.win_len),
            ds.restart_interval, dsg.restart_interval, w, h,
            ds.mcus_x, ds.mcus_y, dsg.mcus_x, dsg.mcus_y, gw, gh, scale,
            bool(use_luts), qkey, ds.tables_key, dsg.tables_key,
            base_carry, gm_carry, base_dlen=bpad.size,
            gm_dlen=gpad.size)
        scalars = np.asarray(
            [math.log2(metadata.min_content_boost),
             math.log2(metadata.max_content_boost),
             boost_factor, display_boost], np.float32)
        out = kernel(combined, scalars, starts2)
        result._gainmap_parts = ("device", dsg)
        result.image = RawImage(
            fmt=_OUT_PIXEL_FMT[output_format], width=w, height=h,
            gamut=result.gamut, transfer=_OUT_TRANSFER[output_format],
            planes={"rgba": out})
        return result

    def get_info(self, jpegr_bytes: bytes) -> "JpegRInfo":
        """Container split + header parse without pixel decode
        (jpegr.cpp:624-653 getJPEGRInfo)."""
        primary, gmap = mux.extract_primary_and_gainmap(jpegr_bytes)
        pinfo = jfif.parse_jpeg_info(primary)
        ginfo = jfif.parse_jpeg_info(gmap)
        metadata = None
        if ginfo.xmp is not None:
            try:
                metadata = xmp.get_metadata_from_xmp(ginfo.xmp)
            except Exception:
                metadata = None
        return JpegRInfo(width=pinfo.width, height=pinfo.height,
                         gainmap_width=ginfo.width,
                         gainmap_height=ginfo.height,
                         primary=pinfo, gainmap=ginfo, metadata=metadata)

    def decode(self, jpegr_bytes: bytes,
               output_format: OutputFormat = OutputFormat.HDR_LINEAR,
               max_display_boost: float = float("inf"),
               use_luts: bool = False) -> "JpegRDecodeResult":
        """Full decode (jpegr.cpp:655-804)."""
        if max_display_boost < 1.0:
            raise err("UHDR_CODEC_INVALID_PARAM",
                      f"bad max_display_boost {max_display_boost}")
        primary_bytes, gainmap_bytes = \
            mux.extract_primary_and_gainmap(jpegr_bytes)

        fast = self._decode_device_path(primary_bytes, gainmap_bytes,
                                        output_format, max_display_boost,
                                        use_luts)
        if fast is not None:
            return fast

        base = codec.decode_jpeg_coefs(primary_bytes)
        if (base.ncomp != 3 or base.comps[0][4] != (2, 2)
                or base.comps[1][4] != (1, 1)
                or base.comps[2][4] != (1, 1)):
            raise err("UHDR_CODEC_ERROR", "base image is not YCbCr 4:2:0")

        result = JpegRDecodeResult(width=base.width, height=base.height)
        result.exif = base.exif
        result.icc = base.icc
        if base.icc is not None:
            g = icc_mod.read_icc_color_gamut(base.icc)
            result.gamut = (ColorGamut(g) if g != "unspecified"
                            else ColorGamut.UNSPECIFIED)

        yg, ql, _, _, _ = base.comps[0]
        ug, qc, _, _, _ = base.comps[1]
        vg = base.comps[2][0]
        w, h = base.width, base.height

        if output_format == OutputFormat.SDR:
            dummy = np.zeros((1, 1, 64), np.int16)
            qkey = np.stack([ql, qc, ql]).astype(np.int32).tobytes()
            kernel = _fused_decode_kernel(
                "sdr", yg.shape, ug.shape, dummy.shape, w, h, 1,
                bool(use_luts), qkey)
            flat = np.concatenate([yg.ravel(), ug.ravel(), vg.ravel(),
                                   dummy.ravel()])
            rgba = kernel(flat, np.zeros(4, np.float32))
            # Keep the device array: materialization is the caller's
            # choice (np.asarray), so decode dispatch stays async and
            # device-side consumers read it zero-copy.
            result.image = RawImage(
                fmt=PixelFormat.RGBA8888, width=w, height=h,
                gamut=result.gamut, planes={"rgba": rgba})
            return result

        gmdec = codec.decode_jpeg_coefs(gainmap_bytes)
        if gmdec.ncomp != 1:
            raise err("UHDR_CODEC_ERROR", "gain map is not grayscale")
        if gmdec.xmp is None:
            raise err("UHDR_CODEC_ERROR", "gain map carries no XMP")
        metadata = xmp.get_metadata_from_xmp(gmdec.xmp)
        result.metadata = metadata

        gg, qg, gh, gw, _ = gmdec.comps[0]
        if w % gw or h % gh or (w * gh != h * gw):
            raise err("UHDR_CODEC_UNSUPPORTED_FEATURE",
                      f"non-integer map scale {w}x{h} vs {gw}x{gh}")
        scale = w // gw
        self._check_gainmap_metadata(metadata)

        display_boost = min(max_display_boost, metadata.max_content_boost)
        boost_factor = (display_boost / metadata.max_content_boost
                        if display_boost > 0 else 1.0)
        qkey = np.stack([ql, qc, qg]).astype(np.int32).tobytes()
        kernel = _fused_decode_kernel(
            output_format.value, yg.shape, ug.shape, gg.shape, w, h,
            scale, bool(use_luts), qkey)
        flat = np.concatenate([yg.ravel(), ug.ravel(), vg.ravel(),
                               gg.ravel()])
        scalars = np.asarray(
            [math.log2(metadata.min_content_boost),
             math.log2(metadata.max_content_boost),
             boost_factor, display_boost], np.float32)
        out = kernel(flat, scalars)
        # Gain map plane (get_gain_map_image) is derived lazily — it
        # costs an extra device round trip most callers never need.
        result._gainmap_parts = (gg, qg, gh, gw)
        result.image = RawImage(
            fmt=_OUT_PIXEL_FMT[output_format], width=base.width,
            height=base.height, gamut=result.gamut,
            transfer=_OUT_TRANSFER[output_format],
            planes={"rgba": out})  # device array; host reads on demand
        return result


@dataclass
class JpegRInfo:
    width: int
    height: int
    gainmap_width: int
    gainmap_height: int
    primary: object = None
    gainmap: object = None
    metadata: GainMapMetadata | None = None


@dataclass
class JpegRDecodeResult:
    width: int
    height: int
    image: RawImage | None = None
    metadata: GainMapMetadata | None = None
    exif: bytes | None = None
    icc: bytes | None = None
    gamut: ColorGamut = ColorGamut.UNSPECIFIED
    # (coef grid, qtable, h, w) for lazy gain-map reconstruction.
    _gainmap_parts: tuple | None = None
    _gainmap_cache: np.ndarray | None = None

    @property
    def gainmap(self) -> np.ndarray | None:
        """Decoded u8 gain-map plane, reconstructed on first access."""
        if self._gainmap_cache is None and self._gainmap_parts is not None:
            if isinstance(self._gainmap_parts[0], str):
                from .jpeg import device_decode as dd
                dsg = self._gainmap_parts[1]
                qkey = np.stack([dsg.qtables[0]]).astype(
                    np.int32).tobytes()
                carry = dsg.start_bits is not None
                kernel = dd._decode_to_planes_kernel(
                    dsg.chunks.shape[0], dsg.chunks.shape[1],
                    dsg.restart_interval, dsg.mcus_x * dsg.mcus_y,
                    dsg.mcus_x, dsg.mcus_y, True, qkey,
                    dsg.tables_key, carry)
                plane = (kernel(np.asarray(dsg.chunks),
                                np.asarray(dsg.start_bits))
                         if carry else kernel(np.asarray(dsg.chunks)))[0]
                self._gainmap_cache = np.asarray(
                    plane)[:dsg.height, :dsg.width]
            else:
                from .jpeg.dct import dequant_idct
                gg, qg, gh, gw = self._gainmap_parts
                self._gainmap_cache = np.asarray(dequant_idct(
                    gg.reshape(-1, 64), qg, gg.shape[0] * 8,
                    gg.shape[1] * 8))[:gh, :gw]
        return self._gainmap_cache

    @gainmap.setter
    def gainmap(self, value):
        self._gainmap_cache = value
