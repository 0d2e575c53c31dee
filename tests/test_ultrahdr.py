"""Converter-session flow tests, mirroring the reference's
ultrahdr_test.cpp testFlow1..7 coverage (JPEG_R -> JPEG, raw -> JPEG_R
with effects, etc.)."""

import numpy as np
import pytest

from libultrahdr_dev.jpegr import JpegR
from libultrahdr_dev.ops import editor
from libultrahdr_dev.types import (ColorGamut, ColorTransfer,
                                       OutputFormat, PixelFormat, RawImage,
                                       UhdrError)
from libultrahdr_dev.ultrahdr import UltraHdr, UltraHdrConfig, \
    sniff_format


def p010(h=64, w=96):
    rng = np.random.default_rng(2)
    y = (rng.integers(64, 940, (h, w)).astype(np.uint16)) << 6
    uv = np.full((h // 2, w), 512 << 6, np.uint16)
    return RawImage(fmt=PixelFormat.P010, width=w, height=h,
                    gamut=ColorGamut.BT2100, transfer=ColorTransfer.HLG,
                    planes={"y": y, "uv": uv})


def make_jpegr():
    return JpegR().encode_api0(p010(), ColorTransfer.HLG, quality=95)


class TestSniff:
    def test_jpeg_r(self):
        assert sniff_format(make_jpegr()) == "jpeg_r"

    def test_plain_jpeg(self):
        from libultrahdr_dev.jpeg import codec
        blob = codec.encode_jpeg({"y": np.zeros((16, 16), np.uint8)}, 90)
        assert sniff_format(blob) == "jpeg"

    def test_heif_brands(self):
        assert sniff_format(b"\x00\x00\x00\x18ftypheic" + b"\x00" * 8) == "heic"
        assert sniff_format(b"\x00\x00\x00\x18ftypavif" + b"\x00" * 8) == "avif"
        assert sniff_format(b"garbage") == "unknown"


class TestFlows:
    def test_flow_jpegr_to_jpeg(self):
        """testFlow1: JPEG_R in -> plain JPEG out (base passthrough)."""
        u = UltraHdr().add_image(make_jpegr())
        out = u.convert(UltraHdrConfig(output_codec="jpeg"))
        assert sniff_format(out) == "jpeg"

    def test_flow_yuv420_to_jpeg(self):
        """testFlow2: raw SDR -> JPEG."""
        u = UltraHdr()
        u.add_raw(RawImage(
            fmt=PixelFormat.YUV420, width=32, height=32,
            gamut=ColorGamut.BT709,
            planes={"y": np.full((32, 32), 100, np.uint8),
                    "u": np.full((16, 16), 128, np.uint8),
                    "v": np.full((16, 16), 128, np.uint8)}))
        out = u.convert(UltraHdrConfig(output_codec="jpeg", quality=90))
        assert sniff_format(out) == "jpeg"

    def test_flow_p010_to_jpegr_with_effects(self):
        """testFlow3: P010 -> JPEG_R with mirror + rotate."""
        u = UltraHdr().add_raw(p010())
        cfg = UltraHdrConfig(output_codec="jpeg_r",
                             transfer=ColorTransfer.HLG,
                             effects=[editor.MirrorEffect("horizontal"),
                                      editor.RotateEffect(90)])
        out = u.convert(cfg)
        assert sniff_format(out) == "jpeg_r"
        info = JpegR().get_info(out)
        # 90-degree rotation swaps dims.
        assert (info.width, info.height) == (64, 96)
        assert (info.gainmap_width, info.gainmap_height) == (16, 24)

    def test_flow_jpegr_reencode_with_effects(self):
        """JPEG_R in -> JPEG_R out with a crop."""
        u = UltraHdr().add_image(make_jpegr())
        cfg = UltraHdrConfig(output_codec="jpeg_r",
                             effects=[editor.CropEffect(0, 48, 0, 32)])
        out = u.convert(cfg)
        info = JpegR().get_info(out)
        assert (info.width, info.height) == (48, 32)
        assert (info.gainmap_width, info.gainmap_height) == (12, 8)

    def test_flow_jpegr_passthrough_remux(self):
        """JPEG_R in, no effects -> API-4 remux preserving streams."""
        blob = make_jpegr()
        u = UltraHdr().add_image(blob)
        out = u.convert(UltraHdrConfig(output_codec="jpeg_r"))
        res = JpegR().decode(out, OutputFormat.HDR_LINEAR, 4.9)
        assert res.width == 96

    def test_flow_p010_to_raw_hdr(self):
        u = UltraHdr().add_raw(p010())
        img = u.convert_to_raw(UltraHdrConfig(
            output_format=OutputFormat.HDR_LINEAR, max_display_boost=4.9))
        assert img.fmt == PixelFormat.RGBA_F16

    def test_garbage_heif_rejected(self):
        with pytest.raises(UhdrError):
            UltraHdr().add_image(b"\x00\x00\x00\x18ftypheic" + b"\x00" * 64)

    def test_insufficient_inputs(self):
        with pytest.raises(UhdrError):
            UltraHdr().convert(UltraHdrConfig(output_codec="jpeg_r"))


class TestRawOutputs:
    """Direct raw outputs (ultrahdr.cpp:1296-1441) — no JPEG round
    trip, effects honored."""

    def test_p010_passthrough(self):
        src = p010()
        img = UltraHdr().add_raw(src).convert_to_raw(UltraHdrConfig(
            output_pixel_format=PixelFormat.P010))
        assert img is src

    def test_yuv420_with_effects(self):
        u = UltraHdr().add_raw(p010())
        img = u.convert_to_raw(UltraHdrConfig(
            output_pixel_format=PixelFormat.YUV420,
            effects=[editor.MirrorEffect("horizontal")]))
        assert img.fmt == PixelFormat.YUV420
        assert img.width == 96 and img.height == 64
        # Mirrored: equals the plain SDR flipped.
        plain = UltraHdr().add_raw(p010()).convert_to_raw(
            UltraHdrConfig(output_pixel_format=PixelFormat.YUV420))
        assert np.array_equal(np.asarray(img.planes["y"]),
                              np.asarray(plain.planes["y"])[:, ::-1])

    def test_rgba8888_sdr(self):
        img = UltraHdr().add_raw(p010()).convert_to_raw(UltraHdrConfig(
            output_format=OutputFormat.SDR))
        assert img.fmt == PixelFormat.RGBA8888
        assert np.asarray(img.planes["rgba"]).shape == (64, 96)

    def test_hdr_direct_matches_apply(self):
        """F16 output equals ops.gainmap.apply_gainmap on the session's
        own planes (no compress/decompress round trip)."""
        from libultrahdr_dev.ops import gainmap as gm

        u = UltraHdr().add_raw(p010())
        img = u.convert_to_raw(UltraHdrConfig(
            output_format=OutputFormat.HDR_LINEAR,
            max_display_boost=4.9))
        ref = gm.apply_gainmap(
            np.asarray(u.sdr_raw.planes["y"]),
            np.asarray(u.sdr_raw.planes["u"]),
            np.asarray(u.sdr_raw.planes["v"]),
            u.gainmap_raw, u.metadata, "hdr_linear", 4.9)
        assert np.array_equal(np.asarray(img.planes["rgba"]),
                              np.asarray(ref))

    def test_10bit_planar(self):
        img = UltraHdr().add_raw(p010()).convert_to_raw(UltraHdrConfig(
            output_pixel_format=PixelFormat.RGB_10BIT_PLANAR,
            max_display_boost=4.9))
        assert img.fmt == PixelFormat.RGB_10BIT_PLANAR
        arr = np.asarray(img.planes["rgba"])
        assert arr.shape == (3, 64, 96) and arr.max() <= 1023


class TestHeifFlows:
    """HEIC_R/AVIF_R converter flows (ultrahdr.cpp:1049-1287)."""

    def setup_method(self):
        from libultrahdr_dev.heifr import heif_available
        if not heif_available():
            pytest.skip("libheif not installed")

    def test_flow_p010_to_avifr_and_back(self):
        u = UltraHdr().add_raw(p010())
        blob = u.convert(UltraHdrConfig(output_codec="avif_r",
                                        transfer=ColorTransfer.HLG))
        assert sniff_format(blob) == "avif"
        u2 = UltraHdr().add_image(blob)
        assert u2.gainmap_raw is not None and u2.metadata is not None
        out = u2.convert(UltraHdrConfig(output_codec="jpeg_r"))
        assert sniff_format(out) == "jpeg_r"

    def test_flow_heicr_sample_to_jpegr(self):
        import os
        path = "/root/reference/tests/data/sample_heicr.heic"
        if not os.path.exists(path):
            pytest.skip("fixture unavailable")
        u = UltraHdr().add_image(open(path, "rb").read())
        blob = u.convert(UltraHdrConfig(output_codec="jpeg_r"))
        assert sniff_format(blob) == "jpeg_r"
        res = JpegR().get_info(blob)
        assert (res.width, res.height) == (1280, 720)

    def test_flow_p010_to_10bit_heic(self):
        u = UltraHdr().add_raw(p010())
        blob = u.convert(UltraHdrConfig(output_codec="heic_10bit",
                                        transfer=ColorTransfer.HLG,
                                        max_display_boost=4.9))
        assert sniff_format(blob) == "heic"

    def test_flow_avifr_with_effects(self):
        u = UltraHdr().add_raw(p010())
        blob = u.convert(UltraHdrConfig(
            output_codec="avif_r", transfer=ColorTransfer.HLG,
            effects=[editor.MirrorEffect("vertical")]))
        assert sniff_format(blob) == "avif"

    def test_flow_10bit_avif_to_jpegr(self):
        """10-bit HEIF primary -> hdr_raw P010 -> JPEG/R (testFlow
        analog over avif_yuv_420_10bit.avif)."""
        import os
        path = "/root/reference/tests/data/avif_yuv_420_10bit.avif"
        if not os.path.exists(path):
            pytest.skip("fixture unavailable")
        u = UltraHdr().add_image(open(path, "rb").read())
        assert u.hdr_raw is not None
        assert u.hdr_raw.fmt == PixelFormat.P010
        assert u.hdr_raw.width == 120 and u.hdr_raw.height == 160
        blob = u.convert(UltraHdrConfig(output_codec="jpeg_r",
                                        transfer=ColorTransfer.HLG))
        assert sniff_format(blob) == "jpeg_r"

    def test_flow_heicr_to_avifr(self):
        """testFlow4 analog: HEIC_R/AVIF_R gain-map container in ->
        re-encoded gain-map container out."""
        import os
        path = "/root/reference/tests/data/sample_heicr.heic"
        if not os.path.exists(path):
            pytest.skip("fixture unavailable")
        u = UltraHdr().add_image(open(path, "rb").read())
        blob = u.convert(UltraHdrConfig(output_codec="avif_r"))
        assert sniff_format(blob) == "avif"
        u2 = UltraHdr().add_image(blob)
        assert u2.gainmap_raw is not None
        assert u2.metadata.max_content_boost == pytest.approx(
            u.metadata.max_content_boost, rel=1e-4)


class TestReviewRegressions:
    def test_heif10_pq_transfer_reaches_gainmap(self):
        """_convert_to_heif10 must carry the caller's transfer into
        gain-map generation: PQ input implies a 10000/203 max boost in
        the session metadata, not HLG's 1000/203."""
        from libultrahdr_dev.heifr import heif_available
        if not heif_available():
            pytest.skip("libheif not installed")
        img = p010()
        img.transfer = ColorTransfer.PQ
        u = UltraHdr().add_raw(img)
        blob = u.convert(UltraHdrConfig(output_codec="heic_10bit",
                                        transfer=ColorTransfer.PQ,
                                        max_display_boost=49.3))
        assert sniff_format(blob) == "heic"
        assert u.metadata.max_content_boost == pytest.approx(
            10000 / 203, rel=1e-6)

    def test_sdr_decode_without_gainmap_xmp(self):
        """SDR output must not require gain-map metadata (the gain map
        is never applied); HDR output must still demand it."""
        from libultrahdr_dev.types import OutputFormat, UhdrError
        from libultrahdr_dev.container import jfif, mux

        blob = JpegR().encode_api0(p010(), ColorTransfer.HLG)
        primary, gmap = mux.extract_primary_and_gainmap(blob)
        # strip the gain-map image's XMP APP1
        segs, _ = jfif.scan_segments(gmap, 0)
        for seg in segs:
            if seg.marker == 0xE1 and seg.payload.startswith(
                    jfif.XMP_SIG):
                ln = 4 + len(seg.payload)
                gmap = gmap[:seg.offset] + gmap[seg.offset + ln:]
                break
        else:
            pytest.fail("no XMP segment found in gain map image")
        # re-mux without regenerating XMP: primary [SOI..EOI] + gmap
        stripped = primary + gmap
        res = JpegR().decode(stripped, OutputFormat.SDR)
        assert res.image is not None
        with pytest.raises(UhdrError):
            JpegR().decode(stripped, OutputFormat.HDR_LINEAR)


class TestCodecRouting:
    """All nine ultrahdr_codec outputs route correctly
    (ultrahdr.h:79-88; RAW_PIXELS is convert_to_raw, tested above)."""

    @staticmethod
    def _needs_heif():
        from libultrahdr_dev.heifr import heif_available
        if not heif_available():
            pytest.skip("libheif not installed")

    def test_jpeg_outputs(self):
        u = UltraHdr().add_raw(p010())
        out = u.convert(UltraHdrConfig(output_codec="jpeg"))
        assert sniff_format(out) == "jpeg"
        out = u.convert(UltraHdrConfig(output_codec="jpeg_r"))
        assert sniff_format(out) == "jpeg_r"

    @pytest.mark.parametrize("codec", ["heic", "avif"])
    def test_sdr_heif_is_8bit_no_gainmap(self, codec):
        """ULTRAHDR_CODEC_HEIC/AVIF = plain 8-bit SDR rendition
        (ultrahdr.cpp:1181-1206 -> heifr.cpp:271-279 'only encode
        heif'), not a gain-map or 10-bit container."""
        self._needs_heif()
        from libultrahdr_dev.container import isobmff as iso
        from libultrahdr_dev.container import libheif as lh
        u = UltraHdr().add_raw(p010())
        out = u.convert(UltraHdrConfig(output_codec=codec,
                                       transfer=ColorTransfer.HLG))
        assert sniff_format(out) == codec
        hp = iso.parse_heif(out)
        assert not any(it.item_type == "tmap"
                       for it in hp.items.values())
        planes, depth = lh.decode_primary_depth(out, monochrome=False)
        assert depth == 8
        assert planes[0].shape == (64, 96)

    @pytest.mark.parametrize("codec", ["heic", "avif"])
    def test_10bit_heif_is_10bit(self, codec):
        self._needs_heif()
        from libultrahdr_dev.container import libheif as lh
        u = UltraHdr().add_raw(p010())
        out = u.convert(UltraHdrConfig(output_codec=codec + "_10bit",
                                       transfer=ColorTransfer.HLG,
                                       max_display_boost=4.9))
        assert sniff_format(out) == codec
        _, depth = lh.decode_primary_depth(out, monochrome=False)
        assert depth == 10

    @pytest.mark.parametrize("codec", ["heic", "avif"])
    def test_gainmap_heif_has_tmap(self, codec):
        self._needs_heif()
        from libultrahdr_dev.container import isobmff as iso
        u = UltraHdr().add_raw(p010())
        out = u.convert(UltraHdrConfig(output_codec=codec + "_r",
                                       transfer=ColorTransfer.HLG))
        assert sniff_format(out) == codec
        hp = iso.parse_heif(out)
        assert any(it.item_type == "tmap" for it in hp.items.values())

    def test_unknown_codec_rejected(self):
        with pytest.raises(UhdrError):
            UltraHdr().add_raw(p010()).convert(
                UltraHdrConfig(output_codec="webp"))


class TestHeifExif:
    EXIF = b"Exif\x00\x00MM\x00*\x00\x00\x00\x08" + bytes(range(64))

    @staticmethod
    def _needs_heif():
        from libultrahdr_dev.heifr import heif_available
        if not heif_available():
            pytest.skip("libheif not installed")

    def test_exif_survives_jpegr_heicr_jpegr(self):
        """EXIF round trip JPEG_R -> HEIC_R -> JPEG_R byte-identically
        (heifr.cpp:266-268 encode; heifr.cpp:324-331 decode)."""
        self._needs_heif()
        from libultrahdr_dev.container import jfif
        jr_blob = JpegR().encode_api0(p010(), ColorTransfer.HLG,
                                      quality=95, exif=self.EXIF)
        u = UltraHdr().add_image(jr_blob)
        assert u.exif == self.EXIF
        heic_blob = u.convert(UltraHdrConfig(output_codec="heic_r"))
        u2 = UltraHdr().add_image(heic_blob)
        assert u2.exif == self.EXIF
        jr_out = u2.convert(UltraHdrConfig(output_codec="jpeg_r"))
        info = jfif.parse_jpeg_info(jr_out)
        assert info.exif == self.EXIF

    def test_exif_on_sdr_heif_output(self):
        self._needs_heif()
        from libultrahdr_dev.container import libheif as lh
        u = UltraHdr().add_raw(p010())
        u.exif = self.EXIF
        out = u.convert(UltraHdrConfig(output_codec="heic"))
        assert lh.extract_exif(out) == self.EXIF

    def test_exif_on_10bit_heif_output(self):
        self._needs_heif()
        from libultrahdr_dev.container import libheif as lh
        u = UltraHdr().add_raw(p010())
        u.exif = self.EXIF
        out = u.convert(UltraHdrConfig(output_codec="heic_10bit",
                                       transfer=ColorTransfer.HLG,
                                       max_display_boost=4.9))
        assert lh.extract_exif(out) == self.EXIF

    def test_plain_heif_ingest_reads_exif(self):
        self._needs_heif()
        from libultrahdr_dev.container import libheif as lh
        rng = np.random.default_rng(5)
        planes = (rng.integers(0, 255, (64, 96), dtype=np.uint8),
                  np.full((32, 48), 128, np.uint8),
                  np.full((32, 48), 128, np.uint8))
        blob = lh.encode_image(planes, "heic", 90, exif=self.EXIF)
        u = UltraHdr().add_image(blob)
        assert u.exif == self.EXIF
        assert u.sdr_raw is not None
