"""Container/metadata codec tests: XMP, ICC, MPF, marker scanner, mux.

Byte-parity goldens in tests/goldens/ were generated by the compiled
reference implementation (tools/build_reference_oracle.sh +
tools/golden_main.cpp) from /root/reference.
"""

import os
import struct

import pytest

from libultrahdr_dev.container import icc, jfif, mpf, mux, xmp
from libultrahdr_dev.types import GainMapMetadata, UhdrError

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
REF_DATA = "/root/reference/tests/data"


def load_golden(name):
    path = os.path.join(GOLDENS, name)
    if not os.path.exists(path):
        pytest.skip(f"golden {name} not available")
    with open(path, "rb") as f:
        return f.read()


def hlg_metadata():
    # maxContentBoost as float32(1000/203) the way the reference
    # computes it.
    import numpy as np
    boost = float(np.float32(1000.0) / np.float32(203.0))
    return GainMapMetadata(
        max_content_boost=boost, min_content_boost=1.0,
        hdr_capacity_min=1.0, hdr_capacity_max=boost)


class TestXmpWriter:
    def test_secondary_byte_parity(self):
        want = load_golden("xmp_secondary.bin")
        got = xmp.generate_xmp_for_secondary_image(hlg_metadata()).encode()
        assert got == want

    def test_primary_byte_parity(self):
        want = load_golden("xmp_primary.bin")
        got = xmp.generate_xmp_for_primary_image(66171, hlg_metadata()).encode()
        assert got == want

    def test_parse_roundtrip(self):
        md = hlg_metadata()
        body = xmp.generate_xmp_for_secondary_image(md).encode()
        payload = xmp.XMP_NAMESPACE.encode() + b"\x00" + body
        parsed = xmp.get_metadata_from_xmp(payload)
        assert parsed.version == "1.0"
        assert parsed.max_content_boost == pytest.approx(
            md.max_content_boost, rel=1e-4)
        assert parsed.min_content_boost == pytest.approx(1.0)
        assert parsed.gamma == 1.0
        assert parsed.offset_sdr == 0.0
        assert parsed.hdr_capacity_max == pytest.approx(
            md.max_content_boost, rel=1e-4)

    def test_parse_missing_required(self):
        payload = (xmp.XMP_NAMESPACE.encode() + b"\x00"
                   + b'<rdf:Description hdrgm:Version="1.0"/>')
        with pytest.raises(UhdrError):
            xmp.get_metadata_from_xmp(payload)

    def test_parse_defaults(self):
        payload = (xmp.XMP_NAMESPACE.encode() + b"\x00"
                   + b'<rdf:Description hdrgm:Version="1.0" '
                     b'hdrgm:GainMapMax="2" hdrgm:HDRCapacityMax="2"/>')
        md = xmp.get_metadata_from_xmp(payload)
        assert md.max_content_boost == 4.0
        assert md.min_content_boost == 1.0
        assert md.offset_sdr == pytest.approx(1 / 64)
        assert md.hdr_capacity_min == 1.0

    def test_rejects_base_rendition_hdr(self):
        payload = (xmp.XMP_NAMESPACE.encode() + b"\x00"
                   + b'<rdf:Description hdrgm:Version="1.0" '
                     b'hdrgm:GainMapMax="2" hdrgm:HDRCapacityMax="2" '
                     b'hdrgm:BaseRenditionIsHDR="True"/>')
        with pytest.raises(UhdrError):
            xmp.get_metadata_from_xmp(payload)

    def test_rejects_wrong_namespace(self):
        with pytest.raises(UhdrError):
            xmp.get_metadata_from_xmp(b"http://wrong/\x00<x/>")

    def test_parse_with_packet_wrapper(self):
        body = (b'<?xpacket begin="" id="W5M0MpCehiHzreSzNTczkc9d"?>'
                + xmp.generate_xmp_for_secondary_image(hlg_metadata()).encode()
                + b'<?xpacket end="w"?>   ')
        payload = xmp.XMP_NAMESPACE.encode() + b"\x00" + body
        md = xmp.get_metadata_from_xmp(payload)
        assert md.version == "1.0"


class TestIcc:
    @pytest.mark.parametrize("tf,tfc", [("srgb", 3), ("hlg", 1), ("pq", 2)])
    @pytest.mark.parametrize("gamut,gc", [("bt709", 0), ("p3", 1),
                                          ("bt2100", 2)])
    def test_byte_parity(self, tf, tfc, gamut, gc):
        want = load_golden(f"icc_{tfc}_{gc}.bin")
        got = icc.write_icc_profile(tf, gamut)
        assert got == want

    def test_read_gamut_roundtrip(self):
        for gamut in ("bt709", "p3", "bt2100"):
            data = icc.write_icc_profile("srgb", gamut)
            assert icc.read_icc_color_gamut(data) == gamut

    def test_read_gamut_garbage(self):
        assert icc.read_icc_color_gamut(b"junk") == "unspecified"
        assert icc.read_icc_color_gamut(
            icc.ICC_IDENTIFIER + b"\x00" * 200) == "unspecified"


class TestMpf:
    def test_size(self):
        assert mpf.calculate_mpf_size() == 86
        assert len(mpf.generate_mpf(1000, 0, 500, 900)) == 86

    def test_fields(self):
        data = mpf.generate_mpf(0x1234, 0, 0x55, 0x66)
        assert data[:4] == b"MPF\x00"
        assert data[4:8] == bytes([0x4D, 0x4D, 0x00, 0x2A])  # big endian
        # primary size in first MP entry
        assert struct.unpack(">I", data[58:62])[0] == 0x1234
        assert struct.unpack(">I", data[74:78])[0] == 0x55


def tiny_jpeg(marker_payloads=()):
    """Minimal scannable JPEG: SOI + optional APP1s + SOF0 + SOS + EOI."""
    out = bytearray(b"\xff\xd8")
    for marker, payload in marker_payloads:
        length = len(payload) + 2
        out += bytes([0xFF, marker, length >> 8, length & 0xFF]) + payload
    sof = bytes([0x08, 0x00, 0x10, 0x00, 0x20, 0x01, 0x01, 0x11, 0x00])
    out += bytes([0xFF, 0xC0, 0x00, len(sof) + 2]) + sof
    sos = bytes([0x01, 0x01, 0x00, 0x00, 0x3F, 0x00])
    out += bytes([0xFF, 0xDA, 0x00, len(sos) + 2]) + sos
    out += b"\x12\x34\x56"  # entropy data
    out += b"\xff\xd9"
    return bytes(out)


class TestJfif:
    def test_scan_and_dims(self):
        info = jfif.parse_jpeg_info(tiny_jpeg())
        assert (info.width, info.height) == (32, 16)
        assert info.num_components == 1

    def test_exif_xmp_harvest(self):
        exif = jfif.EXIF_SIG + b"\x01\x02"
        xmp_payload = jfif.XMP_SIG + b"<x/>"
        img = tiny_jpeg([(0xE1, exif), (0xE1, xmp_payload)])
        info = jfif.parse_jpeg_info(img)
        assert info.exif == exif
        assert info.xmp == xmp_payload

    def test_strip_exif(self):
        exif = jfif.EXIF_SIG + b"\x01\x02\x03"
        img = tiny_jpeg([(0xE1, exif)])
        stripped, extracted = jfif.strip_exif(img)
        assert extracted == exif
        assert jfif.parse_jpeg_info(stripped).exif is None
        assert stripped == tiny_jpeg()

    def test_find_image_ranges(self):
        a, b = tiny_jpeg(), tiny_jpeg([(0xE1, jfif.XMP_SIG + b"<y/>")])
        blob = a + b
        ranges = jfif.find_image_ranges(blob)
        assert len(ranges) == 2
        assert blob[ranges[0][0]:ranges[0][1]] == a
        assert blob[ranges[1][0]:ranges[1][1]] == b

    def test_reference_sample(self):
        if not os.path.exists(os.path.join(REF_DATA, "sample_jpegr.jpeg")):
            pytest.skip("reference test data not available")
        with open(os.path.join(REF_DATA, "sample_jpegr.jpeg"), "rb") as f:
            blob = f.read()
        primary, gm = mux.extract_primary_and_gainmap(blob)
        pinfo = jfif.parse_jpeg_info(primary)
        ginfo = jfif.parse_jpeg_info(gm)
        assert (pinfo.width, pinfo.height) == (1280, 720)
        assert (ginfo.width, ginfo.height) == (320, 180)
        assert ginfo.xmp is not None
        md = xmp.get_metadata_from_xmp(ginfo.xmp)
        assert md.max_content_boost == pytest.approx(10.0, rel=1e-4)
        assert mux.is_uhdr_image(blob)
        assert not mux.is_uhdr_image(primary)


class TestMux:
    def test_roundtrip(self):
        md = hlg_metadata()
        primary = tiny_jpeg()
        gainmap = tiny_jpeg()
        blob = mux.append_gainmap(primary, gainmap, md,
                                  icc=icc.write_icc_profile("srgb", "bt709"))
        p2, g2 = mux.extract_primary_and_gainmap(blob)
        ginfo = jfif.parse_jpeg_info(g2)
        parsed = xmp.get_metadata_from_xmp(ginfo.xmp)
        assert parsed.max_content_boost == pytest.approx(
            md.max_content_boost, rel=1e-4)
        assert mux.is_uhdr_image(blob)

    def test_oracle_encoded_parses(self):
        blob = load_golden("enc0_hlg.jpegr")
        primary, gm = mux.extract_primary_and_gainmap(blob)
        pinfo = jfif.parse_jpeg_info(primary)
        assert (pinfo.width, pinfo.height) == (1280, 720)
        ginfo = jfif.parse_jpeg_info(gm)
        assert (ginfo.width, ginfo.height) == (320, 180)
        md = xmp.get_metadata_from_xmp(ginfo.xmp)
        assert md.max_content_boost == pytest.approx(1000 / 203, rel=1e-4)
        assert pinfo.icc is not None
        assert icc.read_icc_color_gamut(pinfo.icc) == "bt2100"

    def test_xmp_segments_match_oracle_bytes(self):
        """The XMP our writers generate must equal, byte for byte, the
        XMP segments inside a container produced by the reference."""
        blob = load_golden("enc0_hlg.jpegr")
        primary, gm = mux.extract_primary_and_gainmap(blob)
        pinfo = jfif.parse_jpeg_info(primary)
        ginfo = jfif.parse_jpeg_info(gm)
        md = hlg_metadata()
        want_secondary = (jfif.XMP_SIG
                          + xmp.generate_xmp_for_secondary_image(md).encode())
        assert ginfo.xmp == want_secondary
        # secondary image size as laid out in the container == len(gm).
        want_primary = (jfif.XMP_SIG + xmp.generate_xmp_for_primary_image(
            len(gm), md).encode())
        assert pinfo.xmp == want_primary

    def test_mpf_matches_oracle_bytes(self):
        """Our MPF payload must equal the reference's for the same
        layout."""
        blob = load_golden("enc0_hlg.jpegr")
        primary, gm = mux.extract_primary_and_gainmap(blob)
        # Locate the APP2 MPF segment in the container.
        segs, _ = jfif.scan_segments(blob, 0)
        mpf_seg = next(s for s in segs
                       if s.marker == 0xE2 and s.payload.startswith(b"MPF\x00"))
        assert mpf_seg.payload == mpf.generate_mpf(
            len(primary), 0, len(gm),
            len(primary) - (mpf_seg.offset + 8))

    def test_exif_conflict_rejected(self):
        exif = jfif.EXIF_SIG + b"\x00"
        primary = tiny_jpeg([(0xE1, exif)])
        with pytest.raises(UhdrError):
            mux.append_gainmap(primary, tiny_jpeg(), hlg_metadata(),
                               exif=b"external")

    def test_exif_hoisted(self):
        exif = jfif.EXIF_SIG + b"\xaa\xbb"
        primary = tiny_jpeg([(0xE1, exif)])
        blob = mux.append_gainmap(primary, tiny_jpeg(), hlg_metadata())
        # EXIF must be the first APP1 after SOI.
        segs, _ = jfif.scan_segments(blob, 0)
        assert segs[1].marker == 0xE1
        assert segs[1].payload == exif

    def test_bad_metadata_rejected(self):
        md = hlg_metadata()
        md.min_content_boost = md.max_content_boost + 1
        with pytest.raises(UhdrError):
            mux.append_gainmap(tiny_jpeg(), tiny_jpeg(), md)
