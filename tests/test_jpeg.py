"""In-framework JPEG codec tests: self-roundtrip, cross-validation
against PIL (libjpeg), and decode of reference-encoded files."""

import io
import os

import numpy as np
import pytest

from libultrahdr_dev.jpeg import codec, tables
from libultrahdr_dev.jpeg.dct import dequant_idct, fdct_quant

REF_DATA = "/root/reference/tests/data"


def smooth_plane(h, w, seed=0, lo=0, hi=255):
    """Band-limited content (JPEG-friendly) for roundtrip tests."""
    rng = np.random.default_rng(seed)
    small = rng.integers(lo, hi, (h // 8 + 1, w // 8 + 1)).astype(np.float32)
    big = np.kron(small, np.ones((8, 8), np.float32))[:h, :w]
    # light blur via box filter
    big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)
           + np.roll(big, (1, 1), (0, 1))) / 4.0
    return np.clip(big, 0, 255).astype(np.uint8)


class TestDct:
    def test_dct_roundtrip_lossless_q1(self):
        # With an all-ones quant table the DCT/IDCT roundtrip should be
        # nearly exact for u8 input.
        rng = np.random.default_rng(1)
        plane = rng.integers(0, 256, (32, 32)).astype(np.uint8)
        q = np.ones((8, 8), np.int32)
        coefs = fdct_quant(plane, q)
        back = np.asarray(dequant_idct(np.asarray(coefs), q, 32, 32))
        assert np.abs(back.astype(int) - plane.astype(int)).max() <= 1

    def test_dc_coefficient(self):
        plane = np.full((8, 8), 200, np.uint8)
        q = np.ones((8, 8), np.int32)
        coefs = np.asarray(fdct_quant(plane, q))
        # DC of a uniform block: (200-128)*8 = 576; ACs zero.
        assert coefs[0, 0] == 576
        assert np.all(coefs[0, 1:] == 0)

    def test_quant_divides(self):
        plane = np.full((8, 8), 200, np.uint8)
        q = np.full((8, 8), 16, np.int32)
        coefs = np.asarray(fdct_quant(plane, q))
        assert coefs[0, 0] == 36  # 576/16


class TestQuality:
    def test_quality_scaling(self):
        q50 = tables.scale_quant_table(tables.STD_LUMINANCE_QUANT, 50)
        np.testing.assert_array_equal(q50, tables.STD_LUMINANCE_QUANT)
        q100 = tables.scale_quant_table(tables.STD_LUMINANCE_QUANT, 100)
        assert q100.max() == 1
        q10 = tables.scale_quant_table(tables.STD_LUMINANCE_QUANT, 10)
        assert q10.max() == 255  # clamped baseline


def psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


class TestRoundtrip:
    def test_gray_self_roundtrip(self):
        y = smooth_plane(64, 48, seed=2)
        blob = codec.encode_jpeg({"y": y}, quality=95)
        dec = codec.decode_jpeg(blob)
        assert (dec.width, dec.height) == (48, 64)
        assert dec.ncomp == 1
        assert psnr(dec.planes[0], y) > 40

    def test_yuv420_self_roundtrip(self):
        h, w = 64, 80
        y = smooth_plane(h, w, seed=3)
        u = smooth_plane(h // 2, w // 2, seed=4, lo=96, hi=160)
        v = smooth_plane(h // 2, w // 2, seed=5, lo=96, hi=160)
        blob = codec.encode_jpeg({"y": y, "u": u, "v": v}, quality=95)
        dec = codec.decode_jpeg(blob)
        assert dec.ncomp == 3
        assert dec.sampling[0] == (2, 2)
        assert psnr(dec.planes[0], y) > 40
        assert psnr(dec.planes[1], u) > 40
        assert psnr(dec.planes[2], v) > 40

    def test_unaligned_dims(self):
        h, w = 50, 54  # not multiples of 16
        y = smooth_plane(h, w, seed=6)
        u = smooth_plane(25, 27, seed=7, lo=100, hi=156)
        v = smooth_plane(25, 27, seed=8, lo=100, hi=156)
        blob = codec.encode_jpeg({"y": y, "u": u, "v": v}, quality=90)
        dec = codec.decode_jpeg(blob)
        assert (dec.width, dec.height) == (w, h)
        assert dec.planes[0].shape == (h, w)
        assert dec.planes[1].shape == (25, 27)
        assert psnr(dec.planes[0], y) > 35

    def test_restart_intervals(self):
        h, w = 64, 64
        y = smooth_plane(h, w, seed=9)
        u = smooth_plane(32, 32, seed=10, lo=96, hi=160)
        v = smooth_plane(32, 32, seed=11, lo=96, hi=160)
        blob = codec.encode_jpeg({"y": y, "u": u, "v": v}, quality=92,
                                 restart_interval=2)
        assert b"\xff\xdd" in blob  # DRI marker present
        dec = codec.decode_jpeg(blob)
        assert psnr(dec.planes[0], y) > 40

    def test_icc_embedded(self):
        from libultrahdr_dev.container import icc as icc_mod
        y = smooth_plane(16, 16)
        profile = icc_mod.write_icc_profile("srgb", "p3")
        blob = codec.encode_jpeg({"y": y}, quality=90, icc=profile)
        dec = codec.decode_jpeg(blob)
        assert dec.icc == profile
        assert icc_mod.read_icc_color_gamut(dec.icc) == "p3"


class TestCrossValidationPIL:
    """PIL wraps libjpeg — same codec family as the reference."""

    def _pil(self):
        return pytest.importorskip("PIL.Image")

    def test_pil_decodes_our_gray(self):
        Image = self._pil()
        y = smooth_plane(40, 56, seed=12)
        blob = codec.encode_jpeg({"y": y}, quality=95)
        img = Image.open(io.BytesIO(blob))
        got = np.asarray(img.convert("L"))
        assert got.shape == (40, 56)
        assert psnr(got, y) > 40

    def test_pil_decodes_our_yuv(self):
        Image = self._pil()
        h, w = 48, 64
        # neutral chroma -> PIL RGB output should be ~gray of y
        y = smooth_plane(h, w, seed=13)
        u = np.full((h // 2, w // 2), 128, np.uint8)
        v = np.full((h // 2, w // 2), 128, np.uint8)
        blob = codec.encode_jpeg({"y": y, "u": u, "v": v}, quality=95)
        img = Image.open(io.BytesIO(blob))
        got = np.asarray(img.convert("RGB"))
        assert got.shape == (h, w, 3)
        assert psnr(got[:, :, 1], y) > 38

    def test_we_decode_pil_output(self):
        Image = self._pil()
        h, w = 48, 64
        rgb = np.dstack([smooth_plane(h, w, seed=s) for s in (14, 15, 16)])
        buf = io.BytesIO()
        Image.fromarray(rgb).save(buf, "JPEG", quality=92)
        dec = codec.decode_jpeg(buf.getvalue())
        assert (dec.width, dec.height) == (w, h)
        assert dec.ncomp == 3
        # libjpeg luma from RGB:
        want_y = (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1]
                  + 0.114 * rgb[..., 2])
        assert psnr(dec.planes[0], np.round(want_y)) > 30

    def test_decode_reference_jpeg(self):
        path = os.path.join(REF_DATA, "jpeg_image.jpg")
        if not os.path.exists(path):
            pytest.skip("reference data unavailable")
        with open(path, "rb") as f:
            dec = codec.decode_jpeg(f.read())
        assert dec.width > 0 and dec.height > 0
        Image = self._pil()
        want = np.asarray(Image.open(path).convert("YCbCr"))[:, :, 0]
        assert psnr(dec.planes[0], want) > 35

    def test_decode_minnie_gray(self):
        path = os.path.join(REF_DATA, "minnie-320x240-y.jpg")
        if not os.path.exists(path):
            pytest.skip("reference data unavailable")
        with open(path, "rb") as f:
            dec = codec.decode_jpeg(f.read())
        assert (dec.width, dec.height) == (320, 240)
        Image = self._pil()
        want = np.asarray(Image.open(path).convert("L"))
        assert psnr(dec.planes[0], want) > 45


class TestProgressive:
    """Progressive (SOF2) decode — the reference inherits this from
    libjpeg; here multi-scan orchestration over native per-scan
    decoders (jpeg/native/entropy.cpp uhdr_prog_*)."""

    def _roundtrip(self, img_array, mode, **save_kw):
        Image = pytest.importorskip("PIL.Image")
        buf = io.BytesIO()
        Image.fromarray(img_array).convert(mode).save(
            buf, "JPEG", progressive=True, **save_kw)
        blob = buf.getvalue()
        dec = codec.decode_jpeg(blob)
        # must match the baseline decode of the same pixels bitstream-
        # independently: compare against PIL's own decode.
        return dec, Image.open(io.BytesIO(blob))

    def test_progressive_color(self):
        rgb = np.dstack([smooth_plane(64, 80, seed=s) for s in (1, 2, 3)])
        dec, pil = self._roundtrip(rgb, "RGB", quality=92)
        want = np.asarray(pil.convert("YCbCr"))[:, :, 0]
        assert dec.ncomp == 3 and dec.sampling[0] == (2, 2)
        assert psnr(dec.planes[0], want) > 45

    def test_progressive_gray(self):
        y = smooth_plane(56, 72, seed=4)
        dec, pil = self._roundtrip(y, "L", quality=90)
        want = np.asarray(pil.convert("L"))
        assert psnr(dec.planes[0], want) > 49

    def test_progressive_with_restarts(self):
        rgb = np.dstack([smooth_plane(48, 48, seed=s) for s in (5, 6, 7)])
        Image = pytest.importorskip("PIL.Image")
        buf = io.BytesIO()
        Image.fromarray(rgb).save(buf, "JPEG", quality=85,
                                  progressive=True,
                                  restart_marker_blocks=2)
        dec = codec.decode_jpeg(buf.getvalue())
        want = np.asarray(Image.open(buf).convert("YCbCr"))[:, :, 0]
        assert psnr(dec.planes[0], want) > 45

    def test_progressive_matches_baseline_decode(self):
        rgb = np.dstack([smooth_plane(64, 64, seed=s) for s in (8, 9, 10)])
        Image = pytest.importorskip("PIL.Image")
        b1, b2 = io.BytesIO(), io.BytesIO()
        Image.fromarray(rgb).save(b1, "JPEG", quality=92)
        Image.fromarray(rgb).save(b2, "JPEG", quality=92,
                                  progressive=True)
        d1 = codec.decode_jpeg(b1.getvalue())
        d2 = codec.decode_jpeg(b2.getvalue())
        # same quantized coefficients -> identical planes
        for p1, p2 in zip(d1.planes, d2.planes):
            np.testing.assert_array_equal(p1, p2)


class TestErrors:

    def test_garbage_rejected(self):
        from libultrahdr_dev.types import UhdrError
        with pytest.raises(UhdrError):
            codec.decode_jpeg(b"\x00" * 100)
        with pytest.raises(UhdrError):
            codec.decode_jpeg(b"\xff\xd8" + b"\xff\xc0\x00\x04\x08\x00")


class TestMultiScanBaseline:
    """Multi-scan baseline (several SOS under SOF0, T.81 A.2):
    decode must match the equivalent single-scan file."""

    def _build_multiscan(self, y, u, v, w, h, quality=90):
        """Author a 3-scan (Y)(Cb)(Cr) non-interleaved baseline JPEG
        from YUV420 planes using the framework's own entropy encoder."""
        import numpy as np
        from libultrahdr_dev.jpeg import codec, tables
        from libultrahdr_dev.jpeg.dct import fdct_quant

        ql = tables.scale_quant_table(tables.STD_LUMINANCE_QUANT, quality)
        qc = tables.scale_quant_table(tables.STD_CHROMINANCE_QUANT,
                                      quality)
        out = bytearray(b"\xff\xd8")
        out += codec._jfif_app0()
        out += codec._marker(0xDB, codec._dqt(0, ql))
        out += codec._marker(0xDB, codec._dqt(1, qc))
        out += codec._marker(0xC0, codec._sof0(
            w, h, [(1, 2, 2, 0), (2, 1, 1, 1), (3, 1, 1, 1)]))
        out += codec._marker(0xC4, codec._dht(0, 0, tables.DC_LUMA_BITS,
                                              tables.DC_LUMA_VALS))
        out += codec._marker(0xC4, codec._dht(1, 0, tables.AC_LUMA_BITS,
                                              tables.AC_LUMA_VALS))
        out += codec._marker(0xC4, codec._dht(0, 1,
                                              tables.DC_CHROMA_BITS,
                                              tables.DC_CHROMA_VALS))
        out += codec._marker(0xC4, codec._dht(1, 1,
                                              tables.AC_CHROMA_BITS,
                                              tables.AC_CHROMA_VALS))
        luma_tabs = ((tables.DC_LUMA_BITS, tables.DC_LUMA_VALS),
                     (tables.AC_LUMA_BITS, tables.AC_LUMA_VALS))
        chroma_tabs = ((tables.DC_CHROMA_BITS, tables.DC_CHROMA_VALS),
                       (tables.AC_CHROMA_BITS, tables.AC_CHROMA_VALS))
        planes = [(y, ql, 1, 0, luma_tabs),
                  (u, qc, 2, 1, chroma_tabs),
                  (v, qc, 3, 1, chroma_tabs)]
        for plane, q, cid, tid, (dct_, act_) in planes:
            # Non-interleaved scan: ceil(dim/8) block grid.
            ph, pw = plane.shape
            zz = np.asarray(fdct_quant(codec._pad_plane(plane, 8), q))
            bh, bw = -(-ph // 8), -(-pw // 8)
            zz = zz.reshape(bh, bw, 64)[:bh, :bw].reshape(-1, 64)
            out += codec._marker(
                0xDA, bytes([1, cid, (tid << 4) | tid, 0, 63, 0]))
            dc_tabs = [None] * 4
            ac_tabs = [None] * 4
            dc_tabs[tid] = dct_
            ac_tabs[tid] = act_
            out += codec.entropy_encode(
                zz, np.zeros(zz.shape[0], np.uint8), [tid], [tid],
                dc_tabs, ac_tabs, 0, 1)
        out += b"\xff\xd9"
        return bytes(out)

    def test_multiscan_matches_single_scan(self):
        import numpy as np
        from libultrahdr_dev.jpeg import codec

        rng = np.random.default_rng(3)
        w, h = 24, 20  # odd block counts: luma ceil-dims != MCU-padded
        y = rng.integers(0, 255, (h, w), np.uint8)
        u = rng.integers(0, 255, (h // 2, w // 2), np.uint8)
        v = rng.integers(0, 255, (h // 2, w // 2), np.uint8)
        single = codec.encode_jpeg({"y": y, "u": u, "v": v}, quality=90)
        ref = codec.decode_jpeg(single)
        multi = self._build_multiscan(y, u, v, w, h)
        got = codec.decode_jpeg(multi)
        assert got.width == ref.width and got.height == ref.height
        for a, b in zip(got.planes, ref.planes):
            assert np.array_equal(a, b)


class TestSubsampling:
    """4:2:2 / 4:4:4 encode (framework extension; the reference
    encodes 4:2:0 only — jpegencoderhelper.cpp:120-136). Sampling is
    inferred from the chroma plane geometry."""

    def _planes(self, h, w, hs, vs, seed=21):
        y = smooth_plane(h, w, seed=seed)
        ch, cw = -(-h // vs), -(-w // hs)
        u = smooth_plane(ch, cw, seed=seed + 1, lo=96, hi=160)
        v = smooth_plane(ch, cw, seed=seed + 2, lo=96, hi=160)
        return y, u, v

    @pytest.mark.parametrize("hs,vs", [(2, 1), (1, 1)])
    def test_roundtrip(self, hs, vs):
        h, w = 40, 56
        y, u, v = self._planes(h, w, hs, vs)
        blob = codec.encode_jpeg({"y": y, "u": u, "v": v}, quality=95)
        dec = codec.decode_jpeg(blob)
        assert (dec.width, dec.height) == (w, h)
        assert dec.sampling[0] == (hs, vs)
        assert dec.sampling[1] == (1, 1) and dec.sampling[2] == (1, 1)
        assert psnr(dec.planes[0], y) > 38
        assert psnr(dec.planes[1], u) > 38
        assert psnr(dec.planes[2], v) > 38

    @pytest.mark.parametrize("hs,vs", [(2, 1), (1, 1)])
    def test_odd_dims(self, hs, vs):
        h, w = 33, 47
        y, u, v = self._planes(h, w, hs, vs, seed=31)
        blob = codec.encode_jpeg({"y": y, "u": u, "v": v}, quality=95)
        dec = codec.decode_jpeg(blob)
        assert (dec.width, dec.height) == (w, h)
        assert psnr(dec.planes[0], y) > 38

    @pytest.mark.parametrize("hs,vs", [(2, 2), (2, 1), (1, 1)])
    def test_pil_cross_decode(self, hs, vs):
        Image = pytest.importorskip("PIL.Image")
        h, w = 48, 64
        y, u, v = self._planes(h, w, hs, vs, seed=41)
        blob = codec.encode_jpeg({"y": y, "u": u, "v": v}, quality=95)
        img = Image.open(io.BytesIO(blob))
        got = np.asarray(img.convert("YCbCr"))
        assert got.shape == (h, w, 3)
        assert psnr(got[:, :, 0], y) > 38

    def test_floor_half_chroma_accepted(self):
        """RawImage-style odd-dim planes carry floor-half chroma
        (types.py _PLANE_GEOM); the encoder must treat them as 4:2:0
        and edge-pad the missing row/column, not reject them."""
        h, w = 45, 31
        y = smooth_plane(h, w, seed=51)
        u = smooth_plane(h // 2, w // 2, seed=52, lo=96, hi=160)
        v = smooth_plane(h // 2, w // 2, seed=53, lo=96, hi=160)
        blob = codec.encode_jpeg({"y": y, "u": u, "v": v}, quality=92)
        dec = codec.decode_jpeg(blob)
        assert (dec.width, dec.height) == (w, h)
        assert dec.sampling[0] == (2, 2)
        assert psnr(dec.planes[0], y) > 38

    def test_explicit_sampling_validated(self):
        from libultrahdr_dev.types import UhdrError
        y = smooth_plane(32, 32)
        u_full = smooth_plane(32, 32, seed=1)
        # full-size chroma + a request for 4:2:0 must raise UhdrError,
        # not leak a numpy error from negative padding
        with pytest.raises(UhdrError):
            codec.encode_jpeg({"y": y, "u": u_full, "v": u_full},
                              quality=90, sampling=(2, 2))
        # JPEG-illegal factor combos are rejected
        with pytest.raises(UhdrError):
            codec.encode_jpeg({"y": y, "u": u_full, "v": u_full},
                              quality=90, sampling=(4, 1))

    def test_bad_chroma_geometry_rejected(self):
        from libultrahdr_dev.types import UhdrError
        y = smooth_plane(32, 32)
        u = smooth_plane(32, 16)  # 4:2:2 u ...
        v = smooth_plane(16, 16)  # ... mismatched with 4:2:0 v
        with pytest.raises(UhdrError):
            codec.encode_jpeg({"y": y, "u": u, "v": v}, quality=90)
        # vertical-only subsampling (1,2) is not a JPEG-legal layout here
        u2 = smooth_plane(16, 32)
        with pytest.raises(UhdrError):
            codec.encode_jpeg({"y": y, "u": u2, "v": u2}, quality=90)


def test_progressive_fill_bytes_between_segments():
    """T.81 B.1.1.2 allows 0xFF fill bytes before any marker; the
    progressive scan walk must skip them like the baseline scanner."""
    Image = pytest.importorskip("PIL.Image")
    y = smooth_plane(48, 64, seed=77)
    buf = io.BytesIO()
    Image.fromarray(y).save(buf, "JPEG", progressive=True, quality=90)
    blob = buf.getvalue()
    ref = codec.decode_jpeg(blob)
    # insert a fill byte before the first DHT that follows the first SOS
    sos = blob.find(b"\xff\xda")
    dht = blob.find(b"\xff\xc4", sos)
    assert dht > 0
    padded = blob[:dht] + b"\xff" + blob[dht:]
    got = codec.decode_jpeg(padded)
    assert np.array_equal(got.planes[0], ref.planes[0])


class TestThreadedProgressiveScans:
    """Cross-scan threading of the progressive decode
    (codec._run_prog_tasks_threaded): scans on disjoint (component,
    band) state run concurrently; the result must be bitwise identical
    to the serial scan-by-scan decode at any worker count."""

    @pytest.mark.parametrize("workers", [2, 4])
    def test_threaded_equals_serial(self, workers, monkeypatch):
        Image = pytest.importorskip("PIL.Image")
        rgb = np.dstack([smooth_plane(96, 128, seed=s)
                         for s in (11, 12, 13)])
        buf = io.BytesIO()
        Image.fromarray(rgb).save(buf, "JPEG", quality=92,
                                  progressive=True)
        blob = buf.getvalue()
        monkeypatch.setenv("UHDR_SCAN_THREADS", "1")
        serial = codec.decode_jpeg(blob)
        monkeypatch.setenv("UHDR_SCAN_THREADS", str(workers))
        threaded = codec.decode_jpeg(blob)
        assert serial.sampling == threaded.sampling
        for a, b in zip(serial.planes, threaded.planes):
            np.testing.assert_array_equal(a, b)

    def test_threaded_with_restarts_and_redefined_tables(self,
                                                         monkeypatch):
        # Restart markers + per-scan DHT redefinitions: the snapshot
        # semantics must hold under threading.
        Image = pytest.importorskip("PIL.Image")
        rgb = np.dstack([smooth_plane(64, 64, seed=s)
                         for s in (14, 15, 16)])
        buf = io.BytesIO()
        Image.fromarray(rgb).save(buf, "JPEG", quality=88,
                                  progressive=True,
                                  restart_marker_blocks=2)
        blob = buf.getvalue()
        monkeypatch.setenv("UHDR_SCAN_THREADS", "1")
        serial = codec.decode_jpeg(blob)
        monkeypatch.setenv("UHDR_SCAN_THREADS", "4")
        threaded = codec.decode_jpeg(blob)
        for a, b in zip(serial.planes, threaded.planes):
            np.testing.assert_array_equal(a, b)

    def test_threaded_truncated_scan_still_raises(self, monkeypatch):
        Image = pytest.importorskip("PIL.Image")
        rgb = np.dstack([smooth_plane(64, 64, seed=s)
                         for s in (17, 18, 19)])
        buf = io.BytesIO()
        Image.fromarray(rgb).save(buf, "JPEG", quality=92,
                                  progressive=True)
        blob = bytearray(buf.getvalue())
        cut = len(blob) * 3 // 4
        bad = bytes(blob[:cut - 40] + blob[cut:])
        monkeypatch.setenv("UHDR_SCAN_THREADS", "4")
        with pytest.raises(Exception):
            codec.decode_jpeg(bad)
