"""Tests for gain-map generation / application / tonemap.

Includes a 'Recover'-style closed-form check: for uniform inputs the full
decode pixel pipeline must match a hand-computed value, mirroring the
reference test strategy for its decode path.
"""

import math

import numpy as np
import pytest

from libultrahdr_dev.ops import color, gainmap
from libultrahdr_dev.types import GainMapMetadata


def make_p010(h, w, y10=600, u10=512, v10=512):
    """Uniform narrow-range P010 planes from 10-bit code values."""
    y = np.full((h, w), y10 << 6, np.uint16)
    uv = np.zeros((h // 2, w), np.uint16)
    uv[:, 0::2] = u10 << 6
    uv[:, 1::2] = v10 << 6
    return y, uv


def make_yuv420(h, w, y=128, u=128, v=128):
    return (np.full((h, w), y, np.uint8),
            np.full((h // 2, w // 2), u, np.uint8),
            np.full((h // 2, w // 2), v, np.uint8))


class TestToneMap:
    def test_shift(self):
        y, uv = make_p010(8, 8, y10=700, u10=300, v10=800)
        y8, u8, v8 = gainmap.tonemap_p010(y, uv)
        assert np.asarray(y8).dtype == np.uint8
        assert int(np.asarray(y8)[0, 0]) == 700 >> 2
        assert int(np.asarray(u8)[0, 0]) == 300 >> 2
        assert int(np.asarray(v8)[0, 0]) == 800 >> 2
        assert np.asarray(u8).shape == (4, 4)

    def test_random_matches_numpy(self):
        rng = np.random.default_rng(0)
        y = rng.integers(0, 1 << 16, (16, 16)).astype(np.uint16)
        uv = rng.integers(0, 1 << 16, (8, 16)).astype(np.uint16)
        y8, u8, v8 = gainmap.tonemap_p010(y, uv)
        np.testing.assert_array_equal(np.asarray(y8), (y >> 8).astype(np.uint8))
        np.testing.assert_array_equal(np.asarray(u8),
                                      (uv[:, 0::2] >> 8).astype(np.uint8))


class TestGenerateGainMap:
    def test_shape_and_metadata_hlg(self):
        sdr = make_yuv420(16, 32)
        hdr = make_p010(16, 32)
        gmap, md = gainmap.generate_gainmap(
            *sdr, *hdr, sdr_gamut="bt709", hdr_gamut="bt2100", hdr_tf="hlg")
        assert np.asarray(gmap).shape == (4, 8)
        assert md.max_content_boost == pytest.approx(1000.0 / 203.0)
        assert md.min_content_boost == 1.0
        assert md.hdr_capacity_max == md.max_content_boost
        assert md.gamma == 1.0

    def test_metadata_pq(self):
        sdr = make_yuv420(8, 8)
        hdr = make_p010(8, 8)
        _, md = gainmap.generate_gainmap(
            *sdr, *hdr, sdr_gamut="bt709", hdr_gamut="bt2100", hdr_tf="pq")
        assert md.max_content_boost == pytest.approx(10000.0 / 203.0)

    def test_uniform_gray_closed_form(self):
        """Uniform mid-gray SDR + known HLG HDR -> analytic gain value."""
        y8_val, y10_val = 180, 700
        sdr = make_yuv420(16, 16, y=y8_val)
        hdr = make_p010(16, 16, y10=y10_val)
        gmap, md = gainmap.generate_gainmap(
            *sdr, *hdr, sdr_gamut="bt709", hdr_gamut="bt2100", hdr_tf="hlg")

        # Closed form (float64): neutral chroma -> r=g=b=y.
        sdr_lin = float(np.asarray(color.srgb_inv_oetf(
            np.float32(y8_val / 255.0))))
        sdr_nits = sdr_lin * 203.0
        hdr_sig = (y10_val - 64) / 876.0
        hdr_lin = float(np.asarray(color.hlg_inv_oetf(np.float32(hdr_sig))))
        # bt2100->bt709 on neutral is ~identity (rows sum to 1).
        hdr_rgb = color.apply_matrix3(
            color.BT2100_TO_BT709, (np.float32(hdr_lin),) * 3)
        hdr_nits = float(np.asarray(color.srgb_luminance(hdr_rgb))) * 1000.0

        gain = min(max(hdr_nits / sdr_nits, 1.0), md.max_content_boost)
        expect = int(math.log2(gain) / math.log2(md.max_content_boost) * 255)
        got = int(np.asarray(gmap)[1, 1])
        assert abs(got - expect) <= 1

    def test_sdr_brighter_clamps_to_zero(self):
        sdr = make_yuv420(16, 16, y=255)
        hdr = make_p010(16, 16, y10=64)  # black
        gmap, _ = gainmap.generate_gainmap(
            *sdr, *hdr, sdr_gamut="bt709", hdr_gamut="bt2100", hdr_tf="hlg")
        assert int(np.asarray(gmap).max()) == 0

    def test_lut_variant_close_to_analytic(self):
        rng = np.random.default_rng(7)
        h, w = 32, 32
        sdr = (rng.integers(0, 256, (h, w)).astype(np.uint8),
               rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8),
               rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8))
        y10 = rng.integers(64, 940, (h, w)).astype(np.uint16) << 6
        uv10 = rng.integers(64, 960, (h // 2, w)).astype(np.uint16) << 6
        g_an, _ = gainmap.generate_gainmap(
            *sdr, y10, uv10, sdr_gamut="bt709", hdr_gamut="bt2100",
            hdr_tf="hlg", use_luts=False)
        g_lut, _ = gainmap.generate_gainmap(
            *sdr, y10, uv10, sdr_gamut="bt709", hdr_gamut="bt2100",
            hdr_tf="hlg", use_luts=True)
        diff = np.abs(np.asarray(g_an).astype(int) - np.asarray(g_lut).astype(int))
        assert diff.max() <= 2


class TestIdwUpsample:
    def numpy_sample_map(self, gmap, scale, h, w):
        """Direct port of the sampleMap weight-table algorithm
        (gainmapmath.cpp:686-720) as a test oracle."""
        tables = {
            (1, 1): gainmap.idw_weights_numpy(scale, 1, 1),
            (0, 1): gainmap.idw_weights_numpy(scale, 0, 1),
            (1, 0): gainmap.idw_weights_numpy(scale, 1, 0),
            (0, 0): gainmap.idw_weights_numpy(scale, 0, 0),
        }
        mh, mw = gmap.shape
        m = gmap.astype(np.float64) / 255.0
        out = np.zeros((h, w))
        for y in range(h):
            for x in range(w):
                xl, yl = x // scale, y // scale
                xu, yu = min(xl + 1, mw - 1), min(yl + 1, mh - 1)
                xl, yl = min(xl, mw - 1), min(yl, mh - 1)
                inc_r = 0 if xl == xu else 1
                inc_b = 0 if yl == yu else 1
                wts = tables[(inc_r, inc_b)][y % scale, x % scale]
                out[y, x] = (m[yl, xl] * wts[0] + m[yu, xl] * wts[1] +
                             m[yl, xu] * wts[2] + m[yu, xu] * wts[3])
        return out

    @pytest.mark.parametrize("scale", [2, 4])
    def test_matches_table_oracle(self, scale):
        rng = np.random.default_rng(1)
        mh, mw = 5, 7
        gmap = rng.integers(0, 256, (mh, mw)).astype(np.uint8)
        h, w = mh * scale, mw * scale
        got = np.asarray(gainmap._idw_upsample(
            np.asarray(gmap, np.float32) / 255.0, scale, h, w))
        want = self.numpy_sample_map(gmap, scale, h, w)
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_exact_at_sample_points(self):
        gmap = np.arange(12, dtype=np.uint8).reshape(3, 4) * 20
        got = np.asarray(gainmap._idw_upsample(
            np.asarray(gmap, np.float32) / 255.0, 4, 12, 16))
        np.testing.assert_allclose(got[::4, ::4], gmap / 255.0, atol=1e-6)


class TestApplyGainMap:
    def make_meta(self, max_boost=8.0):
        return GainMapMetadata(
            max_content_boost=max_boost, min_content_boost=1.0,
            hdr_capacity_min=1.0, hdr_capacity_max=max_boost)

    def test_f16_closed_form(self):
        """Uniform base + uniform gain map -> closed-form HDR value."""
        h, w = 16, 16
        yv = 200
        y8, u8, v8 = make_yuv420(h, w, y=yv)
        gval = 128
        gmap = np.full((h // 4, w // 4), gval, np.uint8)
        md = self.make_meta(8.0)
        out = gainmap.apply_gainmap(y8, u8, v8, gmap, md, "hdr_linear",
                                    max_display_boost=8.0)
        out = np.asarray(out)
        assert out.shape == (h, w, 4) and out.dtype == np.uint16

        lin = float(np.asarray(color.srgb_inv_oetf(np.float32(yv / 255.0))))
        factor = 2.0 ** (math.log2(8.0) * (gval / 255.0))
        expect = lin * factor / 8.0  # divided by display boost
        r_half = out[8, 8, 0].view(np.float16)
        assert np.isclose(float(r_half), expect, rtol=1e-2)
        assert out[8, 8, 3].view(np.float16) == np.float16(1.0)

    def test_display_boost_weighting(self):
        h, w = 8, 8
        y8, u8, v8 = make_yuv420(h, w, y=200)
        gmap = np.full((2, 2), 255, np.uint8)
        md = self.make_meta(4.0)
        full = np.asarray(gainmap.apply_gainmap(
            y8, u8, v8, gmap, md, "hdr_linear", max_display_boost=4.0))
        half = np.asarray(gainmap.apply_gainmap(
            y8, u8, v8, gmap, md, "hdr_linear", max_display_boost=2.0))
        lin = float(np.asarray(color.srgb_inv_oetf(np.float32(200 / 255.0))))
        rf = full[4, 4, 0].view(np.float16)
        rh = half[4, 4, 0].view(np.float16)
        # full boost: lin * 4 / 4 = lin; display 2: lin * 4^(2/4) / 2 = lin.
        assert np.isclose(float(rf), lin, rtol=1e-2)
        assert np.isclose(float(rh), lin, rtol=1e-2)

    def test_pq_output_packs_1010102(self):
        h, w = 8, 8
        y8, u8, v8 = make_yuv420(h, w, y=128)
        gmap = np.full((2, 2), 0, np.uint8)
        md = self.make_meta(4.0)
        out = np.asarray(gainmap.apply_gainmap(
            y8, u8, v8, gmap, md, "hdr_pq", max_display_boost=4.0))
        assert out.dtype == np.uint32
        assert int(out[0, 0]) >> 30 == 3  # alpha

    def test_10bit_planar_output(self):
        h, w = 8, 8
        y8, u8, v8 = make_yuv420(h, w, y=128)
        gmap = np.full((2, 2), 0, np.uint8)
        md = self.make_meta(4.0)
        out = np.asarray(gainmap.apply_gainmap(
            y8, u8, v8, gmap, md, "hdr_linear_rgb_10bit",
            max_display_boost=4.0))
        assert out.shape == (3, h, w) and out.dtype == np.uint16
        assert out.max() <= 1023

    def test_metadata_validation(self):
        from libultrahdr_dev.types import UhdrError
        h, w = 8, 8
        y8, u8, v8 = make_yuv420(h, w)
        gmap = np.zeros((2, 2), np.uint8)
        bad = self.make_meta()
        bad.gamma = 2.2
        with pytest.raises(UhdrError):
            gainmap.apply_gainmap(y8, u8, v8, gmap, bad, "hdr_linear", 4.0)
        bad2 = self.make_meta()
        bad2.hdr_capacity_max = 3.0
        with pytest.raises(UhdrError):
            gainmap.apply_gainmap(y8, u8, v8, gmap, bad2, "hdr_linear", 4.0)

    def test_scale_mismatch_rejected(self):
        from libultrahdr_dev.types import UhdrError
        y8, u8, v8 = make_yuv420(8, 8)
        with pytest.raises(UhdrError):
            gainmap.apply_gainmap(y8, u8, v8, np.zeros((2, 3), np.uint8),
                                  self.make_meta(), "hdr_linear", 4.0)


class TestEncodeDecodeConsistency:
    def test_hlg_roundtrip_luminance(self):
        """Tone-mapped SDR + gain map must reconstruct HDR luminance."""
        rng = np.random.default_rng(5)
        h, w = 64, 64
        # Smooth-ish HDR content within narrow range.
        base = rng.integers(200, 800, (h // 8, w // 8))
        y10 = np.kron(base, np.ones((8, 8), int)).astype(np.uint16) << 6
        uv = np.full((h // 2, w), 512 << 6, np.uint16)  # neutral chroma

        y8, u8, v8 = (np.asarray(p) for p in gainmap.tonemap_p010(y10, uv))
        gmap, md = gainmap.generate_gainmap(
            y8, u8, v8, y10, uv, sdr_gamut="bt2100", hdr_gamut="bt2100",
            hdr_tf="hlg")
        out = np.asarray(gainmap.apply_gainmap(
            y8, u8, v8, np.asarray(gmap), md, "hdr_linear",
            max_display_boost=md.max_content_boost))

        # Compare reconstructed linear luminance (x display_boost x 203)
        # against the HDR source's analytic luminance, away from block
        # edges (IDW smoothing) — center pixels of each 8x8 block.
        r = out[..., 0].view(np.float16).astype(np.float64)
        g = out[..., 1].view(np.float16).astype(np.float64)
        b = out[..., 2].view(np.float16).astype(np.float64)
        recon_nits = (0.2126 * r + 0.7152 * g + 0.0722 * b) \
            * md.max_content_boost * 203.0

        hdr_sig = (np.asarray(y10 >> 6, np.float64) - 64) / 876.0
        hdr_lin = np.asarray(color.hlg_inv_oetf(hdr_sig.astype(np.float32)),
                             np.float64)
        want_nits = 0.2627 * hdr_lin + 0.6780 * hdr_lin + 0.0593 * hdr_lin
        want_nits *= 1000.0

        # Sample at gain-map texel corners interior to each 8x8 block
        # (x % 4 == 0 pixels reproduce the texel exactly under IDW).
        centers = (slice(4, None, 8), slice(4, None, 8))
        ratio = recon_nits[centers] / np.maximum(want_nits[centers], 1e-3)
        # 8-bit tonemap + 8-bit gain quantization: ~5% tolerance.
        assert np.median(np.abs(np.log2(ratio))) < 0.08
