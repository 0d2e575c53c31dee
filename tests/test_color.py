"""Golden tests for libultrahdr_dev.ops.color.

Expected values are computed from the published standards' analytic
forms (IEC 61966-2-1, ITU-R BT.2100-2, SMPTE EG 432-1) in float64
numpy, independent of the implementation under test; coverage mirrors
the reference's gainmapmath unit suite.
"""

import math

import numpy as np
import pytest

from libultrahdr_dev.ops import color


def arr(*vals):
    return np.asarray(vals, np.float32)


class TestLuminance:
    def test_srgb_luminance_weights(self):
        assert np.isclose(color.srgb_luminance((1.0, 0.0, 0.0)), 0.2126)
        assert np.isclose(color.srgb_luminance((0.0, 1.0, 0.0)), 0.7152)
        assert np.isclose(color.srgb_luminance((0.0, 0.0, 1.0)), 0.0722)
        assert np.isclose(color.srgb_luminance((1.0, 1.0, 1.0)), 1.0)

    def test_p3_luminance_weights(self):
        assert np.isclose(color.p3_luminance((1.0, 0.0, 0.0)), 0.20949)
        assert np.isclose(color.p3_luminance((0.0, 1.0, 0.0)), 0.72160)
        assert np.isclose(color.p3_luminance((0.0, 0.0, 1.0)), 0.06891)

    def test_bt2100_luminance_weights(self):
        assert np.isclose(color.bt2100_luminance((1.0, 0.0, 0.0)), 0.2627)
        assert np.isclose(color.bt2100_luminance((0.0, 1.0, 0.0)), 0.6780)
        assert np.isclose(color.bt2100_luminance((0.0, 0.0, 1.0)), 0.0593)

    def test_vectorized(self):
        r = np.linspace(0, 1, 7, dtype=np.float32)
        lum = np.asarray(color.srgb_luminance((r, r, r)))
        np.testing.assert_allclose(lum, r, rtol=1e-6)


class TestYuvRgb:
    @pytest.mark.parametrize("to_yuv,from_yuv", [
        (color.srgb_rgb_to_yuv, color.srgb_yuv_to_rgb),
        (color.p3_rgb_to_yuv, color.p3_yuv_to_rgb),
        (color.bt2100_rgb_to_yuv, color.bt2100_yuv_to_rgb),
    ])
    def test_roundtrip(self, to_yuv, from_yuv):
        rng = np.random.default_rng(0)
        rgb = tuple(rng.random((5, 5), np.float32) for _ in range(3))
        back = from_yuv(to_yuv(rgb))
        for a, b in zip(rgb, back):
            np.testing.assert_allclose(np.asarray(b), a, atol=2e-5)

    def test_white_maps_to_y1(self):
        for fn in (color.srgb_rgb_to_yuv, color.p3_rgb_to_yuv,
                   color.bt2100_rgb_to_yuv):
            y, u, v = fn((1.0, 1.0, 1.0))
            assert np.isclose(y, 1.0, atol=1e-5)
            assert np.isclose(u, 0.0, atol=1e-5)
            assert np.isclose(v, 0.0, atol=1e-5)

    def test_bt709_red(self):
        # BT.709: Cr scale 1.5748, luma of red 0.2126.
        y, u, v = color.srgb_rgb_to_yuv((1.0, 0.0, 0.0))
        assert np.isclose(y, 0.2126, atol=1e-5)
        assert np.isclose(u, -0.2126 / 1.8556, atol=1e-5)
        assert np.isclose(v, (1 - 0.2126) / 1.5748, atol=1e-5)

    def test_yuv_to_rgb_clamps(self):
        r, g, b = color.srgb_yuv_to_rgb((arr(1.0), arr(0.5), arr(0.5)))
        assert float(r[0]) == 1.0 and float(b[0]) == 1.0
        r, g, b = color.srgb_yuv_to_rgb((arr(0.0), arr(-0.5), arr(-0.5)))
        assert float(r[0]) == 0.0 and float(b[0]) == 0.0


def srgb_inv_ref(x):
    x = np.asarray(x, np.float64)
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def hlg_oetf_ref(x):
    a, b, c = 0.17883277, 0.28466892, 0.55991073
    x = np.asarray(x, np.float64)
    return np.where(x <= 1 / 12, np.sqrt(3 * x),
                    a * np.log(np.maximum(12 * x - b, 1e-30)) + c)


def pq_oetf_ref(x):
    m1, m2 = 2610 / 16384, 2523 / 4096 * 128
    c1, c2, c3 = 3424 / 4096, 2413 / 4096 * 32, 2392 / 4096 * 32
    x = np.asarray(x, np.float64)
    xp = np.maximum(x, 0.0) ** m1
    return np.where(x <= 0, 0.0, ((c1 + c2 * xp) / (1 + c3 * xp)) ** m2)


class TestTransferFunctions:
    xs = np.linspace(0.0, 1.0, 257, dtype=np.float32)

    def test_srgb_inv_oetf(self):
        got = np.asarray(color.srgb_inv_oetf(self.xs))
        # float32 pow: ~3e-6 worst-case absolute error.
        np.testing.assert_allclose(got, srgb_inv_ref(self.xs), atol=1e-5)

    def test_srgb_oetf_inverts(self):
        lin = np.asarray(color.srgb_inv_oetf(self.xs))
        back = np.asarray(color.srgb_oetf(lin))
        np.testing.assert_allclose(back, self.xs, atol=1e-5)

    def test_hlg_oetf(self):
        got = np.asarray(color.hlg_oetf(self.xs))
        np.testing.assert_allclose(got, hlg_oetf_ref(self.xs), atol=5e-5)  # f32 log
        # Analytic anchor points: OETF(1/12) = 0.5, OETF(1) = 1.
        assert np.isclose(float(color.hlg_oetf(1 / 12)), 0.5, atol=1e-6)
        assert np.isclose(float(color.hlg_oetf(1.0)), 1.0, atol=1e-4)

    def test_hlg_roundtrip(self):
        back = np.asarray(color.hlg_inv_oetf(color.hlg_oetf(self.xs)))
        np.testing.assert_allclose(back, self.xs, atol=1e-4)

    def test_pq_oetf(self):
        got = np.asarray(color.pq_oetf(self.xs))
        np.testing.assert_allclose(got, pq_oetf_ref(self.xs), atol=1e-5)
        assert np.isclose(float(color.pq_oetf(1.0)), 1.0, atol=1e-5)
        # PQ(0.1) should be approx 0.7518 per BT.2100 (10000 nits peak,
        # 1000 nits -> signal ~0.751827).
        assert np.isclose(float(color.pq_oetf(0.1)), 0.751827, atol=1e-4)

    def test_pq_roundtrip(self):
        back = np.asarray(color.pq_inv_oetf(color.pq_oetf(self.xs)))
        np.testing.assert_allclose(back, self.xs, atol=2e-4)

    def test_pq_inv_crushes_small(self):
        assert float(color.pq_inv_oetf(0.0)) == 0.0
        assert float(color.pq_inv_oetf(0.00009)) == 0.0

    def test_luts_match_analytic(self):
        xs = np.linspace(0, 1, 101, dtype=np.float32)
        for lut, fn, tol in [
            (color.srgb_inv_oetf_lut, color.srgb_inv_oetf, 2e-3),
            (color.hlg_oetf_lut, color.hlg_oetf, 1e-4),
            (color.hlg_inv_oetf_lut, color.hlg_inv_oetf, 1e-3),
            (color.pq_oetf_lut, color.pq_oetf, 1e-4),
            (color.pq_inv_oetf_lut, color.pq_inv_oetf, 1e-3),
        ]:
            np.testing.assert_allclose(np.asarray(lut(xs)),
                                       np.asarray(fn(xs)), atol=tol)


class TestGamutConversions:
    def test_identity_through_roundtrip(self):
        rng = np.random.default_rng(1)
        rgb = tuple(rng.random(16, np.float32) for _ in range(3))
        via = color.apply_matrix3(color.BT709_TO_P3, rgb)
        back = color.apply_matrix3(color.P3_TO_BT709, via)
        for a, b in zip(rgb, back):
            np.testing.assert_allclose(np.asarray(b), a, atol=5e-3)

    def test_white_preserved(self):
        for m in (color.BT709_TO_P3, color.BT709_TO_BT2100,
                  color.P3_TO_BT2100):
            out = color.apply_matrix3(m, (1.0, 1.0, 1.0))
            for c in out:
                assert np.isclose(c, 1.0, atol=2e-4)

    def test_hdr_conversion_selector(self):
        assert color.hdr_gamut_conversion_matrix("bt709", "bt709") is None
        assert (color.hdr_gamut_conversion_matrix("bt709", "bt2100")
                is color.BT2100_TO_BT709)
        assert (color.hdr_gamut_conversion_matrix("p3", "bt2100")
                is color.BT2100_TO_P3)


class TestYuvEncodingConversions:
    def test_roundtrip_709_601(self):
        rng = np.random.default_rng(2)
        yuv = (rng.random(16, np.float32),
               rng.random(16, np.float32) - 0.5,
               rng.random(16, np.float32) - 0.5)
        via = color.apply_matrix3(color.YUV_709_TO_601, yuv)
        back = color.apply_matrix3(color.YUV_601_TO_709, via)
        for a, b in zip(yuv, back):
            np.testing.assert_allclose(np.asarray(b), a, atol=1e-3)

    def test_consistent_with_rgb_paths(self):
        # yuv709to601 should equal rgb709<-yuv709 then yuv601<-rgb.
        rng = np.random.default_rng(3)
        # Use small excursions to stay inside the unclamped range.
        y = rng.random(8, np.float32) * 0.5 + 0.25
        u = (rng.random(8, np.float32) - 0.5) * 0.05
        v = (rng.random(8, np.float32) - 0.5) * 0.05
        direct = color.apply_matrix3(color.YUV_709_TO_601, (y, u, v))
        chained = color.p3_rgb_to_yuv(color.srgb_yuv_to_rgb((y, u, v)))
        for a, b in zip(direct, chained):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       atol=1e-3)

    def test_selector(self):
        assert color.yuv_conversion_matrix("bt709", "bt709") is None
        assert color.yuv_conversion_matrix("p3", "p3") is None
        assert (color.yuv_conversion_matrix("bt709", "p3")
                is color.YUV_709_TO_601)
        assert (color.yuv_conversion_matrix("bt2100", "p3")
                is color.YUV_2100_TO_601)


class TestGain:
    def test_encode_gain_midpoints(self):
        # min=1, max=4: hdr/sdr of 2 is the midpoint of the log2 range.
        g = color.encode_gain(arr(100.0), arr(200.0), 1.0, 4.0)
        assert int(g[0]) == 127  # log2(2)/log2(4)*255 = 127.5 -> trunc 127
        assert int(color.encode_gain(arr(100.0), arr(100.0), 1.0, 4.0)[0]) == 0
        assert int(color.encode_gain(arr(100.0), arr(400.0), 1.0, 4.0)[0]) == 255

    def test_encode_gain_clamps(self):
        assert int(color.encode_gain(arr(100.0), arr(1e6), 1.0, 4.0)[0]) == 255
        assert int(color.encode_gain(arr(100.0), arr(1.0), 1.0, 4.0)[0]) == 0

    def test_encode_gain_zero_sdr(self):
        # sdr == 0 -> gain 1 -> bottom of range.
        assert int(color.encode_gain(arr(0.0), arr(500.0), 1.0, 4.0)[0]) == 0

    def test_gain_factor(self):
        f = color.gain_factor(arr(0.0), 1.0, 8.0)
        assert np.isclose(float(f[0]), 1.0)
        f = color.gain_factor(arr(1.0), 1.0, 8.0)
        assert np.isclose(float(f[0]), 8.0)
        f = color.gain_factor(arr(0.5), 1.0, 8.0)
        assert np.isclose(float(f[0]), math.sqrt(8.0), rtol=1e-5)

    def test_gain_factor_display_boost(self):
        # boost weighting: exponent scaled by display/max.
        f = color.gain_factor(arr(1.0), 1.0, 8.0, display_boost=2.0)
        assert np.isclose(float(f[0]), 2 ** (3 * 2 / 8), rtol=1e-5)

    def test_gain_factor_lut_matches(self):
        xs = np.linspace(0, 1, 33, dtype=np.float32)
        got = np.asarray(color.gain_factor_lut(xs, 1.0, 8.0, 4.0))
        want = np.asarray(color.gain_factor(xs, 1.0, 8.0, 4.0))
        np.testing.assert_allclose(got, want, rtol=2e-3)

    def test_encode_apply_roundtrip(self):
        # encode then apply recovers hdr/sdr ratio within quantization.
        sdr = np.float32(80.0)
        for ratio in [1.0, 1.7, 2.5, 4.9]:
            hdr = sdr * ratio
            g = color.encode_gain(arr(sdr), arr(hdr), 1.0, 8.0)
            rec = color.gain_factor(np.float32(int(g[0]) / 255.0), 1.0, 8.0)
            assert np.isclose(float(rec), ratio, rtol=2e-2)


class TestPacking:
    def test_rgba1010102(self):
        v = int(color.pack_rgba1010102((arr(1.0), arr(0.0), arr(1.0)))[0])
        assert v & 0x3FF == 1023
        assert (v >> 10) & 0x3FF == 0
        assert (v >> 20) & 0x3FF == 1023
        assert (v >> 30) == 3

    def test_rgba_f16(self):
        v = np.asarray(color.pack_rgba_f16((arr(1.0), arr(0.5), arr(0.25))))
        assert v.shape == (1, 4) and v.dtype == np.uint16
        h = lambda x: np.float16(x).view(np.uint16).item()
        assert v[0, 0] == h(1.0)
        assert v[0, 1] == h(0.5)
        assert v[0, 2] == h(0.25)
        assert v[0, 3] == h(1.0)
        # u16x4 little-endian view == the reference's packed u64.
        u64 = np.ascontiguousarray(v).view(np.uint64)[0, 0]
        assert u64 & 0xFFFF == h(1.0)
        assert (int(u64) >> 48) & 0xFFFF == h(1.0)
