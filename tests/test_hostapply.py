"""Host-apply decode path (parallel/sharding.decode_batch_hostapply +
jpeg/native/apply.cpp): the device emits the integer (Y, U|V, gain
map) composite, the link carries the Rice-packed planes, the host
reapplies the gain map natively. Parity target vs the device apply
kernel (ops/gainmap.py _apply_kernel): <= 1 ten-bit code for HLG/PQ,
<= 1 F16 ULP for hdr_linear, >= 99% bit-exact.

Reference role: the decode half of the in-process loop,
/root/reference/lib/src/ultrahdr.cpp:360-515."""

import ctypes
import os

import jax
import numpy as np
import pytest

from libultrahdr_dev.jpeg import native
from libultrahdr_dev.jpegr import JpegR
from libultrahdr_dev.ops import gainmap as gm
from libultrahdr_dev.parallel import packio, sharding
from libultrahdr_dev.types import (ColorGamut, ColorTransfer,
                                       PixelFormat, RawImage)

REF_DATA = "/root/reference/tests/data"
W, H = 1280, 720


def _lib():
    lib = native.get_lib()
    if lib is None or getattr(lib, "uhdr_apply_gainmap", None) is None:
        pytest.skip("native apply unavailable")
    return lib


def synth_planes(h, w, seed=0):
    """Smooth synthetic decode intermediates (JPEG-decoded content is
    block-smooth)."""
    rng = np.random.default_rng(seed)
    ch, cw = (h + 1) // 2, (w + 1) // 2
    gh, gw = h // 4, w // 4

    def plane(hh, ww, lo=0, hi=256):
        base = rng.integers(lo, hi, (hh // 8 + 1, ww // 8 + 1))
        big = np.kron(base, np.ones((8, 8), np.int64))[:hh, :ww]
        return np.clip(big + rng.integers(0, 5, (hh, ww)),
                       0, 255).astype(np.uint8)

    return plane(h, w), plane(ch, cw), plane(ch, cw), plane(gh, gw)


def run_native(y8, u8, v8, gmap, scalars, fmt, nthreads=1):
    lib = _lib()
    comp = np.asarray(gm.planes_composite(
        jax.device_put(y8), jax.device_put(u8), jax.device_put(v8),
        jax.device_put(gmap)))
    h, w = y8.shape
    gh, gw = gmap.shape
    return sharding.apply_planes_host(
        comp[None], np.asarray(scalars, np.float32)[None],
        h, w, gh, gw, fmt)[0]


def device_apply(y8, u8, v8, gmap, scalars, fmt):
    h, w = y8.shape
    scale = w // gmap.shape[1]
    k = gm._apply_kernel(fmt, scale, False)
    return np.asarray(k(y8, u8, v8, gmap, *[np.float32(s)
                                            for s in scalars]))


SCALARS = (0.0, 2.3045, 1.0, 4.9396)  # log2min log2max boost disp


class TestNativeApplyParity:
    @pytest.mark.parametrize("fmt,tol", [("hdr_hlg", 1), ("hdr_pq", 1)])
    def test_1010102_formats(self, fmt, tol):
        y8, u8, v8, gmap = synth_planes(144, 320, seed=1)
        got = run_native(y8, u8, v8, gmap, SCALARS, fmt)
        ref = device_apply(y8, u8, v8, gmap, SCALARS, fmt)
        worst, nbad = 0, 0
        for s in (0, 10, 20):
            d = np.abs(((got >> s) & 1023).astype(np.int64)
                       - ((ref >> s) & 1023).astype(np.int64))
            worst = max(worst, int(d.max()))
            nbad += int((d > 0).sum())
        assert worst <= tol, worst
        assert nbad < 0.01 * got.size * 3

    def test_f16_linear(self):
        y8, u8, v8, gmap = synth_planes(144, 320, seed=2)
        got = run_native(y8, u8, v8, gmap, SCALARS, "hdr_linear")
        ref = device_apply(y8, u8, v8, gmap, SCALARS, "hdr_linear")
        d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
        assert int(d.max()) <= 1, int(d.max())
        assert float((d == 0).mean()) > 0.99

    def test_partial_display_boost(self):
        # Interior boost exercises the boost_factor < 1 exponent path.
        sc = (0.0, 2.3045, 0.4342, 2.0)
        y8, u8, v8, gmap = synth_planes(80, 192, seed=3)
        got = run_native(y8, u8, v8, gmap, sc, "hdr_hlg")
        ref = device_apply(y8, u8, v8, gmap, sc, "hdr_hlg")
        for s in (0, 10, 20):
            d = np.abs(((got >> s) & 1023).astype(np.int64)
                       - ((ref >> s) & 1023).astype(np.int64))
            assert int(d.max()) <= 1

    def test_non_mult8_dimensions(self):
        # Dims off the 8/256 alignment grid (worst case the encoder
        # actually produces: even, gm exactly quarter-res) exercise
        # the segment-tail and map-edge weight bands.
        h, w = 76, 332
        rng = np.random.default_rng(4)
        y8 = rng.integers(0, 256, (h, w), dtype=np.uint8)
        ch, cw = h // 2, w // 2
        u8 = rng.integers(0, 256, (ch, cw), dtype=np.uint8)
        v8 = rng.integers(0, 256, (ch, cw), dtype=np.uint8)
        gmap = rng.integers(0, 256, (h // 4, w // 4), dtype=np.uint8)
        got = run_native(y8, u8, v8, gmap, SCALARS, "hdr_hlg")
        ref = device_apply(y8, u8, v8, gmap, SCALARS, "hdr_hlg")
        for s in (0, 10, 20):
            d = np.abs(((got >> s) & 1023).astype(np.int64)
                       - ((ref >> s) & 1023).astype(np.int64))
            assert int(d.max()) <= 1

    def test_mt_matches_serial(self):
        y8, u8, v8, gmap = synth_planes(160, 320, seed=5)
        a = run_native(y8, u8, v8, gmap, SCALARS, "hdr_hlg",
                       nthreads=1)
        lib = _lib()
        comp = np.asarray(gm.planes_composite(
            jax.device_put(y8), jax.device_put(u8),
            jax.device_put(v8), jax.device_put(gmap)))
        h, w = y8.shape
        out = np.empty((h, w), np.uint32)
        rc = lib.uhdr_apply_gainmap(
            comp.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            comp.shape[-1], h, w, (h + 1) // 2, (w + 1) // 2,
            gmap.shape[0], gmap.shape[1], w // gmap.shape[1],
            *[float(s) for s in SCALARS], 1,
            ctypes.c_void_p(out.ctypes.data), 4)
        assert rc == 0
        np.testing.assert_array_equal(a, out)

    def test_bad_args_rejected(self):
        lib = _lib()
        out = np.empty((8, 8), np.uint32)
        comp = np.zeros((20, 8), np.uint8)
        args = [comp.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                8, 8, 8, 4, 4, 2, 2, 4]
        assert lib.uhdr_apply_gainmap(
            *args, 0.0, 1.0, 1.0, 0.0, 1,     # display_boost 0
            ctypes.c_void_p(out.ctypes.data), 1) != 0
        assert lib.uhdr_apply_gainmap(
            *args, 0.0, 1.0, 1.0, 1.0, 7,     # bad mode
            ctypes.c_void_p(out.ctypes.data), 1) != 0


class TestPlanesComposite:
    def test_layout_and_padding(self):
        y8, u8, v8, gmap = synth_planes(144, 320, seed=6)
        comp = np.asarray(gm.planes_composite(
            jax.device_put(y8), jax.device_put(u8),
            jax.device_put(v8), jax.device_put(gmap)))
        h, w = y8.shape
        ch, cw = u8.shape
        gh, gw = gmap.shape
        assert comp.shape[0] % 3 == 0
        np.testing.assert_array_equal(comp[:h, :w], y8)
        np.testing.assert_array_equal(comp[h:h + ch, :cw], u8)
        np.testing.assert_array_equal(comp[h:h + ch, cw:2 * cw], v8)
        np.testing.assert_array_equal(
            comp[h + ch:h + ch + gh, :gw], gmap)


class TestDecodeBatchHostapply:
    @pytest.fixture(scope="class")
    def blob(self):
        path = os.path.join(REF_DATA, "raw_p010_image.p010")
        if not os.path.exists(path):
            pytest.skip("reference fixtures unavailable")
        p010 = np.fromfile(path, np.uint16)
        raw = RawImage(fmt=PixelFormat.P010, width=W, height=H,
                       gamut=ColorGamut.BT2100,
                       planes={"y": p010[:W * H].reshape(H, W),
                               "uv": p010[W * H:].reshape(H // 2, W)})
        return JpegR().encode_api0(raw, ColorTransfer.HLG, quality=95)

    @pytest.mark.parametrize("fmt,kind", [("hdr_hlg", "code"),
                                          ("hdr_linear", "ulp")])
    def test_end_to_end_vs_device_path(self, blob, fmt, kind):
        _lib()
        mesh = sharding.single_device_mesh()
        stats = {}
        got = sharding.decode_batch_hostapply([blob, blob], fmt,
                                              4.926114, mesh, stats)
        assert got is not None
        assert stats["d2h_pack"].startswith("planes-")
        # The packed composite must undercut even the packed-pixel
        # readback by a wide margin (that is the point of the path).
        assert stats["d2h_bytes"] < 2 * W * H  # < 2 B/px for 2 frames
        ref = np.asarray(sharding.batched_decode(
            [blob, blob], fmt, 4.926114, mesh))
        if kind == "ulp":
            d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
            assert int(d.max()) <= 1
            assert float((d == 0).mean()) > 0.99
        else:
            for s in (0, 10, 20):
                d = np.abs(((got >> s) & 1023).astype(np.int64)
                           - ((ref >> s) & 1023).astype(np.int64))
                assert int(d.max()) <= 1

    def test_unsupported_format_returns_none(self, blob):
        mesh = sharding.single_device_mesh()
        assert sharding.decode_batch_hostapply(
            [blob], "sdr", 4.9, mesh) is None
