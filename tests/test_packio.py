"""Lossless transfer pack (parallel/packio.py): exact roundtrips in
both directions, width bucketing, and the incompressible-content
fallbacks used by the bench/serving paths."""

import numpy as np
import pytest

from libultrahdr_dev.parallel import packio, sharding


def smooth_plane(h, w, seed=0):
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 1024, (h // 32 + 1, w // 32 + 1)).astype(
        np.float32)
    y = np.kron(small, np.ones((32, 32), np.float32))[:h, :w]
    return np.clip(y, 0, 1023).astype(np.uint16)


class TestPackPlane:
    @pytest.mark.parametrize("shape", [(64, 256), (96, 300),
                                       (320, 1024)])
    def test_host_pack_device_unpack_exact(self, shape):
        arr = smooth_plane(*shape)
        p = packio.pack_plane_host(arr)
        out = np.asarray(packio.unpack_plane_device(p))
        np.testing.assert_array_equal(out, arr)

    def test_noise_roundtrip_exact(self):
        rng = np.random.default_rng(3)
        arr = rng.integers(0, 1024, (64, 512)).astype(np.uint16)
        p = packio.pack_plane_host(arr)
        out = np.asarray(packio.unpack_plane_device(p))
        np.testing.assert_array_equal(out, arr)

    def test_smooth_compresses(self):
        arr = smooth_plane(320, 1024)
        p = packio.pack_plane_host(arr)
        assert p.nbytes() < arr.size * 10 / 8 / 2

    def test_device_pack_host_unpack_exact(self):
        import jax
        arr = smooth_plane(96, 512, seed=5)
        p = packio.pack_plane_device(jax.device_put(arr))
        np.testing.assert_array_equal(packio.unpack_plane_host(p), arr)

    def test_device_pack_max_bytes_bailout(self):
        import jax
        rng = np.random.default_rng(7)
        arr = rng.integers(0, 1024, (64, 512)).astype(np.uint16)
        assert packio.pack_plane_device(jax.device_put(arr),
                                        max_bytes=100) is None

    def test_bad_height_rejected(self):
        with pytest.raises(ValueError):
            packio.pack_plane_host(np.zeros((33, 256), np.uint16))


class TestTransferPaths:
    def _batch(self, n=2, h=128, w=256):
        ys = np.stack([smooth_plane(h, w, seed=i) << 6
                       for i in range(n)]).astype(np.uint16)
        uvs = np.stack([smooth_plane(h // 2, w, seed=10 + i) << 6
                        for i in range(n)]).astype(np.uint16)
        return ys, uvs

    def test_upload_batch_reconstruction(self):
        # Large enough that the pow2 bucket-padding floor (256
        # segments/bucket) doesn't mask the compression win.
        ys, uvs = self._batch(n=2, h=256, w=1024)
        stats = {}
        ydev, uvdev, nb = sharding.upload_p010_batch(ys, uvs, stats)
        assert stats["h2d_pack"] == "seg"
        np.testing.assert_array_equal(np.asarray(ydev), ys)
        np.testing.assert_array_equal(np.asarray(uvdev), uvs)

    def test_upload_batch_noise_falls_back_dense(self):
        rng = np.random.default_rng(0)
        ys = (rng.integers(0, 1024, (1, 128, 256)).astype(np.uint16)
              << 6)
        uvs = (rng.integers(0, 1024, (1, 64, 256)).astype(np.uint16)
               << 6)
        stats = {}
        ydev, uvdev, nb = sharding.upload_p010_batch(ys, uvs, stats)
        assert stats["h2d_pack"] == "dense"
        np.testing.assert_array_equal(np.asarray(ydev), ys)

    def test_device_input_encode_matches_host_path(self):
        import jax
        ys, uvs = self._batch(n=1, h=128, w=256)
        mesh = sharding.default_mesh(jax.devices()[:1])
        ydev, uvdev, _ = sharding.upload_p010_batch(ys, uvs)
        a = sharding.batched_encode_api0(ys, uvs, mesh,
                                         device_input=(ydev, uvdev))
        b = sharding.batched_encode_api0(ys, uvs, mesh)
        assert a == b

    def test_fetch_1010102_packed_matches_raw(self):
        import jax
        ys, uvs = self._batch(n=1, h=128, w=256)
        mesh = sharding.default_mesh(jax.devices()[:1])
        blobs = sharding.batched_encode_api0(ys, uvs, mesh)
        out = sharding.batched_decode(blobs, "hdr_hlg", 1000 / 203,
                                      mesh)
        stats = {}
        packed = sharding.fetch_1010102_packed(out, stats)
        np.testing.assert_array_equal(packed, np.asarray(out))
        assert stats["d2h_bytes"] > 0


class TestRctBatchFetch:
    """RCT + fine-width readback pack (packio.fetch_rgba1010102_batch):
    exact u32 reconstruction incl. the channel decorrelation inverse
    and the device-side sorted-bucket layout."""

    def _rgba(self, n, h, w, seed=0, noise=0):
        rng = np.random.default_rng(seed)
        r = smooth_plane(h, w, seed).astype(np.uint32)
        g = smooth_plane(h, w, seed + 1).astype(np.uint32)
        b = smooth_plane(h, w, seed + 2).astype(np.uint32)
        if noise:
            r = (r + rng.integers(0, noise, r.shape,
                                  dtype=np.uint32)) & 1023
            g = (g + rng.integers(0, noise, g.shape,
                                  dtype=np.uint32)) & 1023
            b = (b + rng.integers(0, noise, b.shape,
                                  dtype=np.uint32)) & 1023
        one = r | (g << 10) | (b << 20) | np.uint32(0xC0000000)
        return np.stack([np.roll(one, i, axis=0) for i in range(n)])

    @pytest.mark.parametrize("n,h,w,noise", [
        (1, 64, 256, 0),      # wide zero/low-width buckets
        (2, 160, 328, 7),     # non-multiple-of-64 width (edge pad)
        (1, 64, 64, 900),     # heavy deltas: top widths exercised
    ])
    def test_roundtrip_exact(self, n, h, w, noise):
        import jax
        rgba = self._rgba(n, h, w, seed=h + w, noise=noise)
        out, nbytes = packio.fetch_rgba1010102_batch(
            jax.device_put(rgba))
        if out is None:
            pytest.skip("content fell back to raw (allowed)")
        np.testing.assert_array_equal(out, rgba)
        assert nbytes > 0

    def test_wider_than_native_cap_uses_numpy_fallback(self):
        # w > 8192 exceeds the native unpackers' row-stripe cap; the
        # packed transfer must still be taken (link-bound regimes
        # prefer packed + numpy unpack over a raw full-size readback)
        # with the numpy host half producing exact output.
        import jax
        n, h, w = 1, 32, 8704
        rgba = self._rgba(n, h, w, seed=3)
        out, nbytes = packio.fetch_rgba1010102_batch(
            jax.device_put(rgba))
        assert out is not None, "wide frame must not bail to raw"
        np.testing.assert_array_equal(out, rgba)
        assert 0 < nbytes < rgba.nbytes // 2

    def test_correlated_channels_compress(self):
        import jax
        # channels = same plane +- small offsets: RCT should make the
        # difference channels nearly free.
        base = smooth_plane(256, 512, seed=3).astype(np.uint32)
        rgba = ((base & 1023) | (((base + 2) & 1023) << 10)
                | (((base + 5) & 1023) << 20) | np.uint32(0xC0000000))
        rgba = rgba[None]
        out, nbytes = packio.fetch_rgba1010102_batch(
            jax.device_put(rgba))
        np.testing.assert_array_equal(out, rgba)
        assert nbytes < 0.25 * rgba.nbytes

    def test_incompressible_returns_none(self):
        import jax
        rng = np.random.default_rng(0)
        rgba = rng.integers(0, 2**32, (1, 64, 256), np.uint64).astype(
            np.uint32) | np.uint32(0xC0000000)
        out, wasted = packio.fetch_rgba1010102_batch(
            jax.device_put(rgba))
        assert out is None
        # The pass-1 width map crossed the link before the bailout and
        # must be reported for byte accounting.
        assert wasted == 3 * 64 * 4  # rows * segments/row

    def test_native_and_numpy_unpack_agree(self, monkeypatch):
        import jax

        from libultrahdr_dev.jpeg import native
        if native.get_lib() is None:
            pytest.skip("native codec unavailable")
        rgba = self._rgba(2, 160, 328, seed=11, noise=5)
        res = packio.fetch_rgba1010102_batch(jax.device_put(rgba))
        assert res[0] is not None
        monkeypatch.setattr(native, "get_lib", lambda: None)
        res2 = packio.fetch_rgba1010102_batch(jax.device_put(rgba))
        np.testing.assert_array_equal(res[0], res2[0])
        assert res[1] == res2[1]
        np.testing.assert_array_equal(res[0], rgba)


class TestRiceBatchFetch:
    """RCT + Rice(k) readback pack (packio.fetch_rgba1010102_rice):
    exact u32 reconstruction through the unary-bitmap + remainder-slot
    layout, native/numpy host-unpack agreement, and the corrupt-map
    guards of the native decoder."""

    _rgba = TestRctBatchFetch._rgba

    @pytest.mark.parametrize("n,h,w,noise", [
        (1, 96, 512, 0),       # low-k segments + all-zero class
        (2, 160, 840, 7),      # non-multiple-of-256 width (edge pad)
        (1, 720, 1280, 3),     # h % 32 != 0 (reference fixture geom)
    ])
    def test_roundtrip_exact(self, n, h, w, noise):
        import jax
        rgba = self._rgba(n, h, w, seed=h + w, noise=noise)
        out, nbytes = packio.fetch_rgba1010102_rice(
            jax.device_put(rgba))
        if out is None:
            pytest.skip("content fell back (allowed)")
        np.testing.assert_array_equal(out, rgba)
        assert nbytes > 0

    def test_roundtrip_exact_high_k_mixed(self):
        # Pure heavy noise bails to raw (correctly — it's
        # incompressible), so high-k remainders and wide unary classes
        # are exercised with MIXED content: smooth half keeps the
        # estimate under the bail threshold, a full-range noisy half
        # populates k=8/9 and the upper word-count classes.
        import jax
        rng = np.random.default_rng(17)
        n, h, w = 1, 256, 1024
        base = np.linspace(0, 900, w)[None, None, :] * np.ones((n, h, 1))
        noisy = rng.integers(0, 1024, (n, h, w))
        v = np.where(np.arange(w)[None, None, :] < w // 2, base,
                     noisy).astype(np.int32) & 1023
        rgba = (v.astype(np.uint32)
                | ((v + 3 & 1023).astype(np.uint32) << 10)
                | ((v + 9 & 1023).astype(np.uint32) << 20)
                | np.uint32(0xC0000000))
        dev = jax.device_put(rgba)
        _, kuw = packio._rice_widths_fn((n, h, w))(dev)
        kmap = np.asarray(kuw)[0]
        assert (kmap >= 8)[kmap != packio._RICE_ZERO].any(), \
            "content failed to populate high-k buckets"
        out, nbytes = packio.fetch_rgba1010102_rice(dev)
        assert out is not None, "mixed content must not bail"
        np.testing.assert_array_equal(out, rgba)

    def test_incompressible_returns_none(self):
        import jax
        rng = np.random.default_rng(0)
        rgba = rng.integers(0, 2**32, (1, 64, 256), np.uint64).astype(
            np.uint32) | np.uint32(0xC0000000)
        out, wasted = packio.fetch_rgba1010102_rice(
            jax.device_put(rgba))
        assert out is None
        # The stacked (kcode, uw) map crossed the link first: 2 bytes
        # per segment.
        assert wasted == 3 * 64 * 1 * 2

    def test_native_and_numpy_unpack_agree(self, monkeypatch):
        import jax

        from libultrahdr_dev.jpeg import native
        lib = native.get_lib()
        if lib is None or getattr(lib, "uhdr_rice_unpack", None) is None:
            pytest.skip("native rice unpack unavailable")
        # Byte-count determinism needs both calls on the exact
        # two-phase path: a plan cached by an earlier same-shape test
        # would route one of them through the fused fetch (different,
        # content-dependent accounting).
        monkeypatch.setenv("UHDR_FUSED_FETCH", "0")
        packio._PLAN_CACHE.clear()
        rgba = self._rgba(2, 160, 840, seed=11, noise=5)
        res = packio.fetch_rgba1010102_rice(jax.device_put(rgba))
        assert res[0] is not None
        monkeypatch.setattr(native, "get_lib", lambda: None)
        res2 = packio.fetch_rgba1010102_rice(jax.device_put(rgba))
        np.testing.assert_array_equal(res[0], res2[0])
        assert res[1] == res2[1]
        np.testing.assert_array_equal(res[0], rgba)

    def test_native_rejects_corrupt_maps(self):
        """The per-segment maps cross an untrusted link; the native
        decoder must fail closed (nonzero rc) instead of reading out
        of bucket bounds."""
        import ctypes

        from libultrahdr_dev.jpeg import native
        lib = native.get_lib()
        if lib is None or getattr(lib, "uhdr_rice_unpack", None) is None:
            pytest.skip("native rice unpack unavailable")
        n, h, w = 1, 32, 256
        nseg = 3 * n * h
        blob = np.zeros(8192, np.uint32)
        rem_offs = np.zeros(10, np.int64)
        un_offs = np.zeros(7, np.int64)
        scratch = np.empty(n * h * w, np.uint16)
        out = np.empty(n * h * w, np.uint32)

        def call(kmap, uwmap):
            return lib.uhdr_rice_unpack(
                kmap.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                uwmap.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                blob.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                rem_offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                un_offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                n, h, w,
                scratch.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))

        kmap = np.full(nseg, 12, np.uint8)      # invalid k code
        assert call(kmap, np.zeros(nseg, np.uint8)) == -3
        kmap = np.zeros(nseg, np.uint8)          # k=0, uw > max class
        assert call(kmap, np.full(nseg, 25, np.uint8)) == -4
        # k=0, uw=8 but an all-zero bitmap: too few terminators.
        assert call(kmap, np.full(nseg, 8, np.uint8)) == -5
        # all-zero sentinel everywhere decodes to mid-gray-free zeros
        kmap = np.full(nseg, 15, np.uint8)
        assert call(kmap, np.zeros(nseg, np.uint8)) == 0
        assert np.all(out == ((0 << 10) | 0xC0000000))


class TestNativeForwardPack:
    """pack_plane_host's native path (uhdr_seg_widths/uhdr_seg_fill)
    must be bit-identical to the numpy path: same plan, buckets and
    perm (the device unpack is compiled against this exact layout)."""

    @pytest.mark.parametrize("kind", ["smooth", "noise", "mixed"])
    def test_native_matches_numpy(self, kind, monkeypatch):
        from libultrahdr_dev.jpeg import native
        if native.get_lib() is None:
            pytest.skip("native codec unavailable")
        h, w = 96, 520
        rng = np.random.default_rng(len(kind))
        if kind == "smooth":
            arr = smooth_plane(h, w, seed=2)
        elif kind == "noise":
            arr = rng.integers(0, 1024, (h, w)).astype(np.uint16)
        else:
            arr = (rng.integers(0, 4, (h, w)) * 300).astype(np.uint16)
        pn = packio.pack_plane_host(arr)
        monkeypatch.setattr(native, "get_lib", lambda: None)
        pp = packio.pack_plane_host(arr)
        assert pn.plan == pp.plan
        for bw in packio.WIDTHS:
            np.testing.assert_array_equal(np.asarray(pn.buckets[bw]),
                                          np.asarray(pp.buckets[bw]))
        np.testing.assert_array_equal(pn.perm, pp.perm)


class TestF16RiceFetch:
    """RCT + Rice over F16 bit patterns (packio.fetch_rgba_f16_rice):
    exact u16x4 reconstruction, native/numpy host-unpack agreement,
    the incompressible bail, and the sharding.fetch_f16_packed wiring
    (the reference's DEFAULT decode output is RGBA_F16,
    ultrahdr_api.cpp:1287-1289)."""

    @staticmethod
    def _f16(n, h, w, seed=0, noise=0.0):
        """Smooth positive linear-HDR-like content as RGBA halves."""
        rng = np.random.default_rng(seed)
        yy, xx = np.mgrid[0:h, 0:w]
        base = (0.3 + 0.2 * np.sin(xx / 37.0) + 0.1 * np.cos(yy / 23.0)
                )[None] * np.linspace(1.0, 3.0, n)[:, None, None]
        if noise:
            base = base + rng.normal(0, noise, (n, h, w))
        r = np.abs(base).astype(np.float16)
        g = np.abs(base * 0.9 + 0.02).astype(np.float16)
        b = np.abs(base * 1.1 - 0.01).astype(np.float16)
        out = np.empty((n, h, w, 4), np.uint16)
        out[..., 0] = r.view(np.uint16)
        out[..., 1] = g.view(np.uint16)
        out[..., 2] = b.view(np.uint16)
        out[..., 3] = 0x3C00
        return out

    @pytest.mark.parametrize("n,h,w,noise", [
        (1, 96, 512, 0.0),      # smooth: low-k + all-zero class
        (2, 160, 840, 0.003),   # non-multiple-of-256 width (edge pad)
        (1, 720, 1280, 0.001),  # h % 32 != 0 (the reference fixture
                                # geometry; groups cross plane bounds)
    ])
    def test_roundtrip_exact(self, n, h, w, noise):
        import jax
        rgba = self._f16(n, h, w, seed=h + w, noise=noise)
        out, nbytes = packio.fetch_rgba_f16_rice(jax.device_put(rgba))
        assert out is not None, "bench-like content must not bail"
        np.testing.assert_array_equal(out, rgba)
        assert 0 < nbytes < rgba.nbytes

    def test_roundtrip_exact_high_k_mixed(self):
        # Mixed content populates the high-k remainder buckets while
        # the smooth half keeps the estimate under the bail threshold.
        import jax
        rng = np.random.default_rng(23)
        n, h, w = 1, 256, 1024
        rgba = self._f16(n, h, w, seed=5)
        noisy = rng.integers(0, 0x7C00, (n, h, w // 2, 4)).astype(
            np.uint16)
        rgba[:, :, w // 2:, :3] = noisy[..., :3]
        rgba[..., 3] = 0x3C00
        dev = jax.device_put(rgba)
        _, kuw = packio._rice16_widths_fn((n, h, w))(dev)
        kmap = np.asarray(kuw)[0]
        assert (kmap[kmap != packio._RICE16_ZERO] >= 10).any(), \
            "content failed to populate high-k buckets"
        out, _ = packio.fetch_rgba_f16_rice(dev)
        assert out is not None, "mixed content must not bail"
        np.testing.assert_array_equal(out, rgba)

    def test_incompressible_returns_none(self):
        import jax
        rng = np.random.default_rng(0)
        rgba = rng.integers(0, 1 << 16, (1, 64, 256, 4)).astype(
            np.uint16)
        out, wasted = packio.fetch_rgba_f16_rice(jax.device_put(rgba))
        assert out is None
        assert wasted == 3 * 64 * 1 * 2  # the (kcode, uw) map

    def test_native_and_numpy_unpack_agree(self, monkeypatch):
        import jax

        from libultrahdr_dev.jpeg import native
        lib = native.get_lib()
        if lib is None or getattr(lib, "uhdr_rice16_unpack",
                                  None) is None:
            pytest.skip("native rice16 unpack unavailable")
        # Pin both calls to the two-phase path: the fused single-fetch
        # kicks in once a plan is cached and moves a different wire
        # byte count, which would break the res[1] == res2[1] check.
        monkeypatch.setenv("UHDR_FUSED_FETCH", "0")
        rgba = self._f16(2, 160, 840, seed=11, noise=0.004)
        res = packio.fetch_rgba_f16_rice(jax.device_put(rgba))
        assert res[0] is not None
        monkeypatch.setattr(native, "get_lib", lambda: None)
        res2 = packio.fetch_rgba_f16_rice(jax.device_put(rgba))
        np.testing.assert_array_equal(res[0], res2[0])
        assert res[1] == res2[1]
        np.testing.assert_array_equal(res[0], rgba)

    def test_native_rejects_corrupt_maps(self):
        import ctypes

        from libultrahdr_dev.jpeg import native
        lib = native.get_lib()
        if lib is None or getattr(lib, "uhdr_rice16_unpack",
                                  None) is None:
            pytest.skip("native rice16 unpack unavailable")
        n, h, w = 1, 32, 256
        nseg = 3 * n * h
        blob = np.zeros(16384, np.uint32)
        rem_offs = np.zeros(16, np.int64)
        un_offs = np.zeros(7, np.int64)
        scratch = np.empty(n * h * w, np.uint16)
        out = np.empty(n * h * w * 4, np.uint16)

        def call(kmap, uwmap):
            return lib.uhdr_rice16_unpack(
                kmap.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                uwmap.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                blob.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                rem_offs.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_int64)),
                un_offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                n, h, w,
                scratch.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_uint16)),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))

        kmap = np.full(nseg, 20, np.uint8)      # invalid k code
        assert call(kmap, np.zeros(nseg, np.uint8)) == -3
        kmap = np.zeros(nseg, np.uint8)          # k=0, uw > max class
        assert call(kmap, np.full(nseg, 25, np.uint8)) == -4
        assert call(kmap, np.full(nseg, 8, np.uint8)) == -5
        kmap = np.full(nseg, 31, np.uint8)       # all-zero sentinel
        assert call(kmap, np.zeros(nseg, np.uint8)) == 0
        o4 = out.reshape(n * h * w, 4)
        assert np.all(o4[:, :3] == 0) and np.all(o4[:, 3] == 0x3C00)

    def test_sharding_fetch_f16_packed_matches_raw(self):
        import jax

        from libultrahdr_dev.parallel import sharding
        rgba = self._f16(1, 96, 512, seed=3)
        dev = jax.device_put(rgba)
        stats = {}
        out = sharding.fetch_f16_packed(dev, stats)
        np.testing.assert_array_equal(out, rgba)
        assert stats["d2h_bytes"] > 0
        assert stats["d2h_pack"].startswith("rct-rice16-auto") \
            or stats["d2h_pack"] == "raw"


class TestMtUnpack:
    """Multi-threaded native unpack (uhdr_rice*_unpack_mt): bitwise
    identity with the serial walker at several thread counts (runs on
    any host — correctness is thread-count independent), plus a
    speedup smoke test that only runs on multi-core hosts."""

    _rgba = TestRctBatchFetch._rgba

    @staticmethod
    def _run_both(rgba, kind, nthreads):
        import ctypes

        import jax

        from libultrahdr_dev.jpeg import native
        lib = native.get_lib()
        mt = getattr(lib, f"uhdr_rice{kind}_unpack_mt", None) \
            if lib else None
        if mt is None:
            pytest.skip("native mt unpack unavailable")
        dev = jax.device_put(rgba)
        if kind == "":
            fetcher = packio.fetch_rgba1010102_rice
        else:
            fetcher = packio.fetch_rgba_f16_rice
        import os
        old = os.environ.get("UHDR_UNPACK_THREADS")
        old_fused = os.environ.get("UHDR_FUSED_FETCH")
        # Pin both calls to the two-phase path: the fused single-fetch
        # kicks in once a plan is cached and moves a different wire
        # byte count, which would break the b1 == b2 check.
        os.environ["UHDR_FUSED_FETCH"] = "0"
        packio._PLAN_CACHE.clear()
        try:
            os.environ["UHDR_UNPACK_THREADS"] = "1"
            serial, b1 = fetcher(dev)
            os.environ["UHDR_UNPACK_THREADS"] = str(nthreads)
            threaded, b2 = fetcher(dev)
        finally:
            if old is None:
                os.environ.pop("UHDR_UNPACK_THREADS", None)
            else:
                os.environ["UHDR_UNPACK_THREADS"] = old
            if old_fused is None:
                os.environ.pop("UHDR_FUSED_FETCH", None)
            else:
                os.environ["UHDR_FUSED_FETCH"] = old_fused
        assert serial is not None and threaded is not None
        assert b1 == b2
        return serial, threaded

    @pytest.mark.parametrize("nthreads", [2, 4])
    def test_rice1010102_mt_bitwise_equal(self, nthreads):
        rgba = self._rgba(2, 160, 840, seed=31, noise=6)
        serial, threaded = self._run_both(rgba, "", nthreads)
        np.testing.assert_array_equal(serial, threaded)
        np.testing.assert_array_equal(threaded, rgba)

    @pytest.mark.parametrize("nthreads", [2, 4])
    def test_rice16_mt_bitwise_equal(self, nthreads):
        rgba = TestF16RiceFetch._f16(2, 160, 840, seed=31, noise=0.004)
        serial, threaded = self._run_both(rgba, "16", nthreads)
        np.testing.assert_array_equal(serial, threaded)
        np.testing.assert_array_equal(threaded, rgba)

    @pytest.mark.parametrize("n,h", [(1, 88), (1, 720), (3, 40)])
    def test_mt_unaligned_plane_rows(self, n, h):
        # plane_rows % 32 != 0 (every common single-frame height:
        # 720/1080/2160): chunks warm up from the preceding GROUP
        # boundary, so the MT path still applies — and stays exact.
        rgba = TestF16RiceFetch._f16(n, h, 512, seed=7, noise=0.002)
        serial, threaded = self._run_both(rgba, "16", 4)
        np.testing.assert_array_equal(serial, threaded)
        np.testing.assert_array_equal(threaded, rgba)

    @pytest.mark.parametrize("n,h", [(1, 88), (1, 720)])
    def test_mt_unaligned_1010102(self, n, h):
        rgba = TestRctBatchFetch._rgba(TestRctBatchFetch(), n, h, 840,
                                       seed=9, noise=5)
        serial, threaded = self._run_both(rgba, "", 4)
        np.testing.assert_array_equal(serial, threaded)
        np.testing.assert_array_equal(threaded, rgba)

    def test_mt_speedup_on_multicore(self):
        import os
        import time

        if (os.cpu_count() or 1) < 2:
            pytest.skip("single-core host: no speedup to measure")
        import jax
        rgba = self._rgba(4, 1024, 2048, seed=3, noise=6)
        dev = jax.device_put(rgba)

        def timed(nt):
            os.environ["UHDR_UNPACK_THREADS"] = str(nt)
            try:
                best = float("inf")
                for _ in range(3):
                    t0 = time.perf_counter()
                    out, _ = packio.fetch_rgba1010102_rice(dev)
                    best = min(best, time.perf_counter() - t0)
                assert out is not None
                return best
            finally:
                os.environ.pop("UHDR_UNPACK_THREADS", None)

        t1, tn = timed(1), timed(min(os.cpu_count(), 4))
        # Conservative bound: the unpack is only part of the fetch.
        assert tn < t1 * 1.05, (t1, tn)


class TestFetchPixelsPacked:
    """sharding.fetch_pixels_packed: the dtype/shape-dispatching
    materializer single-frame consumers (CLI) use."""

    def test_u32_single_and_batch(self):
        import jax

        from libultrahdr_dev.parallel import sharding
        rgba = TestRctBatchFetch._rgba(
            TestRctBatchFetch(), 2, 96, 256, seed=1)
        dev = jax.device_put(rgba)
        np.testing.assert_array_equal(
            sharding.fetch_pixels_packed(dev, fmt="rgba1010102"), rgba)
        np.testing.assert_array_equal(
            sharding.fetch_pixels_packed(dev[0], fmt="rgba1010102"),
            rgba[0])

    def test_f16_single_and_batch(self):
        import jax

        from libultrahdr_dev.parallel import sharding
        from libultrahdr_dev.types import PixelFormat
        rgba = TestF16RiceFetch._f16(2, 96, 256, seed=2)
        dev = jax.device_put(rgba)
        np.testing.assert_array_equal(
            sharding.fetch_pixels_packed(dev, fmt="rgba_f16"), rgba)
        np.testing.assert_array_equal(
            sharding.fetch_pixels_packed(dev[0],
                                         fmt=PixelFormat.RGBA_F16),
            rgba[0])

    def test_sdr_u32_not_routed_through_1010102_pack(self):
        # SDR RGBA8888 is dtype/shape-identical to 1010102; without an
        # explicit packable fmt the fetch must stay raw (the packer
        # would re-attach alpha 0xC0000000 over SDR's 0xFF000000).
        import jax

        from libultrahdr_dev.parallel import sharding
        rng = np.random.default_rng(0)
        sdr = rng.integers(0, 1 << 24, (64, 128)).astype(np.uint32) \
            | np.uint32(0xFF000000)
        dev = jax.device_put(sdr)
        stats = {}
        out = sharding.fetch_pixels_packed(dev, stats, fmt="rgba8888")
        np.testing.assert_array_equal(out, sdr)
        assert stats["d2h_pack"] == "raw"

    def test_numpy_and_sdr_passthrough(self):
        import jax

        from libultrahdr_dev.parallel import sharding
        a = np.arange(24, dtype=np.uint8).reshape(2, 3, 4)
        stats = {}
        assert sharding.fetch_pixels_packed(a, stats) is a
        assert stats["d2h_pack"] == "host"   # nothing crossed the link
        dev = jax.device_put(a)
        stats = {}
        out = sharding.fetch_pixels_packed(dev, stats)
        np.testing.assert_array_equal(out, a)
        assert stats["d2h_pack"] == "raw"


class TestMedFetch:
    """RCT + MED/LOCO-I + Rice readback (packio.fetch_rgba1010102_med /
    fetch_rgba_f16_med): exact reconstruction through the sequential
    native predictor pass, native/numpy agreement, MT identity, and
    strictly fewer bytes than the vertical scheme on smooth content."""

    _rgba = TestRctBatchFetch._rgba
    _f16 = staticmethod(TestF16RiceFetch._f16)

    @pytest.fixture(autouse=True)
    def _two_phase_only(self, monkeypatch):
        # These tests predate the fused single-fetch path and compare
        # byte counts across repeated same-shape fetches; pin them to
        # the exact two-phase path (fused accounting is
        # content-dependent and differs call-to-call).
        monkeypatch.setenv("UHDR_FUSED_FETCH", "0")
        packio._PLAN_CACHE.clear()

    @pytest.mark.parametrize("n,h,w,noise", [
        (1, 96, 512, 0),
        (2, 160, 840, 7),      # edge pad + batch
        (1, 88, 512, 3),       # h % 32 != 0
    ])
    def test_roundtrip_exact_10bit(self, n, h, w, noise):
        import jax
        rgba = self._rgba(n, h, w, seed=h + w, noise=noise)
        out, nbytes = packio.fetch_rgba1010102_med(jax.device_put(rgba))
        assert out is not None
        np.testing.assert_array_equal(out, rgba)
        assert 0 < nbytes < rgba.nbytes

    @pytest.mark.parametrize("n,h,w,noise", [
        (1, 96, 512, 0.0),
        (2, 160, 840, 0.003),
    ])
    def test_roundtrip_exact_f16(self, n, h, w, noise):
        import jax
        rgba = self._f16(n, h, w, seed=h + w, noise=noise)
        out, nbytes = packio.fetch_rgba_f16_med(jax.device_put(rgba))
        assert out is not None
        np.testing.assert_array_equal(out, rgba)
        assert 0 < nbytes < rgba.nbytes

    def test_med_beats_vertical_on_smooth_content(self):
        import jax
        rgba = self._rgba(2, 160, 840, seed=5, noise=4)
        dev = jax.device_put(rgba)
        _, med_b = packio.fetch_rgba1010102_med(dev)
        _, rice_b = packio.fetch_rgba1010102_rice(dev)
        assert med_b <= rice_b

    def test_native_and_numpy_agree(self, monkeypatch):
        import jax

        from libultrahdr_dev.jpeg import native
        lib = native.get_lib()
        if lib is None or getattr(lib, "uhdr_med_unpack", None) is None:
            pytest.skip("native med unpack unavailable")
        rgba = self._rgba(1, 96, 512, seed=11, noise=5)
        res = packio.fetch_rgba1010102_med(jax.device_put(rgba))
        assert res[0] is not None
        monkeypatch.setattr(native, "get_lib", lambda: None)
        res2 = packio.fetch_rgba1010102_med(jax.device_put(rgba))
        np.testing.assert_array_equal(res[0], res2[0])
        assert res[1] == res2[1]
        np.testing.assert_array_equal(res[0], rgba)

    @pytest.mark.parametrize("kind,nthreads", [
        ("", 2), ("", 4), ("16", 4),
    ])
    def test_mt_bitwise_equal(self, kind, nthreads):
        if kind == "":
            rgba = self._rgba(1, 720, 840, seed=31, noise=6)
        else:
            rgba = self._f16(1, 720, 840, seed=31, noise=0.004)
        import jax

        from libultrahdr_dev.jpeg import native
        lib = native.get_lib()
        if lib is None or getattr(lib, f"uhdr_med{kind}_unpack_mt",
                                  None) is None:
            pytest.skip("native med mt unavailable")
        dev = jax.device_put(rgba)
        fetcher = (packio.fetch_rgba1010102_med if kind == ""
                   else packio.fetch_rgba_f16_med)
        import os
        try:
            os.environ["UHDR_UNPACK_THREADS"] = "1"
            serial, b1 = fetcher(dev)
            os.environ["UHDR_UNPACK_THREADS"] = str(nthreads)
            threaded, b2 = fetcher(dev)
        finally:
            os.environ.pop("UHDR_UNPACK_THREADS", None)
        assert b1 == b2
        np.testing.assert_array_equal(serial, threaded)
        np.testing.assert_array_equal(threaded, rgba)

    def test_incompressible_returns_none(self):
        import jax
        rng = np.random.default_rng(0)
        rgba = rng.integers(0, 2**32, (1, 64, 256), np.uint64).astype(
            np.uint32) | np.uint32(0xC0000000)
        out, wasted = packio.fetch_rgba1010102_med(
            jax.device_put(rgba))
        assert out is None
        assert wasted == 3 * 64 * 1 * 2

    def test_auto_picks_min_and_roundtrips(self, monkeypatch):
        # With no observed-throughput estimates, auto must match the
        # cheaper of the two schemes' byte counts and still
        # reconstruct exactly, for both variants.
        import jax

        monkeypatch.setattr(packio, "_BPS", {})
        monkeypatch.delenv("UHDR_READBACK_SCHEME", raising=False)
        for mk, auto, a, b in (
                (lambda: self._rgba(2, 160, 840, seed=9, noise=5),
                 packio.fetch_rgba1010102_auto,
                 packio.fetch_rgba1010102_med,
                 packio.fetch_rgba1010102_rice),
                (lambda: self._f16(2, 160, 840, seed=9, noise=0.003),
                 packio.fetch_rgba_f16_auto,
                 packio.fetch_rgba_f16_med,
                 packio.fetch_rgba_f16_rice)):
            rgba = mk()
            dev = jax.device_put(rgba)
            out, nb = auto(dev)
            np.testing.assert_array_equal(out, rgba)
            _, nb_med = a(dev)
            _, nb_rice = b(dev)
            # auto ships BOTH schemes' (kcode, uw) maps (2 extra
            # bytes/segment) to make the exact pick host-side.
            nseg = 3 * 2 * 160 * (-(-840 // 256))
            assert nb == min(nb_med, nb_rice) + 2 * nseg

    def test_native_med_rejects_corrupt_maps(self):
        """The MED walkers share the rice walker's fail-closed guards
        (bad k code / class overflow / truncated unary bitmap)."""
        import ctypes

        from libultrahdr_dev.jpeg import native
        lib = native.get_lib()
        if lib is None or getattr(lib, "uhdr_med_unpack", None) is None:
            pytest.skip("native med unpack unavailable")
        n, h, w = 1, 32, 256
        nseg = 3 * n * h
        blob = np.zeros(8192, np.uint32)
        rem_offs = np.zeros(10, np.int64)
        un_offs = np.zeros(7, np.int64)
        scratch = np.empty(n * h * w, np.uint16)
        out = np.empty(n * h * w, np.uint32)

        def call(kmap, uwmap):
            return lib.uhdr_med_unpack(
                kmap.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                uwmap.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                blob.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                rem_offs.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_int64)),
                un_offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                n, h, w,
                scratch.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_uint16)),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))

        assert call(np.full(nseg, 12, np.uint8),
                    np.zeros(nseg, np.uint8)) == -3
        kmap = np.zeros(nseg, np.uint8)
        assert call(kmap, np.full(nseg, 25, np.uint8)) == -4
        assert call(kmap, np.full(nseg, 8, np.uint8)) == -5
        # all-zero sentinel: residuals 0 -> MED propagates zeros.
        kmap = np.full(nseg, 15, np.uint8)
        assert call(kmap, np.zeros(nseg, np.uint8)) == 0
        assert np.all(out == ((0 << 10) | 0xC0000000))


class TestCostAwarePick:
    """The auto scheme pick weighs observed link speed against each
    scheme's observed host-unpack throughput (packio._auto_pick_scheme):
    MED's fewer wire bytes only win when the link is slow enough to pay
    for its strictly-sequential LOCO-I reconstruction."""

    _rgba = TestRctBatchFetch._rgba

    def test_pick_logic(self, monkeypatch):
        # Plans are opaque tuples to the picker except est == plan[-1].
        pv = (None, None, None, None, None, 20_000_000)
        pm = (None, None, None, None, None, 14_000_000)
        raw = 200_000_000

        monkeypatch.setattr(packio, "_BPS", {})
        # No estimates yet: bytes-only pick.
        assert packio._auto_pick_scheme(pv, pm, raw, "v", "m") is True
        # Single viable plan wins regardless.
        assert packio._auto_pick_scheme(pv, None, raw, "v", "m") is False
        assert packio._auto_pick_scheme(None, pm, raw, "v", "m") is True

        # Fast link + slow MED unpack: the 6 MB wire saving costs more
        # unpack time than it saves on the link -> vertical.
        monkeypatch.setattr(packio, "_BPS", {
            "d2h_link": 33e6, "v": 850e6, "m": 300e6})
        assert packio._auto_pick_scheme(pv, pm, raw, "v", "m") is False
        # Slow link: wire bytes dominate -> MED.
        monkeypatch.setattr(packio, "_BPS", {
            "d2h_link": 8e6, "v": 850e6, "m": 300e6})
        assert packio._auto_pick_scheme(pv, pm, raw, "v", "m") is True

    def test_env_force_and_last_pick(self, monkeypatch):
        import jax

        from libultrahdr_dev.jpeg import native
        lib = native.get_lib()
        if lib is None or getattr(lib, "uhdr_med_unpack", None) is None:
            pytest.skip("native med unpack unavailable")
        rgba = self._rgba(1, 96, 512, seed=13, noise=4)
        dev = jax.device_put(rgba)
        for scheme in ("vert", "med"):
            monkeypatch.setenv("UHDR_READBACK_SCHEME", scheme)
            out, _ = packio.fetch_rgba1010102_auto(dev)
            np.testing.assert_array_equal(out, rgba)
            assert packio.LAST_PICK == scheme

    def test_throughput_samples_recorded(self, monkeypatch):
        import jax

        from libultrahdr_dev.jpeg import native
        lib = native.get_lib()
        if lib is None or getattr(lib, "uhdr_rice_unpack", None) is None:
            pytest.skip("native unpack unavailable")
        monkeypatch.setattr(packio, "_BPS", {})
        monkeypatch.delenv("UHDR_READBACK_SCHEME", raising=False)
        rgba = self._rgba(1, 96, 512, seed=14, noise=4)
        out, _ = packio.fetch_rgba1010102_auto(jax.device_put(rgba))
        np.testing.assert_array_equal(out, rgba)
        assert packio._BPS.get("d2h_link", 0) > 0
        picked_fn = ("uhdr_med_unpack" if packio.LAST_PICK == "med"
                     else "uhdr_rice_unpack")
        assert packio._BPS.get(picked_fn, 0) > 0


class TestFusedFetch:
    """Fused single-fetch Rice readback: one dispatch + one d2h after
    the first batch of a shape seeds the plan cache; bit-identical to
    the two-phase path; exact replan on a plan-overflowing content
    shift."""

    @staticmethod
    def _smooth_1010102(n, h, w, seed=0, amp=1024):
        yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        base = ((yy * 2 + xx) // 3) % amp
        base = np.broadcast_to(base, (n, h, w)).astype(np.uint32)
        r = base & 1023
        g = (base * 3 // 4) & 1023
        b = (base // 2) & 1023
        return (r | (g << 10) | (b << 20)
                | np.uint32(0xC0000000)).astype(np.uint32)

    def _fresh_cache(self):
        packio._PLAN_CACHE.clear()

    @staticmethod
    def _seed_bps(monkeypatch):
        """Mark every scheme's unpack speed as observed so the fused
        gate's one-batch exploration (tested separately) stays out of
        the way of these determinism tests."""
        monkeypatch.setattr(packio, "_BPS", {
            "d2h_link": 30e6,
            "uhdr_rice_unpack": 500e6, "uhdr_med_unpack": 200e6,
            "uhdr_rice16_unpack": 500e6, "uhdr_med16_unpack": 200e6})

    def test_second_call_fuses_and_matches(self, monkeypatch):
        import jax.numpy as jnp
        self._fresh_cache()
        self._seed_bps(monkeypatch)
        x = self._smooth_1010102(2, 256, 512)
        xd = jnp.asarray(x)
        o1, b1 = packio.fetch_rgba1010102_auto(xd)
        s1 = dict(packio.LAST_FETCH_STAGES)
        o2, b2 = packio.fetch_rgba1010102_auto(xd)
        s2 = dict(packio.LAST_FETCH_STAGES)
        assert s1.get("mode") != "fused" and s1["roundtrips"] == 2
        assert s2.get("mode") == "fused" and s2["roundtrips"] == 1
        np.testing.assert_array_equal(o1, x)
        np.testing.assert_array_equal(o2, x)
        assert b2 <= b1 * 1.1  # fused tail ~= the two-phase map

    def test_exploration_measures_both_schemes(self, monkeypatch):
        """Cold start with no unpack-speed observations: batch 1 picks
        by planned bytes (two-phase), batch 2 must EXPLORE the other
        scheme (two-phase again) instead of pinning batch 1's pick,
        and batch 3 fuses with the cost model fed by both
        measurements. Exploration is what keeps a cold-start
        bytes-only MED pick from costing 6.5 s/batch of host unpack
        at production sizes (round-4 on-chip probe)."""
        import jax.numpy as jnp

        from libultrahdr_dev.jpeg import native
        lib = native.get_lib()
        if lib is None or getattr(lib, "uhdr_med_unpack", None) is None:
            pytest.skip("native med unpack unavailable (no auto mode)")
        self._fresh_cache()
        monkeypatch.setattr(packio, "_BPS", {})
        monkeypatch.delenv("UHDR_READBACK_SCHEME", raising=False)
        x = self._smooth_1010102(2, 256, 512)
        xd = jnp.asarray(x)
        o1, _ = packio.fetch_rgba1010102_auto(xd)
        first = packio.LAST_PICK
        assert packio.LAST_FETCH_STAGES.get("mode") != "fused"
        o2, _ = packio.fetch_rgba1010102_auto(xd)
        second = packio.LAST_PICK
        assert packio.LAST_FETCH_STAGES.get("mode") != "fused"
        assert second != first, "batch 2 must explore the other scheme"
        assert packio._BPS.get("uhdr_rice_unpack", 0) > 0
        assert packio._BPS.get("uhdr_med_unpack", 0) > 0
        o3, _ = packio.fetch_rgba1010102_auto(xd)
        assert packio.LAST_FETCH_STAGES.get("mode") == "fused"
        for o in (o1, o2, o3):
            np.testing.assert_array_equal(o, x)

    def test_fused_respects_env_off(self, monkeypatch):
        import jax.numpy as jnp
        self._fresh_cache()
        self._seed_bps(monkeypatch)
        x = self._smooth_1010102(1, 256, 512, seed=1)
        xd = jnp.asarray(x)
        packio.fetch_rgba1010102_auto(xd)
        monkeypatch.setenv("UHDR_FUSED_FETCH", "0")
        o, _ = packio.fetch_rgba1010102_auto(xd)
        assert packio.LAST_FETCH_STAGES.get("mode") != "fused"
        np.testing.assert_array_equal(o, x)

    def test_replan_on_content_shift(self, monkeypatch):
        """Shift content so at least one bucket overflows the cached
        paddings while staying compressible: the fused fetch must
        detect the miss (fit=0), repack exactly, and still return
        bit-identical pixels."""
        import copy

        import jax.numpy as jnp
        self._fresh_cache()
        self._seed_bps(monkeypatch)
        smooth = self._smooth_1010102(2, 256, 512, amp=8)  # tiny deltas
        packio.fetch_rgba1010102_auto(jnp.asarray(smooth))
        ent = packio._PLAN_CACHE.get(((2, 256, 512), 10))
        assert ent is not None
        plans_before = copy.deepcopy(ent["plans"])
        # Rougher (but still compressible) content: larger deltas push
        # segments into higher-k buckets the tiny-delta plan did not
        # provision.
        rough = self._smooth_1010102(2, 256, 512, amp=1024)
        rng = np.random.default_rng(7)
        rough = (rough ^ rng.integers(0, 15, rough.shape).astype(
            np.uint32)).astype(np.uint32) | np.uint32(0xC0000000)
        o, _ = packio.fetch_rgba1010102_auto(jnp.asarray(rough))
        s = dict(packio.LAST_FETCH_STAGES)
        if o is None:
            pytest.skip("content fell back to raw; replan not reached")
        np.testing.assert_array_equal(o, rough)
        # Either the plan fit (possible: pow2 padding headroom) or the
        # replan path ran; both must reconstruct exactly. When the
        # replan ran, the picked scheme's cached plan must have been
        # widened (or dropped as incompressible).
        if s.get("replan"):
            sel = packio.LAST_PICK == "med"
            ent2 = packio._PLAN_CACHE.get(((2, 256, 512), 10))
            pl2 = ent2["plans"].get(sel) if ent2 else None
            pl1 = plans_before.get(sel)
            assert pl2 is None or pl1 is None or all(
                a >= b for a, b in zip(pl2["rem_npads"],
                                       pl1["rem_npads"]))
        # Steady state on the new content: fused again, still exact.
        o2, _ = packio.fetch_rgba1010102_auto(jnp.asarray(rough))
        if packio._PLAN_CACHE.get(((2, 256, 512), 10)) is not None:
            assert packio.LAST_FETCH_STAGES.get("mode") == "fused"
        np.testing.assert_array_equal(o2, rough)

    def test_f16_fused_roundtrip(self, monkeypatch):
        import jax.numpy as jnp
        self._fresh_cache()
        self._seed_bps(monkeypatch)
        n, h, w = 1, 256, 512
        yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        base = (((yy + xx) // 2) % 1024).astype(np.uint32)
        xf = np.zeros((n, h, w, 4), np.uint16)
        xf[..., 0] = (base * 13 % 30000).astype(np.uint16)
        xf[..., 1] = (base * 11 % 30000).astype(np.uint16)
        xf[..., 2] = (base * 7 % 30000).astype(np.uint16)
        xf[..., 3] = 0x3C00
        fd = jnp.asarray(xf)
        f1, _ = packio.fetch_rgba_f16_auto(fd)
        f2, _ = packio.fetch_rgba_f16_auto(fd)
        assert packio.LAST_FETCH_STAGES.get("mode") == "fused"
        np.testing.assert_array_equal(f1, xf)
        np.testing.assert_array_equal(f2, xf)
