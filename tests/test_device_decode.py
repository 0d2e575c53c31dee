"""Device-side RST entropy decode (jpeg/device_decode.py): bit-exact
parity with the host Huffman decoder on streams this framework encodes,
plus qualification/fallback behavior."""

import numpy as np
import pytest

import jax

from libultrahdr_dev.container import mux
from libultrahdr_dev.jpeg import codec, device_decode as dd
from libultrahdr_dev.jpegr import JpegR
from libultrahdr_dev.parallel import sharding
from libultrahdr_dev.types import OutputFormat


def _encode_one(H, W, seed=0):
    rng = np.random.default_rng(seed)
    y10 = rng.integers(64, 940, (H, W)).astype(np.uint16) << 6
    uv = rng.integers(64, 960, (H // 2, W)).astype(np.uint16) << 6
    mesh = sharding.default_mesh(jax.devices()[:1])
    return sharding.batched_encode_api0(y10[None], uv[None], mesh)[0]


@pytest.fixture(scope="module")
def blob():
    return _encode_one(144, 208)


def test_primary_planes_bit_exact(blob):
    primary, _ = mux.extract_primary_and_gainmap(blob)
    ref = codec.decode_jpeg(primary)
    ds, planes = dd.decode_jpeg_device(primary)
    assert not ds.gray
    for p, rp in zip(planes, ref.planes):
        a = np.asarray(p)[: rp.shape[0], : rp.shape[1]]
        assert np.array_equal(a, rp)


def test_gainmap_plane_bit_exact(blob):
    _, gmap = mux.extract_primary_and_gainmap(blob)
    ref = codec.decode_jpeg(gmap)
    ds, planes = dd.decode_jpeg_device(gmap)
    assert ds.gray
    a = np.asarray(planes[0])[: ref.planes[0].shape[0],
                              : ref.planes[0].shape[1]]
    assert np.array_equal(a, ref.planes[0])


@pytest.mark.parametrize("fmt", [OutputFormat.HDR_LINEAR,
                                 OutputFormat.HDR_HLG,
                                 OutputFormat.SDR])
def test_full_decode_matches_host_path(blob, fmt):
    jr = JpegR()
    res_dev = jr.decode(blob, fmt, max_display_boost=1000 / 203)
    orig = JpegR._decode_device_path
    try:
        JpegR._decode_device_path = lambda self, *a, **k: None
        res_host = jr.decode(blob, fmt, max_display_boost=1000 / 203)
    finally:
        JpegR._decode_device_path = orig
    a = np.asarray(res_dev.image.planes["rgba"])
    b = np.asarray(res_host.image.planes["rgba"])
    assert np.array_equal(a, b)
    assert res_dev.image.fmt == res_host.image.fmt
    if fmt != OutputFormat.SDR:
        assert np.array_equal(res_dev.gainmap, res_host.gainmap)


def test_foreign_stream_qualifies_via_scan():
    # No restart interval -> the host lengths-only scan synthesizes
    # segments (start_bits set) instead of falling back.
    gray = np.tile(np.arange(64, dtype=np.uint8), (64, 1))
    jpg = codec.encode_jpeg({"y": gray}, quality=85)
    ds = dd.parse_device_stream(jpg)
    if ds is None:
        pytest.skip("native scan unavailable")
    assert ds.start_bits is not None


class TestForeignDeviceDecode:
    """Restart-less (foreign) baseline JPEGs ride the device decoder
    via the native lengths-only scan: one lane per synthesized segment,
    start_bits mid-byte offsets, DC carry fixed up on device. Parity
    oracle is the host decoder (itself PIL/libjpeg cross-validated)."""

    @pytest.fixture(autouse=True)
    def _require_native(self):
        from libultrahdr_dev.jpeg import native
        if native.get_lib() is None:
            pytest.skip("native codec unavailable")

    def _foreign_jpeg(self, h, w, seed, gray=False, quality=88):
        import io

        from PIL import Image
        rng = np.random.default_rng(seed)
        img = rng.integers(0, 256,
                           (h, w) if gray else (h, w, 3), np.uint8)
        img = ((img.astype(np.float32)
                + np.roll(img, 1, 0) + np.roll(img, 2, 1)) / 3
               ).astype(np.uint8)
        b = io.BytesIO()
        Image.fromarray(img, "L" if gray else None).save(
            b, "JPEG", quality=quality)
        blob = b.getvalue()
        assert not any(bytes([0xFF, 0xD0 + i]) in blob
                       for i in range(8))
        return blob

    @pytest.mark.parametrize("h,w,gray", [
        (256, 384, False), (144, 208, False), (120, 200, True),
        (104, 88, False),   # odd MCU-count geometry
    ])
    def test_bit_exact_vs_host(self, h, w, gray):
        blob = self._foreign_jpeg(h, w, seed=h + w, gray=gray)
        res = dd.decode_jpeg_device(blob)
        assert res is not None
        ds, planes = res
        assert ds.start_bits is not None
        host = codec.decode_jpeg(blob)
        for p, hp in zip(planes, host.planes):
            a = np.asarray(p)[: hp.shape[0], : hp.shape[1]]
            assert np.array_equal(a, hp)

    def test_reference_fixture_jpegr_device_path(self):
        import os
        path = "/root/reference/tests/data/sample_jpegr.jpeg"
        if not os.path.exists(path):
            pytest.skip("reference fixture unavailable")
        blob = open(path, "rb").read()
        primary, gmap = mux.extract_primary_and_gainmap(blob)
        jr = JpegR()
        dev = jr._decode_device_path(primary, gmap,
                                     OutputFormat.HDR_HLG,
                                     float("inf"), False)
        assert dev is not None  # foreign streams take the device path
        orig = JpegR._decode_device_path
        try:
            JpegR._decode_device_path = lambda self, *a, **k: None
            host = jr.decode(blob, OutputFormat.HDR_HLG)
        finally:
            JpegR._decode_device_path = orig
        assert np.array_equal(np.asarray(dev.image.planes["rgba"]),
                              np.asarray(host.image.planes["rgba"]))

    @pytest.mark.parametrize("subsampling,samp", [
        (1, (2, 1)),   # 4:2:2
        (0, (1, 1)),   # 4:4:4
    ])
    def test_422_444_bit_exact_vs_host(self, subsampling, samp):
        # The wild's other two samplings ride the device decoder too
        # (the reference gets them from libjpeg; parse_device_stream
        # accepts [hs,vs]/1x1/1x1 and the kernel decodes the
        # [Y*ypm, U, V] interleave).
        import io

        from PIL import Image
        rng = np.random.default_rng(42)
        img = rng.integers(0, 256, (152, 216, 3), np.uint8)
        img = ((img.astype(np.float32) + np.roll(img, 1, 0)) / 2
               ).astype(np.uint8)
        b = io.BytesIO()
        Image.fromarray(img).save(b, "JPEG", quality=90,
                                  subsampling=subsampling)
        blob = b.getvalue()
        res = dd.decode_jpeg_device(blob)
        assert res is not None
        ds, planes = res
        assert ds.sampling == samp
        host = codec.decode_jpeg(blob)
        assert host.sampling[0] == samp
        for p, hp in zip(planes, host.planes):
            a = np.asarray(p)[: hp.shape[0], : hp.shape[1]]
            assert np.array_equal(a, hp)

    @pytest.mark.parametrize("shape,chroma_div", [
        ((128, 120), (1, 2)),   # 4:2:2: full-height chroma
        ((96, 136), (1, 1)),    # 4:4:4
    ])
    def test_422_444_rst_streams(self, shape, chroma_div):
        # Restart-marked 4:2:2/4:4:4 (our own encoder emits them; the
        # device path splits at RST markers, no scan needed).
        h, w = shape
        dv, dh = chroma_div
        rng = np.random.default_rng(h)
        planes = {
            "y": rng.integers(0, 256, (h, w), np.uint8),
            "u": rng.integers(0, 256, (h // dv, w // dh), np.uint8),
            "v": rng.integers(0, 256, (h // dv, w // dh), np.uint8),
        }
        blob = codec.encode_jpeg(planes, quality=85, restart_interval=7)
        res = dd.decode_jpeg_device(blob)
        assert res is not None
        ds, dplanes = res
        assert ds.start_bits is None  # real RST lanes, not synthesized
        host = codec.decode_jpeg(blob)
        for p, hp in zip(dplanes, host.planes):
            a = np.asarray(p)[: hp.shape[0], : hp.shape[1]]
            assert np.array_equal(a, hp)

    def test_decode_jpeg_prefers_device_when_large(self, monkeypatch):
        # codec.decode_jpeg routes big qualifying streams through the
        # device path; output must be identical to the host path.
        blob = self._foreign_jpeg(160, 240, seed=9)
        monkeypatch.setattr(codec, "_DEVICE_CODEC_ON_CPU", True)
        monkeypatch.setattr(codec, "_DEVICE_DECODE_MIN_PIXELS", 0)
        via_device = codec.decode_jpeg(blob)
        monkeypatch.setattr(codec, "_DEVICE_DECODE_MIN_PIXELS",
                            1 << 62)
        via_host = codec.decode_jpeg(blob)
        assert via_device.sampling == via_host.sampling
        for a, b in zip(via_device.planes, via_host.planes):
            assert np.array_equal(a, b)
        assert via_device.icc == via_host.icc
        assert via_device.exif == via_host.exif

    def test_corrupt_foreign_stream_falls_back(self):
        blob = bytearray(self._foreign_jpeg(128, 192, seed=3))
        # chop entropy bytes out of the middle: the scan over-consumes
        # and fails -> parse returns None -> host decoder raises.
        cut = len(blob) // 2
        bad = bytes(blob[:cut - 25] + blob[cut:])
        assert dd.parse_device_stream(bad) is None

    def test_batched_foreign_device_decode(self):
        # Foreign restart-less JPEG/R frames now ride the batched
        # device path too: per-frame start_bits stack into the third
        # kernel argument and each frame's DC carry is fixed up
        # independently. Parity oracle: the (host-validated)
        # single-frame decode of each blob.
        import jax as _jax

        from libultrahdr_dev.container import mux as _mux
        from libultrahdr_dev.types import GainMapMetadata
        mesh = sharding.default_mesh(_jax.devices()[:1])
        blobs = []
        for seed in (4, 5):
            base = self._foreign_jpeg(128, 192, seed=seed)
            gm = self._foreign_jpeg(32, 48, seed=seed + 10, gray=True)
            blobs.append(_mux.append_gainmap(base, gm,
                                             GainMapMetadata()))
        out = sharding._batched_decode_device(blobs, "hdr_hlg", 5.0,
                                              mesh, False)
        if out is None:
            pytest.skip("native scan unavailable")
        jr = JpegR()
        for i, b in enumerate(blobs):
            ref = jr.decode(b, OutputFormat.HDR_HLG,
                            max_display_boost=5.0)
            a = np.asarray(out[i])
            r = np.asarray(ref.image.planes["rgba"])
            # Same rounding tolerance as test_batched_decode_device_path
            # (vmapped vs single compilations may fuse floats
            # differently).
            for shift in (0, 10, 20):
                ca = (a >> shift) & 0x3FF
                cr = (r >> shift) & 0x3FF
                diff = np.abs(ca.astype(int) - cr.astype(int))
                assert diff.max() <= 1
                assert np.mean(diff != 0) < 1e-3


def test_batched_decode_device_path(blob):
    blobs = [blob, _encode_one(144, 208, seed=1)]
    mesh = sharding.default_mesh(jax.devices()[:1])
    out = sharding._batched_decode_device(blobs, "hdr_hlg", 1000 / 203,
                                          mesh, False)
    assert out is not None
    jr = JpegR()
    for i, b in enumerate(blobs):
        ref = jr.decode(b, OutputFormat.HDR_HLG,
                        max_display_boost=1000 / 203)
        a = np.asarray(out[i])
        r = np.asarray(ref.image.planes["rgba"])
        # The batched (vmapped) and single compilations may fuse float
        # ops differently; allow 1-code rounding flips on a handful of
        # pixels, matching test_parallel's batched-vs-serial tolerance.
        for shift in (0, 10, 20):
            ca = (a >> shift) & 0x3FF
            cr = (r >> shift) & 0x3FF
            diff = np.abs(ca.astype(int) - cr.astype(int))
            assert diff.max() <= 1
            assert np.mean(diff != 0) < 1e-3


def test_truncated_stream_terminates():
    # Corrupt/truncated entropy data must not hang the while_loop.
    blob = _encode_one(96, 160, seed=2)
    primary, _ = mux.extract_primary_and_gainmap(blob)
    cut = primary[: len(primary) * 2 // 3]
    ds = dd.parse_device_stream(cut + b"\xff\xd9")
    if ds is not None:
        kernel_in = dd.decode_jpeg_device(cut + b"\xff\xd9")
        # Any result (including garbage planes) is fine; must return.
        assert kernel_in is None or len(kernel_in) == 2


def test_foreign_optimized_tables_device_path():
    """Foreign JPEGs with restart markers and custom (optimized)
    Huffman tables decode on device bit-exactly — the select chains are
    built from the file's own DHT definitions."""
    import io
    pil = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(4)
    rgb = rng.integers(0, 255, (48, 64, 3), np.uint8)
    buf = io.BytesIO()
    pil.fromarray(rgb).save(buf, "JPEG", quality=90, subsampling=2,
                            optimize=True, restart_marker_blocks=4)
    data = buf.getvalue()
    ds = dd.parse_device_stream(data)
    assert ds is not None
    _, planes = dd.decode_jpeg_device(data)
    ref = codec.decode_jpeg(data)
    for p, rp in zip(planes, ref.planes):
        a = np.asarray(p)[: rp.shape[0], : rp.shape[1]]
        assert np.array_equal(a, rp)


class TestTableKeyEdgeCases:
    def test_serialize_256_value_dht_roundtrip(self):
        """A legal DHT may carry exactly 256 values (sum(bits)==256);
        the table key must survive it (2-byte counts)."""
        from libultrahdr_dev.jpeg.device_decode import (
            chains_from_key, serialize_tables)

        bits = [0] * 14 + [1, 255]
        vals = list(range(256))
        key = serialize_tables((bits, vals), (bits, vals))
        chains = chains_from_key(key)
        assert len(chains) == 4
        assert len(chains[0][0]) == 256

    def test_min_code_len_from_key(self):
        from libultrahdr_dev.jpeg.device_decode import (
            min_code_len_from_key, serialize_tables)

        assert min_code_len_from_key(None) == 2
        one_bit = ([1] + [0] * 15, [0])
        three_bit = ([0, 0, 2] + [0] * 13, [1, 2])
        key = serialize_tables(one_bit, three_bit)
        assert min_code_len_from_key(key) == 1
        key2 = serialize_tables(three_bit, three_bit)
        assert min_code_len_from_key(key2) == 3

    def test_degenerate_dht_rejected(self):
        """A scan referencing an all-zero DHT must fall back (return
        None), not crash at kernel construction."""
        import numpy as np
        from libultrahdr_dev.jpeg import codec, tables
        from libultrahdr_dev.jpeg.device_decode import (
            parse_device_stream)

        y = np.full((16, 16), 128, np.uint8)
        blob = codec.encode_jpeg({"y": y}, quality=90,
                                 restart_interval=1)
        # overwrite the DC DHT segment with an all-zero bits table
        i = blob.find(b"\xff\xc4")
        assert i > 0
        seg_len = int.from_bytes(blob[i + 2:i + 4], "big")
        zero_dht = (b"\xff\xc4" + (17 + 2).to_bytes(2, "big")
                    + b"\x00" + b"\x00" * 16)
        mutated = blob[:i] + zero_dht + blob[i + 2 + seg_len:]
        assert parse_device_stream(mutated) is None


@pytest.mark.parametrize("units", [1, 3, 4])
def test_units_per_step_parity(blob, units, monkeypatch):
    """The units-per-step latency knob (UHDR_DECODE_UNITS) must be
    purely a scheduling choice: every setting decodes bit-exactly.
    units=2 is the default exercised by every other test here."""
    monkeypatch.setattr(dd, "_DEFAULT_UNITS", units)
    dd._decode_to_planes_kernel.cache_clear()
    try:
        for data in mux.extract_primary_and_gainmap(blob):
            ref = codec.decode_jpeg(data)
            got = dd.decode_jpeg_device(data)
            assert got is not None
            _, planes = got
            for p, rp in zip(planes, ref.planes):
                a = np.asarray(p)[: rp.shape[0], : rp.shape[1]]
                assert np.array_equal(a, rp)
    finally:
        dd._decode_to_planes_kernel.cache_clear()


@pytest.mark.parametrize("units", [1, 3])
def test_units_per_step_parity_foreign_carry(units, monkeypatch):
    """Same knob on the foreign restart-less path (synthesized
    segments with dc_carry + start_bits)."""
    gray = np.tile(np.arange(96, dtype=np.uint8), (96, 1))
    jpg = codec.encode_jpeg({"y": gray}, quality=85)
    if dd.parse_device_stream(jpg) is None:
        pytest.skip("native scan unavailable")
    monkeypatch.setattr(dd, "_DEFAULT_UNITS", units)
    dd._decode_to_planes_kernel.cache_clear()
    try:
        ref = codec.decode_jpeg(jpg)
        ds, planes = dd.decode_jpeg_device(jpg)
        assert ds.start_bits is not None
        a = np.asarray(planes[0])[: ref.planes[0].shape[0],
                                  : ref.planes[0].shape[1]]
        assert np.array_equal(a, ref.planes[0])
    finally:
        dd._decode_to_planes_kernel.cache_clear()


class TestEmitModes:
    """Log-emission decode (decode_rst_chunks emit_mode="log":
    in-place (key, val) log + post-loop lower-bound reconstruction)
    must be bit-identical to the dense carried-buffer emission on
    every path — the two differ only in HBM traffic shape (the knob
    exists for on-chip tuning, microbench --decode-emit-sweep)."""

    def _both(self, ch, r, n_mcus, gray, units, **kw):
        a = dd.decode_rst_chunks(ch, r, n_mcus, gray,
                                 units_per_step=units,
                                 emit_mode="dense", **kw)
        b = dd.decode_rst_chunks(ch, r, n_mcus, gray,
                                 units_per_step=units,
                                 emit_mode="log", **kw)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    @pytest.mark.parametrize("units", [1, 2, 3])
    def test_color_and_gray_bit_exact(self, blob, units):
        from libultrahdr_dev.container import mux
        primary, gmap = mux.extract_primary_and_gainmap(blob)
        for data in (primary, gmap):
            ds = dd.parse_device_stream(data)
            ch = jax.numpy.asarray(ds.chunks)
            self._both(ch, ds.restart_interval,
                       ds.mcus_x * ds.mcus_y, ds.gray, units)

    def test_foreign_dc_carry_bit_exact(self):
        # Synthesized restart-less segments: start_bits mid-byte
        # offsets + cross-lane DC carry, the log path must reproduce
        # both exactly.
        import io

        from PIL import Image

        from libultrahdr_dev.jpeg import native
        if native.get_lib() is None:
            pytest.skip("native scan unavailable")
        rng = np.random.default_rng(5)
        img = rng.integers(0, 256, (144, 208, 3), np.uint8)
        img = ((img.astype(np.float32) + np.roll(img, 1, 0)
                + np.roll(img, 2, 1)) / 3).astype(np.uint8)
        b = io.BytesIO()
        Image.fromarray(img).save(b, "JPEG", quality=88)
        ds = dd.parse_device_stream(b.getvalue())
        assert ds is not None and ds.start_bits is not None
        ch = jax.numpy.asarray(ds.chunks)
        sb = jax.numpy.asarray(ds.start_bits)
        from libultrahdr_dev.jpeg.device_decode import (
            chains_from_key, min_code_len_from_key)
        self._both(ch, ds.restart_interval, ds.mcus_x * ds.mcus_y,
                   ds.gray, 2, chains=chains_from_key(ds.tables_key),
                   min_code_bits=min_code_len_from_key(ds.tables_key),
                   start_bits=sb, dc_carry=True)

    @pytest.mark.parametrize("gray,units", [(False, 2), (True, 1)])
    def test_garbage_chunks_identical_truncation(self, gray, units):
        # Arbitrary bytes: both modes must freeze lanes identically
        # (done-by-bit-budget / step caps) and emit the same output.
        # One shape/units pair -> one compile, many payloads.
        for seed in range(8):
            rng = np.random.default_rng(11 + seed)
            ch = jax.numpy.asarray(
                rng.integers(0, 256, (4, 96), np.uint8))
            self._both(ch, 2, 8, gray, units)
