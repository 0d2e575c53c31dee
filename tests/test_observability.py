"""Device paths must fail loudly: an exception in a device kernel or a
device readback propagates to the caller instead of being swallowed by
a host fallback. The process-wide counters record only the routes the
data decides (frame size, dense-content overflow, incompressible
readback, streams the device decoder does not take)."""

import numpy as np
import pytest

from libultrahdr_dev.jpeg import codec
from libultrahdr_dev.utils import counters


@pytest.fixture(autouse=True)
def _fresh_counters():
    counters.reset()
    yield
    counters.reset()


def _planes(h=96, w=144, seed=0):
    rng = np.random.default_rng(seed)
    return {"y": rng.integers(0, 256, (h, w), np.uint8),
            "u": rng.integers(0, 256, (h // 2, w // 2), np.uint8),
            "v": rng.integers(0, 256, (h // 2, w // 2), np.uint8)}


class TestEncodeFallback:
    def test_broken_device_kernel_warns_and_counts(self, monkeypatch):
        # The device kernel's exception reaches the caller; no host
        # encode hides it.
        from libultrahdr_dev.jpeg import device_entropy as de

        planes = _planes(seed=1)
        monkeypatch.setattr(codec, "_DEVICE_CODEC_ON_CPU", True)
        monkeypatch.setattr(codec, "_DEVICE_ENCODE_MIN_PIXELS", 0)

        def boom(*a, **k):
            raise RuntimeError("deliberately broken device kernel")

        monkeypatch.setattr(de, "_rst_kernel_ycbcr", boom)
        with pytest.raises(RuntimeError, match="broken device kernel"):
            codec.encode_jpeg(planes, quality=87, restart_interval=6)
        assert counters.snapshot() == {}


class TestDecodeFallback:
    def test_broken_device_decode_warns_and_counts(self, monkeypatch):
        from libultrahdr_dev.jpeg import device_decode as dd

        blob = codec.encode_jpeg(_planes(seed=2), quality=85,
                                 restart_interval=5)
        monkeypatch.setattr(codec, "_DEVICE_CODEC_ON_CPU", True)
        monkeypatch.setattr(codec, "_DEVICE_DECODE_MIN_PIXELS", 0)

        def boom(*a, **k):
            raise RuntimeError("deliberately broken device decode")

        monkeypatch.setattr(dd, "decode_jpeg_device", boom)
        with pytest.raises(RuntimeError, match="broken device decode"):
            codec.decode_jpeg(blob)
        assert counters.snapshot() == {}


class TestRiceReadbackFallback:
    def test_rice_raise_falls_back_to_fine_width(self, monkeypatch):
        import jax

        from libultrahdr_dev.parallel import packio, sharding

        rng = np.random.default_rng(3)
        raw = (rng.integers(0, 1 << 30, (2, 16, 64), np.uint32)
               | np.uint32(0xC0000000))
        dev = jax.device_put(raw)

        def boom(*a, **k):
            raise RuntimeError("deliberately broken readback pack")

        monkeypatch.setattr(packio, "fetch_rgba1010102_auto", boom)
        with pytest.raises(RuntimeError, match="broken readback pack"):
            sharding.fetch_1010102_packed(dev, {})
        assert counters.snapshot() == {}


class TestDataRouteCounters:
    def test_small_frame_stays_on_host_encoder(self, monkeypatch):
        monkeypatch.setattr(codec, "_DEVICE_CODEC_ON_CPU", True)
        planes = _planes(seed=4)
        host = codec.encode_jpeg(planes, quality=87, restart_interval=6)
        assert counters.snapshot() == {
            "encode_entropy_host_small_frame": 1}
        monkeypatch.setattr(codec, "_DEVICE_ENCODE_MIN_PIXELS", 0)
        assert codec.encode_jpeg(planes, quality=87,
                                 restart_interval=6) == host
        assert counters.snapshot() == {
            "encode_entropy_host_small_frame": 1}

    def test_small_frame_stays_on_host_decoder(self, monkeypatch):
        blob = codec.encode_jpeg(_planes(seed=5), quality=85,
                                 restart_interval=5)
        monkeypatch.setattr(codec, "_DEVICE_CODEC_ON_CPU", True)
        codec.decode_jpeg(blob)
        assert counters.snapshot() == {"decode_host_small_frame": 1}

    def test_no_route_counted_without_accelerator(self):
        planes = _planes(seed=6)
        blob = codec.encode_jpeg(planes, quality=85, restart_interval=5)
        codec.decode_jpeg(blob)
        assert counters.snapshot() == {}

    def test_incompressible_readback_counts_raw_fetch(self):
        import jax

        from libultrahdr_dev.parallel import sharding

        rng = np.random.default_rng(7)
        raw = (rng.integers(0, 1 << 30, (2, 32, 256), np.uint32)
               | np.uint32(0xC0000000))
        stats = {}
        out = sharding.fetch_1010102_packed(jax.device_put(raw), stats)
        np.testing.assert_array_equal(out, raw)
        assert stats["d2h_pack"] == "raw"
        assert counters.snapshot() == {"readback_raw_incompressible": 1}


class TestDeviceTrace:
    def test_start_failure_propagates(self, monkeypatch, tmp_path):
        import jax

        from libultrahdr_dev.utils import profiler

        def boom(*a, **k):
            raise RuntimeError("profiler unavailable")

        monkeypatch.setattr(jax.profiler, "start_trace", boom)
        with pytest.raises(RuntimeError, match="profiler unavailable"):
            with profiler.device_trace(str(tmp_path)):
                pass
