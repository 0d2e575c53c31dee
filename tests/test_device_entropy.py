"""Device-side entropy encoder tests: byte parity with the host C++
bit-writer for both the scatter path and the scatter-free
restart-marker path, plus edge cases and overflow handling."""

import numpy as np
import pytest

from libultrahdr_dev.jpeg import codec, device_entropy as de, tables

HOST_TABLES = dict(
    dc_tables=[(tables.DC_LUMA_BITS, tables.DC_LUMA_VALS),
               (tables.DC_CHROMA_BITS, tables.DC_CHROMA_VALS)],
    ac_tables=[(tables.AC_LUMA_BITS, tables.AC_LUMA_VALS),
               (tables.AC_CHROMA_BITS, tables.AC_CHROMA_VALS)])


def host_encode(blocks, restart=0):
    comp_ids = np.tile(np.array([0, 0, 0, 0, 1, 2], np.uint8),
                       blocks.shape[0] // 6)
    return codec.entropy_encode(blocks, comp_ids, [0, 1, 1], [0, 1, 1],
                                restart_interval=restart, mcu_blocks=6,
                                **HOST_TABLES)


def sparse_blocks(n_mcus, seed=0, density=0.2, amp=60):
    rng = np.random.default_rng(seed)
    n = n_mcus * 6
    b = np.zeros((n, 64), np.int16)
    b[:, 0] = rng.integers(-400, 400, n)
    mask = rng.random((n, 63)) < density
    b[:, 1:][mask] = rng.integers(-amp, amp, mask.sum())
    b[:, 1:][b[:, 1:] == 0] += mask[b[:, 1:] == 0] * 1  # keep mask nonzero
    return b


class TestScatterPath:
    @pytest.mark.parametrize("seed", range(3))
    def test_byte_parity(self, seed):
        blocks = sparse_blocks(8, seed=seed)
        assert de.entropy_encode_yuv420_device(blocks) == \
            host_encode(blocks)

    def test_gray_parity(self):
        blocks = sparse_blocks(2, seed=9)[:10]
        comp_ids = np.zeros(10, np.uint8)
        host = codec.entropy_encode(
            blocks, comp_ids, [0], [0],
            [(tables.DC_LUMA_BITS, tables.DC_LUMA_VALS)],
            [(tables.AC_LUMA_BITS, tables.AC_LUMA_VALS)], 0, 1)
        assert de.entropy_encode_gray_device(blocks) == host

    def test_edge_patterns(self):
        for blocks in (
            np.zeros((6, 64), np.int16),                       # all zero
            np.eye(64, dtype=np.int16)[None].repeat(6, 0)[:, 0]  # dummy
            .reshape(6, 64) * 0 + np.int16(0),
        ):
            assert de.entropy_encode_yuv420_device(blocks) == \
                host_encode(blocks)
        zr = np.zeros((6, 64), np.int16)
        zr[:, 0] = 7
        zr[:, 63] = 3       # maximum run -> ZRLs
        zr[:, 20] = -1000   # large magnitude
        assert de.entropy_encode_yuv420_device(zr) == host_encode(zr)


class TestRstPath:
    @pytest.mark.parametrize("n_mcus,r", [(8, 4), (20, 4), (7, 4),
                                          (16, 2), (5, 1)])
    def test_byte_parity_with_host_restarts(self, n_mcus, r):
        """The scatter-free stream must equal the host bit-writer's
        output with the same restart interval (fill stripped)."""
        blocks = sparse_blocks(n_mcus, seed=n_mcus * 10 + r)
        kern = de._rst_kernel_yuv420(blocks.shape[0], r)
        sw, cbits, total, ovf = kern(blocks)
        assert not bool(ovf)
        stream = de.finalize_rst_stream(
            np.asarray(sw)[:int(total)], np.asarray(cbits), r)
        assert stream == host_encode(blocks, restart=r)

    def test_overflow_flag_on_dense_blocks(self):
        rng = np.random.default_rng(0)
        blocks = rng.integers(-800, 800, (24, 64)).astype(np.int16)
        kern = de._rst_kernel_yuv420(24, 4)
        _, _, _, ovf = kern(blocks)
        assert bool(ovf)

    def test_rst_stream_decodes(self):
        """End to end through the markers: our decoder must reproduce
        the coefficients from an RST-framed stream."""
        blocks = sparse_blocks(12, seed=3)
        r = 4
        kern = de._rst_kernel_yuv420(blocks.shape[0], r)
        sw, cbits, total, _ = kern(blocks)
        stream = de.finalize_rst_stream(
            np.asarray(sw)[:int(total)], np.asarray(cbits), r)
        comp_ids = np.tile(np.array([0, 0, 0, 0, 1, 2], np.uint8), 12)
        decoded = codec.entropy_decode(
            stream, blocks.shape[0], comp_ids, [0, 1, 1], [0, 1, 1],
            restart_interval=r, mcu_blocks=6, **HOST_TABLES)
        np.testing.assert_array_equal(decoded, blocks)


class TestYcbcrRstEncode:
    """Generalized [Y*ypm, U, V] scatter-free RST encoder + the
    encode_jpeg routing: device output must be byte-identical to the
    host native encoder for every sampling (same Annex-K tables, same
    interval padding)."""

    @pytest.mark.parametrize("name,chroma", [
        ("420", (2, 2)), ("422", (1, 2)), ("444", (1, 1)),
        ("gray", None),
    ])
    def test_encode_jpeg_device_matches_host(self, name, chroma,
                                             monkeypatch):
        rng = np.random.default_rng(len(name))
        h, w = 96, 144
        y = ((rng.integers(0, 256, (h, w)).astype(np.float32)
              + rng.integers(0, 256, (h, w))) / 2).astype(np.uint8)
        planes = {"y": y}
        if chroma is not None:
            dv, dh = chroma
            planes["u"] = rng.integers(0, 256, (h // dv, w // dh),
                                       np.uint8)
            planes["v"] = rng.integers(0, 256, (h // dv, w // dh),
                                       np.uint8)
        monkeypatch.setattr(codec, "_DEVICE_CODEC_ON_CPU", True)
        monkeypatch.setattr(codec, "_DEVICE_ENCODE_MIN_PIXELS", 0)
        dev = codec.encode_jpeg(planes, quality=87, restart_interval=6)
        monkeypatch.setattr(codec, "_DEVICE_ENCODE_MIN_PIXELS",
                            1 << 62)
        host = codec.encode_jpeg(planes, quality=87,
                                 restart_interval=6)
        assert dev == host

    def test_device_422_stream_decodes_on_device(self, monkeypatch):
        # full circle: device 4:2:2 encode -> device (RST-lane) decode
        from libultrahdr_dev.jpeg import device_decode as dd
        rng = np.random.default_rng(9)
        h, w = 64, 112
        planes = {"y": rng.integers(0, 256, (h, w), np.uint8),
                  "u": rng.integers(0, 256, (h, w // 2), np.uint8),
                  "v": rng.integers(0, 256, (h, w // 2), np.uint8)}
        monkeypatch.setattr(codec, "_DEVICE_CODEC_ON_CPU", True)
        monkeypatch.setattr(codec, "_DEVICE_ENCODE_MIN_PIXELS", 0)
        blob = codec.encode_jpeg(planes, quality=85, restart_interval=3)
        res = dd.decode_jpeg_device(blob)
        assert res is not None
        ds, dplanes = res
        assert ds.sampling == (2, 1) and ds.start_bits is None
        host = codec.decode_jpeg(blob)
        for p, hp in zip(dplanes, host.planes):
            assert np.array_equal(
                np.asarray(p)[: hp.shape[0], : hp.shape[1]], hp)
