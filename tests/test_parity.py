"""Cross-parity tests against the compiled reference implementation.

These run only when the read-only reference tree and/or the oracle
binary (tools/build_reference_oracle.sh) are present; they are the
strongest correctness signal — bit-exact or PSNR-bounded agreement with
the original C++ on real image fixtures.
"""

import os
import subprocess

import numpy as np
import pytest

REF_DATA = "/root/reference/tests/data"
ORACLE = "/tmp/oracle/golden"
GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")

W, H = 1280, 720


def _need(path):
    if not os.path.exists(path):
        pytest.skip(f"{path} not available")


def load_fixtures():
    _need(os.path.join(REF_DATA, "raw_yuv420_image.yuv420"))
    sdr = np.fromfile(os.path.join(REF_DATA, "raw_yuv420_image.yuv420"),
                      np.uint8)
    y8 = sdr[:W * H].reshape(H, W)
    u8 = sdr[W * H:W * H + W * H // 4].reshape(H // 2, W // 2)
    v8 = sdr[W * H + W * H // 4:].reshape(H // 2, W // 2)
    hdr = np.fromfile(os.path.join(REF_DATA, "raw_p010_image.p010"),
                      np.uint16)
    hy = hdr[:W * H].reshape(H, W)
    huv = hdr[W * H:].reshape(H // 2, W)
    return y8, u8, v8, hy, huv


class TestGainMapParity:
    def test_generate_bitexact_hlg(self):
        """Gain map generation must match the reference byte-for-byte
        on the real 1280x720 fixture (bt709 SDR, bt2100 HLG HDR)."""
        _need(os.path.join(GOLDENS, "gainmap.bin"))
        from libultrahdr_dev.ops import gainmap
        y8, u8, v8, hy, huv = load_fixtures()
        ref = np.fromfile(os.path.join(GOLDENS, "gainmap.bin"),
                          np.uint8).reshape(180, 320)
        gmap, md = gainmap.generate_gainmap(
            y8, u8, v8, hy, huv, sdr_gamut="bt709", hdr_gamut="bt2100",
            hdr_tf="hlg")
        np.testing.assert_array_equal(np.asarray(gmap), ref)
        assert md.max_content_boost == pytest.approx(1000 / 203, rel=1e-6)

    def test_tonemap_matches_reference_shift(self):
        from libultrahdr_dev.ops import gainmap
        _, _, _, hy, huv = load_fixtures()
        y8, u8, v8 = gainmap.tonemap_p010(hy, huv)
        np.testing.assert_array_equal(
            np.asarray(y8), (hy >> 8).astype(np.uint8))


@pytest.mark.skipif(not os.path.exists(ORACLE), reason="oracle not built")
class TestOracleRoundtrip:
    def test_oracle_gainmap_regenerates(self, tmp_path):
        """Sanity: the oracle binary reproduces the stored golden."""
        _need(os.path.join(GOLDENS, "gainmap.bin"))
        subprocess.run(
            [ORACLE, "gengm",
             os.path.join(REF_DATA, "raw_yuv420_image.yuv420"),
             os.path.join(REF_DATA, "raw_p010_image.p010"),
             str(W), str(H), "1"],
            cwd=tmp_path, check=True, capture_output=True)
        fresh = (tmp_path / "gainmap.bin").read_bytes()
        with open(os.path.join(GOLDENS, "gainmap.bin"), "rb") as f:
            assert fresh == f.read()
