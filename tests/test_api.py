"""Stable-API tests: staged configuration, sailed state machine, API
dispatch, decoder probe/getters — mirroring the reference's
ultrahdr_api semantics."""

import numpy as np
import pytest

from libultrahdr_dev import (ColorGamut, ColorTransfer, CompressedImage,
                                 GainMapMetadata, PixelFormat, RawImage,
                                 UhdrDecoder, UhdrEncoder, UhdrError,
                                 is_uhdr_image)
from libultrahdr_dev.api import BASE_IMG, HDR_IMG, SDR_IMG
from libultrahdr_dev.container import mux


def p010(h=64, w=96, gamut=ColorGamut.BT2100, tf=ColorTransfer.HLG):
    rng = np.random.default_rng(1)
    y = (rng.integers(64, 940, (h, w)).astype(np.uint16)) << 6
    uv = np.full((h // 2, w), 512 << 6, np.uint16)
    return RawImage(fmt=PixelFormat.P010, width=w, height=h, gamut=gamut,
                    transfer=tf, planes={"y": y, "uv": uv})


def yuv420(h=64, w=96, gamut=ColorGamut.BT709):
    return RawImage(fmt=PixelFormat.YUV420, width=w, height=h, gamut=gamut,
                    transfer=ColorTransfer.SRGB,
                    planes={"y": np.full((h, w), 150, np.uint8),
                            "u": np.full((h // 2, w // 2), 128, np.uint8),
                            "v": np.full((h // 2, w // 2), 128, np.uint8)})


class TestEncoder:
    def test_api0_flow(self):
        enc = UhdrEncoder()
        enc.set_raw_image(p010(), HDR_IMG)
        out = enc.encode()
        assert is_uhdr_image(out.data)

    def test_api1_flow(self):
        enc = UhdrEncoder()
        enc.set_raw_image(p010(), HDR_IMG)
        enc.set_raw_image(yuv420(), SDR_IMG)
        enc.set_quality(90)
        out = enc.encode()
        assert is_uhdr_image(out.data)

    def test_api4_flow(self):
        blob = (UhdrEncoder().set_raw_image(p010(), HDR_IMG)
                .encode().data)
        primary, gm = mux.extract_primary_and_gainmap(blob)
        md = GainMapMetadata(max_content_boost=1000 / 203,
                             hdr_capacity_max=1000 / 203)
        enc = UhdrEncoder()
        enc.set_compressed_image(CompressedImage(data=primary), BASE_IMG)
        enc.set_gainmap_image(CompressedImage(data=gm), md)
        out = enc.encode()
        assert is_uhdr_image(out.data)

    def test_sailed_state(self):
        enc = UhdrEncoder()
        enc.set_raw_image(p010(), HDR_IMG)
        first = enc.encode()
        # setters refuse after encode (ultrahdr_api.cpp:253-260).
        with pytest.raises(UhdrError):
            enc.set_quality(80)
        # repeated encode returns same outcome.
        assert enc.encode().data == first.data
        # reset clears.
        enc.reset()
        enc.set_raw_image(p010(), HDR_IMG)
        assert enc.encode().data == first.data

    def test_encode_without_resources(self):
        with pytest.raises(UhdrError):
            UhdrEncoder().encode()

    def test_failed_encode_replays_error(self):
        enc = UhdrEncoder()
        enc.set_raw_image(p010(), HDR_IMG)
        enc._raw[HDR_IMG].transfer = ColorTransfer.SRGB  # force failure
        with pytest.raises(UhdrError):
            enc.encode()
        with pytest.raises(UhdrError):
            enc.encode()

    def test_validation(self):
        enc = UhdrEncoder()
        with pytest.raises(UhdrError):
            enc.set_raw_image(yuv420(), HDR_IMG)  # wrong fmt for intent
        with pytest.raises(UhdrError):
            enc.set_raw_image(p010(), SDR_IMG)
        with pytest.raises(UhdrError):
            enc.set_quality(101)
        with pytest.raises(UhdrError):
            enc.set_compressed_image(CompressedImage(data=b""), SDR_IMG)
        bad = p010()
        bad.transfer = ColorTransfer.UNSPECIFIED
        with pytest.raises(UhdrError):
            enc.set_raw_image(bad, HDR_IMG)


class TestDecoder:
    def make_blob(self):
        return UhdrEncoder().set_raw_image(p010(), HDR_IMG).encode().data

    def test_probe_and_getters(self):
        blob = self.make_blob()
        dec = UhdrDecoder()
        dec.set_image(blob)
        assert dec.get_image_width() == 96
        assert dec.get_image_height() == 64
        assert dec.get_gainmap_width() == 24
        assert dec.get_gainmap_height() == 16
        md = dec.get_gainmap_metadata()
        assert md.max_content_boost == pytest.approx(1000 / 203, rel=1e-4)
        assert dec.get_icc() is not None

    def test_default_decode_is_f16_linear(self):
        dec = UhdrDecoder()
        dec.set_image(self.make_blob())
        img = dec.decode()
        assert img.fmt == PixelFormat.RGBA_F16
        assert np.asarray(img.planes["rgba"]).dtype == np.uint16

    def test_sdr_decode(self):
        dec = UhdrDecoder()
        dec.set_image(self.make_blob())
        dec.set_out_img_format(PixelFormat.RGBA8888)
        dec.set_out_color_transfer(ColorTransfer.SRGB)
        img = dec.decode()
        assert img.fmt == PixelFormat.RGBA8888

    def test_invalid_combination(self):
        dec = UhdrDecoder()
        dec.set_image(self.make_blob())
        dec.set_out_img_format(PixelFormat.RGBA8888)
        dec.set_out_color_transfer(ColorTransfer.PQ)
        with pytest.raises(UhdrError):
            dec.decode()

    def test_sailed(self):
        dec = UhdrDecoder()
        dec.set_image(self.make_blob())
        img = dec.decode()
        with pytest.raises(UhdrError):
            dec.set_out_max_display_boost(3.0)
        assert dec.decode() is img  # cached
        assert dec.get_gain_map_image().shape == (16, 24)

    def test_probe_garbage(self):
        dec = UhdrDecoder()
        dec.set_image(b"\x00" * 64)
        with pytest.raises(UhdrError):
            dec.probe()

    def test_is_uhdr_image(self):
        assert is_uhdr_image(self.make_blob())
        assert not is_uhdr_image(b"junk")


class TestEditor:
    def test_crop(self):
        from libultrahdr_dev.ops import editor
        img = yuv420(64, 96)
        img.planes["y"][:] = np.arange(96, dtype=np.uint8)[None, :]
        out = editor.crop(img, editor.CropEffect(10, 42, 4, 36))
        assert (out.width, out.height) == (32, 32)
        assert out.planes["y"][0, 0] == 10
        assert out.planes["u"].shape == (16, 16)

    def test_mirror(self):
        from libultrahdr_dev.ops import editor
        img = yuv420(4, 6)
        img.planes["y"][:] = np.arange(6, dtype=np.uint8)[None, :]
        out = editor.mirror(img, editor.MirrorEffect("horizontal"))
        assert out.planes["y"][0, 0] == 5
        out2 = editor.mirror(img, editor.MirrorEffect("vertical"))
        np.testing.assert_array_equal(out2.planes["y"], img.planes["y"][::-1])

    def test_rotate(self):
        from libultrahdr_dev.ops import editor
        img = yuv420(4, 6)
        img.planes["y"][0, 0] = 7
        out = editor.rotate(img, editor.RotateEffect(90))
        assert (out.width, out.height) == (4, 6)
        # clockwise: top-left -> top-right
        assert out.planes["y"][0, -1] == 7
        out = editor.rotate(img, editor.RotateEffect(180))
        assert out.planes["y"][-1, -1] == 7

    def test_resize(self):
        from libultrahdr_dev.ops import editor
        img = yuv420(8, 12)
        out = editor.resize(img, editor.ResizeEffect(6, 4))
        assert (out.width, out.height) == (6, 4)
        assert out.planes["u"].shape == (2, 3)

    def test_chain(self):
        from libultrahdr_dev.ops import editor
        img = yuv420(16, 16)
        out = editor.apply_effects(img, [
            editor.CropEffect(0, 8, 0, 8),
            editor.MirrorEffect("vertical"),
            editor.RotateEffect(270),
            editor.ResizeEffect(4, 4),
        ])
        assert (out.width, out.height) == (4, 4)


class TestCli:
    def test_encode_decode_cycle(self, tmp_path):
        from libultrahdr_dev import cli
        img = p010(64, 96)
        raw = np.concatenate([np.asarray(img.planes["y"]).ravel(),
                              np.asarray(img.planes["uv"]).ravel()])
        src = tmp_path / "in.p010"
        raw.astype(np.uint16).tofile(src)
        out = tmp_path / "out.jpegr"
        rc = cli.main(["-m", "0", "-p", str(src), "-w", "96",
                       "--height", "64", "-C", "2", "-t", "1",
                       "-q", "95", "-z", str(out), "-e", "1"])
        assert rc == 0 and out.exists()
        dec_out = tmp_path / "dec.raw"
        rc = cli.main(["-m", "1", "-j", str(out), "-o", "0", "-O", "4",
                       "-z", str(dec_out)])
        assert rc == 0
        data = np.fromfile(dec_out, np.uint16).reshape(64, 96, 4)
        assert np.all(data[..., 3].view(np.float16) == 1.0)


def test_enc_set_output_format():
    from libultrahdr_dev.api import UhdrEncoder
    from libultrahdr_dev.types import UhdrError

    enc = UhdrEncoder()
    enc.set_output_format("jpg")
    with pytest.raises(UhdrError):
        enc.set_output_format("heif")


def test_enc_compressed_hdr_intent_accepted():
    from libultrahdr_dev.api import HDR_IMG, UhdrEncoder
    from libultrahdr_dev.types import CompressedImage, UhdrError

    enc = UhdrEncoder()
    enc.set_compressed_image(CompressedImage(data=b"\xff\xd8junk"),
                             HDR_IMG)
    with pytest.raises(UhdrError):
        enc.set_compressed_image(CompressedImage(data=b"x"), "bogus")


def test_cli_dash_h_is_height(tmp_path):
    import subprocess
    import sys

    import numpy as np

    p010_path = tmp_path / "in.p010"
    h, w = 32, 48
    rng = np.random.default_rng(0)
    y = (rng.integers(64, 940, (h, w)).astype(np.uint16) << 6)
    uv = np.full((h // 2, w), 512 << 6, np.uint16)
    p010_path.write_bytes(y.tobytes() + uv.tobytes())
    out = tmp_path / "out.jpegr"
    env = dict(__import__("os").environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-m", "libultrahdr_dev.cli", "-m", "0",
         "-p", str(p010_path), "-w", str(w), "-h", str(h), "-C", "2",
         "-t", "1", "-z", str(out)],
        capture_output=True, text=True, env=env, cwd="/root/repo")
    assert r.returncode == 0, r.stderr[-2000:]
    assert out.read_bytes()[:2] == b"\xff\xd8"


def test_raw_image_from_strided_buffers():
    """uhdr_raw_image_t stride semantics (ultrahdr_api.h:131-150):
    camera buffers with padded rows ingest without caller-side copies
    and encode identically to dense ones."""
    import numpy as np

    from libultrahdr_dev.jpegr import JpegR
    from libultrahdr_dev.types import (ColorGamut, ColorTransfer,
                                           PixelFormat, RawImage,
                                           UhdrError)

    h, w, stride = 32, 48, 64
    rng = np.random.default_rng(7)
    ybuf = np.zeros((h, stride), np.uint16)
    ybuf[:, :w] = rng.integers(64, 940, (h, w)).astype(np.uint16) << 6
    uvbuf = np.zeros((h // 2, stride), np.uint16)
    uvbuf[:, :w] = 512 << 6

    strided = RawImage.from_buffers(
        PixelFormat.P010, w, h,
        {"y": ybuf, "uv": uvbuf},
        strides={"y": stride, "uv": stride},
        gamut=ColorGamut.BT2100)
    dense = RawImage(fmt=PixelFormat.P010, width=w, height=h,
                     gamut=ColorGamut.BT2100,
                     planes={"y": np.ascontiguousarray(ybuf[:, :w]),
                             "uv": np.ascontiguousarray(uvbuf[:, :w])})
    jr = JpegR()
    a = jr.encode_api0(strided, ColorTransfer.HLG, quality=95)
    b = jr.encode_api0(dense, ColorTransfer.HLG, quality=95)
    assert a == b

    # 2-D padded views without explicit strides also normalize.
    v = RawImage.from_buffers(PixelFormat.P010, w, h,
                              {"y": ybuf, "uv": uvbuf},
                              gamut=ColorGamut.BT2100)
    assert v.planes["y"].shape == (h, w)

    with pytest.raises(UhdrError):
        RawImage.from_buffers(PixelFormat.P010, w, h,
                              {"y": ybuf[:, :w - 8], "uv": uvbuf},
                              strides={"y": 16, "uv": stride})


class TestStableVsClassParity:
    """The stable API and the JpegR class must produce byte-identical
    streams and decodes for every gamut x transfer combination —
    mirroring jpegr_test.cpp's parameterized fixture (1434-1482),
    which asserts the legacy C++ API and the stable C API agree."""

    @pytest.mark.parametrize("gamut", [ColorGamut.BT709, ColorGamut.P3,
                                       ColorGamut.BT2100])
    @pytest.mark.parametrize("tf", [ColorTransfer.HLG, ColorTransfer.PQ])
    def test_encode_decode_byte_identity(self, gamut, tf):
        from libultrahdr_dev.jpegr import JpegR
        from libultrahdr_dev.types import OutputFormat

        img = p010(h=48, w=64, gamut=gamut, tf=tf)
        blob_stable = (UhdrEncoder().set_raw_image(img, HDR_IMG)
                       .set_quality(95).encode().data)
        blob_class = JpegR().encode_api0(img, tf, quality=95)
        assert blob_stable == blob_class

        dec = UhdrDecoder()
        dec.set_image(blob_stable)
        via_api = np.asarray(dec.decode().planes["rgba"])
        via_class = np.asarray(
            JpegR().decode(blob_stable, OutputFormat.HDR_LINEAR)
            .image.planes["rgba"])
        assert np.array_equal(via_api, via_class)
