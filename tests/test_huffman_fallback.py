"""Pure-Python entropy fallback (jpeg/huffman.py): with the native C++
codec masked out, encode/decode must produce byte- and bit-identical
results."""

import io

import numpy as np
import pytest

from libultrahdr_dev.jpeg import codec


@pytest.fixture
def no_native(monkeypatch):
    monkeypatch.setattr("libultrahdr_dev.jpeg.codec.get_lib",
                        lambda: None)


def _planes(seed=0, w=48, h=40):
    rng = np.random.default_rng(seed)
    # Smooth-ish content so streams carry realistic run lengths.
    y = (rng.integers(0, 64, (h // 8, w // 8)).astype(np.uint8)
         .repeat(8, 0).repeat(8, 1) + rng.integers(0, 32, (h, w)))
    return {
        "y": y.astype(np.uint8),
        "u": rng.integers(96, 160, (h // 2, w // 2), np.uint8),
        "v": rng.integers(96, 160, (h // 2, w // 2), np.uint8),
    }


def test_encode_matches_native():
    planes = _planes()
    native = codec.encode_jpeg(planes, quality=90)
    import libultrahdr_dev.jpeg.codec as c
    orig = c.get_lib
    try:
        c.get_lib = lambda: None
        fallback = codec.encode_jpeg(planes, quality=90)
    finally:
        c.get_lib = orig
    assert native == fallback


def test_decode_matches_native(no_native):
    planes = _planes(seed=1)
    jpg = codec.encode_jpeg(planes, quality=85, restart_interval=2)
    ref_planes = None
    import libultrahdr_dev.jpeg.codec as c
    # decode under fallback (no_native active)
    got = codec.decode_jpeg(jpg)
    # decode under native by restoring get_lib via the real module attr
    from libultrahdr_dev.jpeg.native import get_lib as real
    c.get_lib = real
    ref = codec.decode_jpeg(jpg)
    for a, b in zip(got.planes, ref.planes):
        assert np.array_equal(a, b)


def test_progressive_decode_fallback(no_native):
    pil = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(2)
    rgb = rng.integers(0, 255, (40, 56, 3), np.uint8)
    buf = io.BytesIO()
    pil.fromarray(rgb).save(buf, "JPEG", progressive=True, quality=90,
                            subsampling=2)
    data = buf.getvalue()
    got = codec.decode_jpeg(data)
    import libultrahdr_dev.jpeg.codec as c
    from libultrahdr_dev.jpeg.native import get_lib as real
    c.get_lib = real
    ref = codec.decode_jpeg(data)
    for a, b in zip(got.planes, ref.planes):
        assert np.array_equal(a, b)


def test_gray_roundtrip_fallback(no_native):
    rng = np.random.default_rng(3)
    g = rng.integers(0, 255, (24, 24), np.uint8)
    jpg = codec.encode_jpeg({"y": g}, quality=95)
    dec = codec.decode_jpeg(jpg)
    assert dec.planes[0].shape == (24, 24)
    assert np.abs(dec.planes[0].astype(int) - g.astype(int)).mean() < 16
