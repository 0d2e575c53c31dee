"""C-style API surface tests (capi.py name-parity with ultrahdr_api.h)."""

import numpy as np

from libultrahdr_dev import capi
from libultrahdr_dev.api import HDR_IMG
from libultrahdr_dev.types import (ColorGamut, ColorTransfer,
                                       PixelFormat, RawImage)


def p010(h=32, w=32):
    rng = np.random.default_rng(0)
    return RawImage(
        fmt=PixelFormat.P010, width=w, height=h, gamut=ColorGamut.BT2100,
        transfer=ColorTransfer.HLG,
        planes={"y": (rng.integers(64, 940, (h, w)).astype(np.uint16)) << 6,
                "uv": np.full((h // 2, w), 512 << 6, np.uint16)})


def test_c_style_encode_decode_cycle():
    enc = capi.uhdr_create_encoder()
    st = capi.uhdr_enc_set_raw_image(enc, p010(), HDR_IMG)
    assert st["error_code"] == "UHDR_CODEC_OK"
    st = capi.uhdr_encode(enc)
    assert st["error_code"] == "UHDR_CODEC_OK"
    stream = capi.uhdr_get_encoded_stream(enc)
    assert capi.is_uhdr_image(stream.data) == 1

    dec = capi.uhdr_create_decoder()
    assert capi.uhdr_dec_set_image(dec, stream.data)["error_code"] == \
        "UHDR_CODEC_OK"
    assert capi.uhdr_dec_probe(dec)["error_code"] == "UHDR_CODEC_OK"
    assert capi.uhdr_dec_get_image_width(dec) == 32
    assert capi.uhdr_dec_get_gainmap_height(dec) == 8
    assert capi.uhdr_dec_get_icc(dec) is not None
    assert capi.uhdr_decode(dec)["error_code"] == "UHDR_CODEC_OK"
    img = capi.uhdr_get_decoded_image(dec)
    assert img.fmt == PixelFormat.RGBA_F16
    capi.uhdr_reset_decoder(dec)
    capi.uhdr_release_encoder(enc)


def test_c_style_errors_returned_not_raised():
    enc = capi.uhdr_create_encoder()
    st = capi.uhdr_enc_set_quality(enc, 200)
    assert st["error_code"] == "UHDR_CODEC_INVALID_PARAM"
    assert st["has_detail"] == 1
    st = capi.uhdr_encode(enc)
    assert st["error_code"] == "UHDR_CODEC_INVALID_OPERATION"
    dec = capi.uhdr_create_decoder()
    st = capi.uhdr_dec_set_image(dec, b"")
    assert st["error_code"] == "UHDR_CODEC_INVALID_PARAM"
    assert capi.is_uhdr_image(b"junk") == 0
