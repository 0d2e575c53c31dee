"""Core datatypes for the JAX Ultra HDR codec.

Mirrors the semantics of the reference's public types
(/root/reference/ultrahdr_api.h:37-182 and
 /root/reference/lib/include/ultrahdr/ultrahdr.h) with Python-idiomatic
enums/dataclasses.  Image planes are numpy arrays host-side and jnp
arrays on device; all strides are implicit (arrays are dense,
row-major) — device buffers carry their own layout so the
reference's explicit luma/chroma stride plumbing is unnecessary.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np

# Gain map spatial downscale factor (ultrahdr.h:213).
MAP_DIMENSION_SCALE_FACTOR = 4
GAIN_MAP_VERSION = "1.0"

# JPEG quality default for the gain map (jpegr.cpp:41).
MAP_COMPRESS_QUALITY = 85
# Stable-API defaults: base 95 / gainmap 85 (ultrahdr_api.cpp:842-845).
DEFAULT_BASE_QUALITY = 95

# Dimension limits (jpegr.h:31-32, jpegdecoderhelper.h:42-43).
MIN_WIDTH = 8
MIN_HEIGHT = 8
MAX_WIDTH = 8192
MAX_HEIGHT = 8192


class ColorGamut(enum.Enum):
    """ultrahdr_api.h:56-61."""

    UNSPECIFIED = "unspecified"
    BT709 = "bt709"
    P3 = "p3"
    BT2100 = "bt2100"


class ColorTransfer(enum.Enum):
    """ultrahdr_api.h:64-70."""

    UNSPECIFIED = "unspecified"
    LINEAR = "linear"
    HLG = "hlg"
    PQ = "pq"
    SRGB = "srgb"


class OutputFormat(enum.Enum):
    """Decode output formats (ultrahdr.h legacy ultrahdr_output_format)."""

    SDR = "sdr"                      # RGBA8888
    HDR_LINEAR = "hdr_linear"        # RGBA F16, linear, scaled by display boost
    HDR_PQ = "hdr_pq"                # RGBA1010102, PQ-encoded
    HDR_HLG = "hdr_hlg"              # RGBA1010102, HLG-encoded
    HDR_LINEAR_RGB_10BIT = "hdr_linear_rgb_10bit"  # planar 10-bit RGB


class PixelFormat(enum.Enum):
    """ultrahdr_api.h:37-53."""

    P010 = "p010"
    YUV420 = "yuv420"
    MONOCHROME = "yuv400"
    RGBA8888 = "rgba8888"
    RGBA_F16 = "rgbaf16"
    RGBA1010102 = "rgba1010102"
    RGB_10BIT_PLANAR = "rgb10planar"  # (3, H, W) u16, 10-bit values


class UhdrError(Exception):
    """Codec error with a uhdr_codec_err_t-style code
    (ultrahdr_api.h:94-117)."""

    def __init__(self, code: str, detail: str = ""):
        self.code = code
        self.detail = detail
        super().__init__(f"{code}: {detail}" if detail else code)


def err(code: str, detail: str = "") -> UhdrError:
    return UhdrError(code, detail)


@dataclass
class GainMapMetadata:
    """Gain map metadata (ultrahdr_api.h:174-182, ultrahdr.h metadata
    struct). Boosts are linear (not log2)."""

    version: str = GAIN_MAP_VERSION
    max_content_boost: float = 1.0
    min_content_boost: float = 1.0
    gamma: float = 1.0
    offset_sdr: float = 0.0
    offset_hdr: float = 0.0
    hdr_capacity_min: float = 1.0
    hdr_capacity_max: float = 1.0


@dataclass
class RawImage:
    """An uncompressed image: planes keyed by name.

    - P010 ("p010"): planes {"y": u16 (H,W) MSB-aligned 10-bit,
      "uv": u16 (H//2, W) interleaved CbCr} (ultrahdr_api.h:39-41).
    - YUV420 ("yuv420"): {"y": u8 (H,W), "u": u8 (H//2,W//2),
      "v": u8 (H//2,W//2)}.
    - MONOCHROME: {"y": u8 (H,W)}.
    - RGBA8888: {"rgba": u32 (H,W)}; RGBA_F16: {"rgba": u64 (H,W)};
      RGBA1010102: {"rgba": u32 (H,W)}.
    - 10-bit planar RGB: {"r","g","b": u16 (H,W)}.
    """

    fmt: PixelFormat
    width: int
    height: int
    gamut: ColorGamut = ColorGamut.UNSPECIFIED
    transfer: ColorTransfer = ColorTransfer.UNSPECIFIED
    planes: dict = field(default_factory=dict)

    def validate_even_dims(self):
        if self.width % 2 or self.height % 2:
            raise err("UHDR_CODEC_INVALID_PARAM",
                      f"odd image dimensions {self.width}x{self.height}")

    # Per-format plane geometry: name -> (height_divisor, width_divisor)
    # in SAMPLES (P010 "uv" rows interleave Cb/Cr so width == w).
    _PLANE_GEOM = {
        "p010": {"y": (1, 1), "uv": (2, 1)},
        "yuv420": {"y": (1, 1), "u": (2, 2), "v": (2, 2)},
        "yuv400": {"y": (1, 1)},
        "rgba8888": {"rgba": (1, 1)},
        "rgbaf16": {"rgba": (1, 1)},
        "rgba1010102": {"rgba": (1, 1)},
    }

    @classmethod
    def from_buffers(cls, fmt: "PixelFormat", width: int, height: int,
                     planes: dict, strides: dict | None = None,
                     gamut: "ColorGamut" = None,
                     transfer: "ColorTransfer" = None) -> "RawImage":
        """Build a RawImage from possibly row-padded buffers, matching
        uhdr_raw_image_t's per-plane stride semantics
        (ultrahdr_api.h:131-150; stride plumbing jpegr.cpp:300-361).

        Each plane may be a flat or 2-D array whose rows span
        `strides[name]` samples (>= the plane's natural width); the
        stored planes are dense views of the top-left region. Strided
        numpy views are accepted directly when `strides` is omitted.
        """
        import numpy as np

        geom = cls._PLANE_GEOM.get(fmt.value)
        if geom is None:
            raise err("UHDR_CODEC_INVALID_PARAM",
                      f"from_buffers unsupported for {fmt}")
        norm = {}
        for name, (hd, wd) in geom.items():
            if name not in planes:
                raise err("UHDR_CODEC_INVALID_PARAM",
                          f"missing plane {name}")
            arr = np.asarray(planes[name])
            ph, pw = height // hd, width // wd
            stride = (strides or {}).get(name)
            if stride is not None:
                if stride < pw:
                    raise err("UHDR_CODEC_INVALID_PARAM",
                              f"stride {stride} < width {pw} "
                              f"for plane {name}")
                arr = arr.reshape(-1)
                if arr.size < (ph - 1) * stride + pw:
                    raise err("UHDR_CODEC_INVALID_PARAM",
                              f"plane {name} buffer too small")
                arr = np.lib.stride_tricks.as_strided(
                    arr, (ph, pw),
                    (stride * arr.itemsize, arr.itemsize))
            else:
                if arr.ndim != 2 or arr.shape[0] < ph \
                        or arr.shape[1] < pw:
                    raise err("UHDR_CODEC_INVALID_PARAM",
                              f"plane {name} shape {arr.shape} "
                              f"smaller than {(ph, pw)}")
                arr = arr[:ph, :pw]
            norm[name] = arr
        kw = {}
        if gamut is not None:
            kw["gamut"] = gamut
        if transfer is not None:
            kw["transfer"] = transfer
        return cls(fmt=fmt, width=width, height=height, planes=norm,
                   **kw)


@dataclass
class CompressedImage:
    """A compressed bitstream + color info (ultrahdr_api.h:153-160)."""

    data: bytes
    gamut: ColorGamut = ColorGamut.UNSPECIFIED
    transfer: ColorTransfer = ColorTransfer.UNSPECIFIED
    range: str = "unspecified"


def alloc_yuv420(width: int, height: int, gamut=ColorGamut.UNSPECIFIED) -> RawImage:
    return RawImage(
        fmt=PixelFormat.YUV420, width=width, height=height, gamut=gamut,
        planes={
            "y": np.zeros((height, width), np.uint8),
            "u": np.zeros((height // 2, width // 2), np.uint8),
            "v": np.zeros((height // 2, width // 2), np.uint8),
        })


def alloc_p010(width: int, height: int, gamut=ColorGamut.UNSPECIFIED) -> RawImage:
    return RawImage(
        fmt=PixelFormat.P010, width=width, height=height, gamut=gamut,
        planes={
            "y": np.zeros((height, width), np.uint16),
            "uv": np.zeros((height // 2, width), np.uint16),
        })
