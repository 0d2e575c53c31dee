"""libultrahdr_dev: JAX Ultra HDR (JPEG/R) image codec.

A ground-up JAX/XLA re-design of libultrahdr
(github.com/DichenZhang1/libultrahdr_dev): the gain-map pixel math and
JPEG DCT path run on the accelerator (a GPU) as fused XLA programs; Huffman
entropy coding is native C++ on the host; container and metadata
(XMP/ICC/MPF) are byte-exact host codecs.

Public surface:
  - api.UhdrEncoder / api.UhdrDecoder / api.is_uhdr_image — stable API
    mirroring ultrahdr_api.h
  - jpegr.JpegR — direct codec entry points (encode API-0..4/x, decode)
  - heifr.HeifR — gain-map HEIC/AVIF (own tmap container + libheif)
  - ultrahdr.UltraHdr — converter session (add_image/convert + effects)
  - ops.editor — crop/mirror/rotate/resize effects
  - parallel — batched multi-device sharding helpers
"""

from .api import UhdrDecoder, UhdrEncoder, is_uhdr_image  # noqa: F401
from .heifr import HeifR  # noqa: F401
from .jpegr import JpegR  # noqa: F401
from .types import (ColorGamut, ColorTransfer, CompressedImage,  # noqa: F401
                    GainMapMetadata, OutputFormat, PixelFormat, RawImage,
                    UhdrError)

__version__ = "0.1.0"
