"""HeifR: gain-map HEIC/AVIF encode/decode.

The reference implements this against a patched libheif fork exposing
gain-map items (/root/reference/lib/src/heifr.cpp:35-36, 141-410 —
heif_context_encode_gain_map_image and friends). The stock libheif in
this environment has no gain-map API, so the split here is:

  - pixel math (tone map, gain map generate/apply) — device, ops/gainmap,
    identical to the JPEG/R path;
  - coded images (HEVC/AV1) — system libheif via ctypes
    (container/libheif.py), one standalone encode per image;
  - the gain-map container — assembled/parsed directly
    (container/isobmff.py) in the reference fork's ISO 21496-1-style
    'tmap' layout, interoperable with
    /root/reference/tests/data/sample_heicr.heic;
  - metadata — fractional payload mirroring heifr.cpp:108-138.

When no libheif is present every entry point raises
UHDR_CODEC_UNSUPPORTED_FEATURE — never a silently gain-map-less file.
"""

from __future__ import annotations

import numpy as np

from .container import isobmff as iso
from .container import libheif as lh
from .ops import gainmap as gm
from .types import (ColorGamut, ColorTransfer, GainMapMetadata,
                    OutputFormat, PixelFormat, RawImage, err)

_CODED_TYPES = {"avif": "av01", "heic": "hvc1"}
_GAINMAP_QUALITY = 85  # matches kMapCompressQualityDefault usage

# Maximum coded-image dimension before the encoder splits into a HEIF
# 'grid' of tiles (the reference's libheif does the same for HEVC
# profile limits). Tests shrink this to exercise the tiling cheaply.
GRID_TILE_LIMIT = 4096


def heif_available() -> bool:
    return lh.available()


class HeifRDecodeResult:
    def __init__(self, width, height, image, metadata, gainmap,
                 base_yuv=None, exif=None):
        self.width = width
        self.height = height
        self.image = image
        self.metadata = metadata
        self.gainmap = gainmap
        # (y8, u8, v8) planes of the decoded base image — kept so
        # ingest paths don't pay a second HEVC/AV1 decode.
        self.base_yuv = base_yuv
        # EXIF blob from the container's Exif item (heifr.cpp:324-331).
        self.exif = exif


class HeifR:
    """Mirrors class HeifR (lib/include/ultrahdr/heifr.h:72-204):
    encode API-0/1/x and decode for HEIC_R / AVIF_R."""

    def __init__(self, codec: str = "heic"):
        if codec not in ("heic", "avif"):
            raise err("UHDR_CODEC_INVALID_PARAM",
                      f"unknown heif codec {codec}")
        self.codec = codec

    def _require_codec(self):
        if not lh.available():
            raise err(
                "UHDR_CODEC_UNSUPPORTED_FEATURE",
                f"{self.codec}-R needs the libheif shared library "
                "(HEVC/AV1 entropy layer); none is installed. The "
                "gain-map math itself is available via "
                "ops.gainmap.generate_gainmap/apply_gainmap.")

    # -- encode (heifr.cpp:141-299) ------------------------------------

    def encode_api0(self, p010: RawImage, hdr_tf: ColorTransfer,
                    quality: int = 95,
                    exif: bytes | None = None) -> bytes:
        """Tone map + gain map on device, then assemble base +
        gain-map HEIF with ISO 21496-1-style metadata."""
        self._require_codec()
        y8, u8, v8 = gm.tonemap_p010(p010.planes["y"], p010.planes["uv"])
        gmap, metadata = gm.generate_gainmap(
            y8, u8, v8, p010.planes["y"], p010.planes["uv"],
            sdr_gamut=p010.gamut.value, hdr_gamut=p010.gamut.value,
            hdr_tf=hdr_tf.value)
        return self._encode_gainmap_heif(
            np.asarray(y8), np.asarray(u8), np.asarray(v8),
            np.asarray(gmap), metadata, quality, exif)

    def encode_api1(self, p010: RawImage, yuv420: RawImage,
                    hdr_tf: ColorTransfer, quality: int = 95,
                    exif: bytes | None = None) -> bytes:
        self._require_codec()
        gmap, metadata = gm.generate_gainmap(
            np.asarray(yuv420.planes["y"]), np.asarray(yuv420.planes["u"]),
            np.asarray(yuv420.planes["v"]), p010.planes["y"],
            p010.planes["uv"], sdr_gamut=yuv420.gamut.value,
            hdr_gamut=p010.gamut.value, hdr_tf=hdr_tf.value)
        return self._encode_gainmap_heif(
            np.asarray(yuv420.planes["y"]), np.asarray(yuv420.planes["u"]),
            np.asarray(yuv420.planes["v"]), np.asarray(gmap), metadata,
            quality, exif)

    def encode_apix(self, yuv420: RawImage, gainmap_u8: np.ndarray,
                    metadata: GainMapMetadata,
                    quality: int = 95,
                    exif: bytes | None = None) -> bytes:
        """Transcode variant: provided SDR + gain map + metadata
        (heifr.cpp API-x)."""
        self._require_codec()
        return self._encode_gainmap_heif(
            np.asarray(yuv420.planes["y"]), np.asarray(yuv420.planes["u"]),
            np.asarray(yuv420.planes["v"]), np.asarray(gainmap_u8),
            metadata, quality, exif)

    def encode_sdr(self, yuv420: RawImage, quality: int = 95,
                   exif: bytes | None = None) -> bytes:
        """Plain 8-bit SDR HEIC/AVIF — no gain map
        (heifr.cpp:271-279 "only encode heif", reached from
        ultrahdr.cpp:1181-1206 ULTRAHDR_CODEC_HEIC/AVIF)."""
        self._require_codec()
        planes = (np.asarray(yuv420.planes["y"], np.uint8),
                  np.asarray(yuv420.planes["u"], np.uint8),
                  np.asarray(yuv420.planes["v"], np.uint8))
        return lh.encode_image(planes, self.codec, quality, exif=exif)

    def _encode_image_items(self, planes, quality: int) -> list:
        """Encode planes into OutItems: a single coded item when the
        image fits HEVC/AV1 profile limits, else a 'grid' of coded
        tiles (grid root at index 0, tiles hidden) so >4K dimensions
        encode — the reference gets this transparently from libheif."""
        h, w = planes[0].shape
        limit = GRID_TILE_LIMIT
        if w <= limit and h <= limit:
            f = lh.encode_image(planes, self.codec, quality)
            p = iso.parse_heif(f)
            return iso.extract_image_items(f, p, p.primary or 1)
        import math

        cols = math.ceil(w / limit)
        rows = math.ceil(h / limit)
        tile_w = math.ceil(w / cols)
        tile_h = math.ceil(h / rows)
        tile_w += tile_w % 2  # 4:2:0 chroma needs even tile dims
        tile_h += tile_h % 2
        mono = len(planes) == 1
        # Edge-replicate to the full tile lattice; the grid's ispe
        # crops back to (w, h) at decode.
        full_w, full_h = cols * tile_w, rows * tile_h

        def padded(p, sub):
            ph, pw = (h + sub - 1) // sub, (w + sub - 1) // sub
            fh, fw = full_h // sub, full_w // sub
            return np.pad(np.asarray(p, np.uint8)[:ph, :pw],
                          ((0, fh - ph), (0, fw - pw)), mode="edge")

        yp = padded(planes[0], 1)
        if not mono:
            up, vp = padded(planes[1], 2), padded(planes[2], 2)
        items = [iso.OutItem("grid",
                             iso.grid_payload(rows, cols, w, h),
                             [iso.ispe_prop(w, h),
                              iso.pixi_prop(1 if mono else 3)])]

        def tile_planes(r, c):
            ys, xs = r * tile_h, c * tile_w
            tp = [yp[ys:ys + tile_h, xs:xs + tile_w]]
            if not mono:
                tp += [up[ys // 2:(ys + tile_h) // 2,
                          xs // 2:(xs + tile_w) // 2],
                       vp[ys // 2:(ys + tile_h) // 2,
                          xs // 2:(xs + tile_w) // 2]]
            return tuple(tp)

        # Tiles encode concurrently: each lh.encode_image call is an
        # independent libheif context and ctypes releases the GIL for
        # the duration of the HEVC/AV1 encode, so multi-core hosts get
        # real tile parallelism (the reference's libheif does the same
        # internally; JobQueue caps at min(cores, 4) — ultrahdr.cpp).
        # Assembly below stays in tile order, so output is
        # deterministic regardless of completion order.
        import os
        from concurrent.futures import ThreadPoolExecutor

        ntiles = rows * cols
        workers = max(1, min(os.cpu_count() or 1, ntiles, 4))
        with ThreadPoolExecutor(workers) as pool:
            coded = list(pool.map(
                lambda rc: lh.encode_image(tile_planes(*rc),
                                           self.codec, quality),
                [(r, c) for r in range(rows) for c in range(cols)]))

        tile_roots = []
        for f in coded:
            hp = iso.parse_heif(f)
            titems = iso.extract_image_items(f, hp, hp.primary or 1)
            off = len(items)
            tile_roots.append(off + 1)
            for j, it in enumerate(titems):
                items.append(iso.OutItem(
                    it.item_type, it.payload, it.props, it.name,
                    True if j == 0 else it.hidden,
                    [t + off for t in it.dimg]))
        items[0].dimg = tile_roots
        return items

    def _encode_gainmap_heif(self, y8, u8, v8, gmap,
                             metadata: GainMapMetadata,
                             quality: int,
                             exif: bytes | None = None) -> bytes:
        base_items = self._encode_image_items((y8, u8, v8), quality)
        gm_items = self._encode_image_items((gmap,), _GAINMAP_QUALITY)
        return iso.build_tmap_container(
            self.codec, base_items, gm_items,
            iso.encode_tmap_metadata(metadata), exif=exif)

    # -- decode (heifr.cpp:302-410) ------------------------------------

    def decode(self, data: bytes,
               output_format: OutputFormat = OutputFormat.HDR_LINEAR,
               max_display_boost: float = float("inf"),
               ) -> HeifRDecodeResult:
        """Split the gain-map container, decode base + gain map via
        libheif, reconstruct on device."""
        self._require_codec()
        if max_display_boost < 1.0:
            raise err("UHDR_CODEC_INVALID_PARAM",
                      f"bad max_display_boost {max_display_boost}")
        hp = iso.parse_heif(data)
        tmap_ids = [i for i, it in hp.items.items()
                    if it.item_type == "tmap"]
        if not tmap_ids:
            raise err("UHDR_CODEC_ERROR",
                      "no gain-map (tmap) item in HEIF container")
        tmap = tmap_ids[0]
        refs = hp.refs.get(("dimg", tmap))
        if not refs or len(refs) < 2:
            raise err("UHDR_CODEC_ERROR", "tmap item lacks dimg refs")
        base_id, gm_id = refs[0], refs[1]
        metadata = iso.decode_tmap_metadata(
            iso.item_payload(data, hp, tmap))
        exif = iso.find_exif(data, hp, base_id)

        root_type = hp.items[base_id].item_type
        if root_type == "grid":
            kids = hp.refs.get(("dimg", base_id), [])
            root_type = hp.items[kids[0]].item_type if kids else "hvc1"
        codec = "avif" if root_type == "av01" else "heic"

        def rebuild(item_id):
            return iso.build_image_subtree(
                codec, iso.extract_image_items(data, hp, item_id))

        y8, u8, v8 = lh.decode_primary(rebuild(base_id),
                                       monochrome=False)
        gmap, = lh.decode_primary(rebuild(gm_id), monochrome=True)

        h, w = y8.shape
        if output_format == OutputFormat.SDR:
            rgba = gm.yuv420_to_rgba8888(y8, u8, v8)
            image = RawImage(fmt=PixelFormat.RGBA8888, width=w, height=h,
                             gamut=ColorGamut.UNSPECIFIED,
                             planes={"rgba": rgba})
            return HeifRDecodeResult(w, h, image, metadata, gmap,
                                     (y8, u8, v8), exif)

        out = gm.apply_gainmap(y8, u8, v8, gmap, metadata,
                               output_format.value, max_display_boost)
        from .jpegr import _OUT_PIXEL_FMT, _OUT_TRANSFER

        image = RawImage(fmt=_OUT_PIXEL_FMT[output_format], width=w,
                         height=h, gamut=ColorGamut.UNSPECIFIED,
                         transfer=_OUT_TRANSFER[output_format],
                         planes={"rgba": out})
        return HeifRDecodeResult(w, h, image, metadata, gmap,
                                 (y8, u8, v8), exif)
