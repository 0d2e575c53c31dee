"""Batched multi-device throughput: shard independent images across a
device mesh.

The reference's only parallelism is a row-band thread pool inside one
image (/root/reference/lib/src/ultrahdr.cpp:131-183). Here the
within-image parallelism comes from XLA's grid; scaling comes from
batching independent images and sharding the batch axis across the
mesh — images are independent so no collectives run inside a frame
(SURVEY.md "Distributed communication backend").

All batched kernels take stacked planes (N, H, W)/(N, H/2, W) and jit
with batch-sharded in/out shardings; per-image host entropy coding
overlaps with device compute in the pipelined encoder.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import color, gainmap as gm
from ..jpeg import tables
from ..jpeg import dct as dct_mod
from ..types import GainMapMetadata, MAP_COMPRESS_QUALITY
from ..utils import counters


def default_mesh(devices=None) -> Mesh:
    """1-D data mesh over all local devices (batch axis 'batch')."""
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), axis_names=("batch",))


@lru_cache(maxsize=1)
def single_device_mesh() -> Mesh:
    """Mesh over the first local device (single-image fast paths)."""
    return Mesh(np.asarray(jax.devices()[:1]), axis_names=("batch",))


def _batch_sharding(mesh: Mesh):
    return NamedSharding(mesh, P("batch"))


def pack_p010_host(plane_u16: np.ndarray):
    """Host-side 10-bit packing of P010 samples for upload: ships
    1.25 B/sample (hi8 + 4x2-bit tail bytes) instead of the 2 B/sample
    u16 layout. Last dim must be a multiple of 4."""
    v = (np.asarray(plane_u16) >> 6).astype(np.uint16)
    hi = (v >> 2).astype(np.uint8)
    lo = (v & 3).astype(np.uint8)
    lo4 = lo.reshape(*lo.shape[:-1], lo.shape[-1] // 4, 4)
    lob = (lo4[..., 0] | (lo4[..., 1] << 2) | (lo4[..., 2] << 4)
           | (lo4[..., 3] << 6))
    return hi, np.ascontiguousarray(lob)


def _unpack_p010_device(hi, lob):
    """Traceable inverse of pack_p010_host -> u16 P010 samples."""
    lo4 = jnp.stack([(lob >> 0) & 3, (lob >> 2) & 3, (lob >> 4) & 3,
                     (lob >> 6) & 3], axis=-1)
    lo = lo4.reshape(hi.shape)
    v = (hi.astype(jnp.uint16) << 2) | lo.astype(jnp.uint16)
    return v << 6


@lru_cache(maxsize=None)
def _split_p010_stack_fn(n: int, h: int, w: int):
    """Jitted slice of the tall unpacked plane into MSB-aligned
    (n,h,w) y and (n,h/2,w) uv batches."""

    @jax.jit
    def split(big):
        y = (big[:n * h].reshape(n, h, w).astype(jnp.uint16)) << 6
        uv = (big[n * h:].reshape(n, h // 2, w)
              .astype(jnp.uint16)) << 6
        return y, uv

    return split


def pack_p010_batch_host(p010_y_batch, p010_uv_batch):
    """Host half of the segment-packed upload: stack every frame's y
    and uv planes into ONE tall 10-bit plane and pack it
    (parallel/packio.py). Runs pure numpy — callers can overlap it
    with the previous batch's device work in a thread. Falls back to
    the dense 10-bit layout when the content doesn't compress (noise)
    or the geometry doesn't fit the packer's 32-row groups."""
    from . import packio

    y = np.asarray(p010_y_batch)
    uv = np.asarray(p010_uv_batch)
    n, h, w = y.shape
    dense_bytes = (y.size + uv.size) * 10 // 8
    if h % 64 == 0 and w % 16 == 0:
        big = np.concatenate([(y >> 6).reshape(n * h, w),
                              (uv >> 6).reshape(n * (h // 2), w)])
        packed = packio.pack_plane_host(big)
        if packed.nbytes() < 0.9 * dense_bytes:
            return ("seg", packed, packed.to_blob(), n, h, w)
    return ("dense", pack_p010_host(y), pack_p010_host(uv), n, h, w)


def upload_p010_batch(p010_y_batch, p010_uv_batch, stats=None,
                      prepacked=None):
    """Upload a P010 batch: ONE u32 blob over the link, reconstructed
    on device (~10 ms for a 4-frame 4K batch). Returns
    (y_dev_msb, uv_dev_msb, h2d_bytes)."""
    from . import packio

    pre = prepacked if prepacked is not None else \
        pack_p010_batch_host(p010_y_batch, p010_uv_batch)
    import os as _os
    import time as _time

    t_up0 = _time.perf_counter()
    if pre[0] == "seg":
        _, packed, blob, n, h, w = pre
        blob_dev = jax.device_put(blob)
        if _os.environ.get("UHDR_FETCH_SYNC_STAGES") == "1":
            # Diagnostic mode: sync so h2d_ms is the true transfer
            # time, not just the enqueue (costs one extra round trip).
            blob_dev.block_until_ready()
        bigdev = packio.unpack_plane_device(packed, blob_dev)
        ydev, uvdev = _split_p010_stack_fn(n, h, w)(bigdev)
        nbytes = blob.nbytes
        mode = "seg"
    else:
        _, (yh, yl), (uh, ul), n, h, w = pre
        nbytes = yh.nbytes + yl.nbytes + uh.nbytes + ul.nbytes
        parts = [jax.device_put(p) for p in (yh, yl, uh, ul)]

        @jax.jit
        def dense(yh, yl, uh, ul):
            return (_unpack_p010_device(yh, yl),
                    _unpack_p010_device(uh, ul))

        ydev, uvdev = dense(*parts)
        mode = "dense"
    if stats is not None:
        stats["h2d_bytes"] = stats.get("h2d_bytes", 0) + nbytes
        stats["h2d_pack"] = mode
        stats["h2d_ms"] = stats.get("h2d_ms", 0.0) + round(
            (_time.perf_counter() - t_up0) * 1e3, 1)
    return ydev, uvdev, nbytes


def fetch_1010102_packed(out_dev, stats=None):
    """Fetch a device-resident (n,h,w) RGBA1010102 batch to host
    through a lossless pack: RCT + per-segment Rice(k)
    (packio.fetch_rgba1010102_rice, ~29% fewer bytes than the
    fine-width scheme on decoded bench content) when the native
    single-pass unpacker is available, else RCT + fine-width
    (packio.fetch_rgba1010102_batch); raw u32 readback as the
    incompressible-content fallback. Two d2h transfers total (per-
    segment map + fused bucket blob) and no index upload. Alpha is
    the packer's constant 0xC0000000 (ops/color.py
    pack_rgba1010102)."""
    from . import packio
    from ..jpeg import native

    out = None
    wasted = 0
    lib = native.get_lib()
    # Auto-pick between MED prediction (~14% fewer bytes than
    # vertical Rice on decoded content) and vertical deltas, per
    # batch, from exact packed-size estimates (packio
    # _fetch_rice_core med="auto"; MED needs the native sequential
    # reconstruction, so without it the pick is vertical-only).
    mode = "rct-rice-auto"
    # Without the native unpacker the Rice host half costs seconds
    # per 4K batch on this single core — only the fine path then.
    if lib is not None and getattr(lib, "uhdr_rice_unpack", None):
        out, d2h_bytes = packio.fetch_rgba1010102_auto(out_dev)
        if out is not None and packio.LAST_PICK:
            mode = f"rct-rice-auto({packio.LAST_PICK})"
        if out is None:
            wasted += d2h_bytes
    if out is None:
        mode = "rct-seg"
        out, d2h_bytes = packio.fetch_rgba1010102_batch(out_dev)
        if out is None:
            wasted += d2h_bytes
    if out is None:  # incompressible content: raw fetch wins
        counters.bump("readback_raw_incompressible")
        arr = np.asarray(out_dev)
        if stats is not None:
            # `wasted` carries the per-segment maps that already
            # crossed the link before the bailouts — keep the JSON
            # auditable.
            stats["d2h_bytes"] = stats.get("d2h_bytes", 0) \
                + arr.nbytes + wasted
            stats["d2h_pack"] = "raw"
        return arr
    if stats is not None:
        # What crossed the link: the fused bucket blob + the pass-1
        # per-segment map (the bucket plan stays host-side).
        stats["d2h_bytes"] = stats.get("d2h_bytes", 0) \
            + d2h_bytes + wasted
        stats["d2h_pack"] = mode
        stats["d2h_stages"] = dict(packio.LAST_FETCH_STAGES)
    return out


def fetch_f16_packed(out_dev, stats=None):
    """Fetch a device-resident (n,h,w,4) RGBA-F16-halves batch (the
    reference's DEFAULT decode output, ultrahdr_api.cpp:1287-1289) to
    host through the lossless RCT + Rice bit-pattern pack
    (packio.fetch_rgba_f16_rice); raw u16 readback as the
    incompressible-content fallback. A raw 4K F16 batch is ~100 MB
    per frame on the wire — the pack typically cuts that 3-5x on
    decoded content. Alpha is the packer's constant 0x3C00
    (ops/color.py pack_rgba_f16)."""
    from . import packio
    from ..jpeg import native

    out = None
    wasted = 0
    lib = native.get_lib()
    mode = "rct-rice16-auto"
    # Without the native unpacker the host half costs seconds per 4K
    # batch on a single core — raw fetch then.
    if lib is not None and getattr(lib, "uhdr_rice16_unpack", None):
        out, d2h_bytes = packio.fetch_rgba_f16_auto(out_dev)
        if out is not None and packio.LAST_PICK:
            mode = f"rct-rice16-auto({packio.LAST_PICK})"
        if out is None:
            wasted += d2h_bytes
            counters.bump("readback_raw_incompressible")
    if out is None:  # incompressible content / no native lib
        arr = np.asarray(out_dev)
        if stats is not None:
            stats["d2h_bytes"] = stats.get("d2h_bytes", 0) \
                + arr.nbytes + wasted
            stats["d2h_pack"] = "raw"
        return arr
    if stats is not None:
        stats["d2h_bytes"] = stats.get("d2h_bytes", 0) \
            + d2h_bytes + wasted
        stats["d2h_pack"] = mode
        stats["d2h_stages"] = dict(packio.LAST_FETCH_STAGES)
    return out


def fetch_pixels_packed(arr, stats=None, fmt=None):
    """Materialize a decode output to host, riding the lossless packed
    readback when the caller names a packable format: fmt
    "rgba1010102" (or PixelFormat.RGBA1010102) -> the u32 Rice pack;
    fmt "rgba_f16" -> the u16x4 bit-pattern Rice pack. Single images
    ride the batch packers with a unit batch axis. With fmt=None (or
    any other format, e.g. SDR RGBA8888 whose dtype/shape are
    indistinguishable from 1010102) this is a raw np.asarray — the
    packers drop alpha and re-attach a format-specific constant, so
    routing on dtype alone would silently corrupt look-alike layouts.
    The convenience entry the CLI and other single-frame consumers use
    — a raw 4K F16 fetch is ~100 MB; packed is typically 3-8x
    smaller."""
    import numpy as _np

    name = getattr(fmt, "value", fmt)
    if name == "rgbaf16":          # PixelFormat.RGBA_F16 spelling
        name = "rgba_f16"
    if isinstance(arr, _np.ndarray):
        # Already host-resident: nothing crosses the link.
        if stats is not None:
            stats.setdefault("d2h_bytes", 0)
            stats["d2h_pack"] = "host"
        return arr
    shape = tuple(int(s) for s in arr.shape)
    if (name == "rgba1010102" and arr.dtype == jnp.uint32
            and len(shape) in (2, 3)):
        batched = arr if len(shape) == 3 else arr[None]
        out = fetch_1010102_packed(batched, stats)
        return out if len(shape) == 3 else out[0]
    if (name == "rgba_f16" and arr.dtype == jnp.uint16
            and len(shape) in (3, 4) and shape[-1] == 4):
        batched = arr if len(shape) == 4 else arr[None]
        out = fetch_f16_packed(batched, stats)
        return out if len(shape) == 4 else out[0]
    out = _np.asarray(arr)
    if stats is not None:
        stats["d2h_bytes"] = stats.get("d2h_bytes", 0) + out.nbytes
        stats["d2h_pack"] = "raw"
    return out


_HOSTAPPLY_MODES = {"hdr_linear": 0, "hdr_hlg": 1, "hdr_pq": 2}


def hostapply_available(output_format: str) -> bool:
    """True when the planes-readback + native-apply decode path can
    serve this output format on this host."""
    from ..jpeg import native

    lib = native.get_lib()
    return (output_format in _HOSTAPPLY_MODES and lib is not None
            and getattr(lib, "uhdr_apply_gainmap", None) is not None)


def apply_planes_host(comp, scalars, h, w, gh, gw, output_format: str,
                      stats=None):
    """Native gain-map apply over a fetched (n, rows, wc) u8 planes
    composite (jpeg/native/apply.cpp): returns the decoded batch as
    (n, h, w, 4) u16 RGBA halves for hdr_linear or (n, h, w) u32
    RGBA1010102 for hdr_hlg / hdr_pq. `scalars` is the (n, 4) f32
    [log2_min, log2_max, boost_factor, display_boost] block
    (_decode_scalars). Output agrees with the device apply kernel to
    <=1 F16 ULP / <=1 ten-bit code (tests/test_hostapply.py)."""
    import ctypes
    import time as _time

    from . import packio
    from ..jpeg import native

    lib = native.get_lib()
    mode = _HOSTAPPLY_MODES[output_format]
    n = comp.shape[0]
    stride = comp.shape[-1]
    ch, cw = (h + 1) // 2, (w + 1) // 2
    scale = w // gw
    # The native kernel reads h luma rows, (h+1)//2 chroma rows and gh
    # gain-map rows of u8 from each frame's composite; check that they
    # are there before handing it the pointer.
    if comp.dtype != np.uint8 or comp.ndim != 3:
        raise ValueError(f"planes composite must be (n, rows, cols) "
                         f"uint8, got {comp.dtype} {comp.shape}")
    if comp.shape[-2] < h + ch + gh or stride < max(w, 2 * cw, gw):
        raise ValueError(f"planes composite {comp.shape} too small for "
                         f"{w}x{h} with a {gw}x{gh} gain map")
    if scalars.shape != (n, 4):
        raise ValueError(f"scalars must be ({n}, 4), got "
                         f"{scalars.shape}")
    comp = np.ascontiguousarray(comp)
    sc = np.ascontiguousarray(scalars.astype(np.float32))
    if mode == 0:
        out = np.empty((n, h, w, 4), np.uint16)
    else:
        out = np.empty((n, h, w), np.uint32)
    nt = packio._unpack_threads()
    t0 = _time.perf_counter()
    for i in range(n):
        rc = lib.uhdr_apply_gainmap(
            comp[i].ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            stride, h, w, ch, cw, gh, gw, scale,
            float(sc[i, 0]), float(sc[i, 1]), float(sc[i, 2]),
            float(sc[i, 3]), mode,
            ctypes.c_void_p(out[i].ctypes.data), nt)
        if rc != 0:
            raise RuntimeError(f"uhdr_apply_gainmap rc={rc}")
    if stats is not None:
        stats["host_apply_ms"] = round(
            (_time.perf_counter() - t0) * 1e3, 1)
    return out


def fetch_planes(comp_dev, stats=None):
    """Fetch a device (n, rows, cols) u8 planes composite to host
    through the planar Rice pack, or raw when the content does not
    compress."""
    from . import packio

    comp, nbytes = packio.fetch_planes_u8(comp_dev)
    pack = f"planes-rice-auto({packio.LAST_PICK})"
    if comp is None:
        counters.bump("readback_raw_incompressible")
        comp = np.asarray(comp_dev)
        nbytes = comp.nbytes
        pack = "planes-raw"
    if stats is not None:
        stats["d2h_bytes"] = stats.get("d2h_bytes", 0) + int(nbytes)
        stats["d2h_pack"] = pack
        stats["d2h_stages"] = dict(packio.LAST_FETCH_STAGES)
    return comp


def decode_batch_hostapply(blobs, output_format: str,
                           max_display_boost: float, mesh: Mesh,
                           stats=None, handoff=None):
    """Decode a batch ALL THE WAY to host pixels via the planes
    readback: device does entropy decode + IDCT and emits the integer
    (Y, U, V, gain map) composite; the link carries the Rice-packed
    composite (~2-4x fewer bytes than packing the output pixels); the
    host applies the gain map natively. Pass `handoff` (a
    DeviceEncodedBatch) to decode straight off encoder-resident
    streams instead of blobs. Returns the decoded host batch, or None
    when the path doesn't apply (foreign/mixed streams, no native
    lib, unsupported format) — callers fall back to the classic
    device-apply + packed-pixel-fetch path.

    Reference role: the decode half of the serving loop; the
    reference's equivalent is its in-process zero-copy decode
    (/root/reference/lib/src/jpegr.cpp:656-812), whose 'fetch' is
    free — this path moves ~4-7 MB/frame to the host instead of
    13-28 MB."""
    if not hostapply_available(output_format):
        return None
    if handoff is not None:
        comp_dev = batched_decode_from_handoff(
            handoff, "planes", max_display_boost, mesh, False, stats)
        if comp_dev is None:
            return None
        sc = handoff_apply_scalars(handoff, max_display_boost)
        n = int(comp_dev.shape[0])
        scalars = np.broadcast_to(sc, (n, 4))
        w, h = handoff.width, handoff.height
        gw, gh = w // 4, h // 4
    else:
        meta = {}
        comp_dev = _batched_decode_device(
            blobs, "planes", max_display_boost, mesh, False, stats,
            meta_out=meta)
        if comp_dev is None:
            return None
        w, h, gw, gh = meta["w"], meta["h"], meta["gw"], meta["gh"]
        scalars = meta["scalars"]
    comp = fetch_planes(comp_dev, stats)
    return apply_planes_host(comp, scalars, h, w, gh, gw,
                             output_format, stats)


@lru_cache(maxsize=None)
def _batched_encode_compute(mesh: Mesh, gamut: str, hdr_tf: str,
                            base_quality: int):
    """Fused per-batch encode device stage: tonemap + gain map +
    BT.601 conversion + fDCT/quant of all three base planes and the
    gain map. One jit over the mesh; batch axis sharded."""
    hdr_white = color.hdr_inv_oetf_fn(hdr_tf)[1]
    max_boost = hdr_white / color.SDR_WHITE_NITS
    spec = _batch_sharding(mesh)

    @partial(jax.jit, in_shardings=(spec, spec),
             out_shardings=(spec, spec, spec, spec))
    def kernel(p010_y_batch, p010_uv_batch):
        return jax.vmap(
            lambda y, uv: _encode_one_image_coefs(y, uv, gamut, hdr_tf,
                                                  base_quality)
        )(p010_y_batch, p010_uv_batch)

    return kernel, max_boost


@lru_cache(maxsize=None)
def _batched_encode_to_streams(mesh: Mesh, gamut: str, hdr_tf: str,
                               base_quality: int, h: int, w: int):
    """Full device-side API-0 encode INCLUDING entropy coding: the only
    outputs are the entropy-coded bitstreams (worst-case-sized word
    buffers + actual bit counts), so the readback carries ~1-2 MB per
    4K frame instead of ~36 MB of coefficients."""
    from ..jpeg import device_entropy as de

    max_boost = color.hdr_inv_oetf_fn(hdr_tf)[1] / color.SDR_WHITE_NITS
    spec = _batch_sharding(mesh)
    mcus_x, mcus_y = w // 16, h // 16

    def streams_one(yz, uz, vz, gz):
        inter = de.interleave_blocks_device(yz, uz, vz, mcus_x, mcus_y)
        bw, bb = de.encode_yuv420_stream(inter)
        gw, gb = de.encode_gray_stream(gz)
        return bw, bb, gw, gb

    @partial(jax.jit, in_shardings=(spec, spec),
             out_shardings=(spec, spec, spec, spec))
    def kernel(p010_y_batch, p010_uv_batch):
        coefs = jax.vmap(
            lambda y, uv: _encode_one_image_coefs(y, uv, gamut, hdr_tf,
                                                  base_quality)
        )(p010_y_batch, p010_uv_batch)
        return jax.vmap(streams_one)(*coefs)

    return kernel, max_boost


RST_INTERVAL = 4  # MCUs per restart marker in the batched encoder

_COMPACT_ALIGN = 64  # words; base-stream placement granularity


def _compact_streams(gsw, gtotal, sw):
    """[gainmap | base] fetch buffer with the base stream placed just
    past the gain map's USED prefix (64-word aligned) instead of at
    its static worst-case capacity: the single d2h fetch then carries
    no dead gain-map region (~0.5-0.8 MB/4K frame). A
    dynamic_update_slice (one HBM copy) does the dynamic placement —
    cheaper than any gather. The host re-derives the per-frame base
    offset from gtotal (_assemble_rst_outputs)."""
    ws = sw.shape[0]
    gmt_pad = (gtotal.astype(jnp.int32) + (_COMPACT_ALIGN - 1)) \
        & ~jnp.int32(_COMPACT_ALIGN - 1)
    dst = jnp.pad(gsw, (0, ws + _COMPACT_ALIGN))
    return jax.lax.dynamic_update_slice(dst, sw, (gmt_pad,))


@lru_cache(maxsize=None)
def _batched_encode_to_streams_rst(mesh: Mesh, gamut: str, hdr_tf: str,
                                   base_quality: int, h: int, w: int,
                                   cap: int | None):
    """Scatter-free batched encode: base stream via the restart-marker
    parallel assembly (device_entropy.encode_yuv420_rst_stream), gain
    map via the (small) scatter path. Returns per image:
    (base_sorted_words, base_chunk_bits, base_total_words, overflow,
     gm_words, gm_bits)."""
    from ..jpeg import device_entropy as de

    max_boost = color.hdr_inv_oetf_fn(hdr_tf)[1] / color.SDR_WHITE_NITS
    spec = _batch_sharding(mesh)
    mcus_x, mcus_y = w // 16, h // 16

    def streams_one(yz, uz, vz, gz):
        inter = de.interleave_blocks_device(yz, uz, vz, mcus_x, mcus_y)
        sw, cbits, total, ovf = de.encode_yuv420_rst_stream(
            inter, RST_INTERVAL, cap)
        gsw, gcbits, gtotal, govf = de.encode_gray_rst_stream(
            gz, RST_INTERVAL, cap)
        # Everything the host needs in TWO arrays (each d2h transfer
        # has a fixed cost): a small metadata vector and one combined
        # [gainmap | base] stream buffer whose used prefix is read in a
        # single transfer.
        meta = jnp.concatenate([
            jnp.stack([(ovf | govf).astype(jnp.int32),
                       total.astype(jnp.int32),
                       gtotal.astype(jnp.int32),
                       jnp.int32(gsw.shape[0])]),
            gcbits.astype(jnp.int32),
            cbits.astype(jnp.int32)])
        return _compact_streams(gsw, gtotal, sw), meta

    @partial(jax.jit, in_shardings=(spec,) * 4,
             out_shardings=(spec,) * 2)
    def kernel(y_hi, y_lo, uv_hi, uv_lo):
        def one(yh, yl, uh, ul):
            y = _unpack_p010_device(yh, yl)
            uv = _unpack_p010_device(uh, ul)
            return _encode_one_image_coefs(y, uv, gamut, hdr_tf,
                                           base_quality)

        coefs = jax.vmap(one)(y_hi, y_lo, uv_hi, uv_lo)
        return jax.vmap(streams_one)(*coefs)

    @partial(jax.jit, in_shardings=(spec,) * 2,
             out_shardings=(spec,) * 2)
    def kernel_dev(y_batch, uv_batch):
        """Variant over device-resident MSB-aligned u16 P010 batches
        (the segment-packed upload path, upload_p010_batch)."""
        coefs = jax.vmap(
            lambda y, uv: _encode_one_image_coefs(y, uv, gamut, hdr_tf,
                                                  base_quality)
        )(y_batch, uv_batch)
        return jax.vmap(streams_one)(*coefs)

    kernel.device_input_variant = kernel_dev

    return kernel, max_boost


def _fdct_zigzag(plane_u8, q):
    """Traceable fDCT/quant of a u8 plane (pads to 8-multiples); the
    kron(D,D) bf16x3 formulation (jpeg/dct.py fdct_zigzag)."""
    hh, ww = plane_u8.shape
    ph, pw = (-hh) % 8, (-ww) % 8
    if ph or pw:
        plane_u8 = jnp.pad(plane_u8, ((0, ph), (0, pw)), mode="edge")
    q_zig = q.reshape(64)[tables.ZIGZAG]
    return dct_mod.fdct_zigzag(plane_u8, q_zig)


def _gainmap_and_coefs(y8, u8, v8, p010_y, p010_uv, sdr_gamut, hdr_gamut,
                       hdr_tf, base_quality, sdr_is_601=False):
    """Traceable device compute shared by API-0/1: gain map from an
    SDR/HDR pair + BT.601 conversion + fDCT/quant of everything."""
    hdr_inv_oetf, hdr_white = color.hdr_inv_oetf_fn(hdr_tf)
    luminance = color.luminance_fn(sdr_gamut)
    sdr_yuv_to_rgb = (color.p3_yuv_to_rgb if sdr_is_601
                      else color.yuv_to_rgb_fn(sdr_gamut))
    hdr_yuv_to_rgb = color.yuv_to_rgb_fn(hdr_gamut)
    gamut_m = color.hdr_gamut_conversion_matrix(sdr_gamut, hdr_gamut)
    max_boost = hdr_white / color.SDR_WHITE_NITS
    ql = tables.scale_quant_table(
        tables.STD_LUMINANCE_QUANT, base_quality).astype(np.float32)
    qc = tables.scale_quant_table(
        tables.STD_CHROMINANCE_QUANT, base_quality).astype(np.float32)
    qg = tables.scale_quant_table(
        tables.STD_LUMINANCE_QUANT,
        MAP_COMPRESS_QUALITY).astype(np.float32)

    sy, su, sv = gm.yuv420_to_float(y8, u8, v8)
    sy = gm._box_mean(sy, gm.SCALE)
    su = gm._box_mean(su, gm.SCALE // 2)
    sv = gm._box_mean(sv, gm.SCALE // 2)
    sdr_rgb = color.apply_channelwise(
        color.srgb_inv_oetf, sdr_yuv_to_rgb((sy, su, sv)))
    sdr_nits = luminance(sdr_rgb) * color.SDR_WHITE_NITS
    hy, hu, hv = gm.p010_to_float(p010_y, p010_uv)
    hy = gm._box_mean(hy, gm.SCALE)
    hu = gm._box_mean(hu, gm.SCALE // 2)
    hv = gm._box_mean(hv, gm.SCALE // 2)
    hdr_rgb = color.apply_channelwise(hdr_inv_oetf,
                                      hdr_yuv_to_rgb((hy, hu, hv)))
    if gamut_m is not None:
        hdr_rgb = color.apply_matrix3(gamut_m, hdr_rgb)
    hdr_nits = luminance(hdr_rgb) * hdr_white
    gmap = color.encode_gain(sdr_nits, hdr_nits, 1.0, max_boost)
    yb, ub, vb = gm.convert_yuv_encoding(y8, u8, v8, sdr_gamut, "p3")
    return (_fdct_zigzag(yb, ql), _fdct_zigzag(ub, qc),
            _fdct_zigzag(vb, qc), _fdct_zigzag(gmap, qg))


def _encode_one_image_coefs(p010_y, p010_uv, gamut, hdr_tf, base_quality):
    """Traceable single-image API-0 device compute (tonemap + gain map
    + 601 + fDCT/quant); shared by the coefficient and stream paths."""
    y8 = (p010_y >> 8).astype(jnp.uint8)
    u8 = (p010_uv[:, 0::2] >> 8).astype(jnp.uint8)
    v8 = (p010_uv[:, 1::2] >> 8).astype(jnp.uint8)
    return _gainmap_and_coefs(y8, u8, v8, p010_y, p010_uv, gamut, gamut,
                              hdr_tf, base_quality)


@lru_cache(maxsize=None)
def _batched_encode_api1_kernel(mesh: Mesh, sdr_gamut: str, hdr_gamut: str,
                                hdr_tf: str, base_quality: int, h: int,
                                w: int, cap: int | None):
    """API-1 (provided SDR + HDR pair) streams kernel, RST path."""
    from ..jpeg import device_entropy as de

    max_boost = color.hdr_inv_oetf_fn(hdr_tf)[1] / color.SDR_WHITE_NITS
    spec = _batch_sharding(mesh)
    mcus_x, mcus_y = w // 16, h // 16

    def one(y_hi, y_lo, uv_hi, uv_lo, y8, u8, v8):
        p010_y = _unpack_p010_device(y_hi, y_lo)
        p010_uv = _unpack_p010_device(uv_hi, uv_lo)
        yz, uz, vz, gz = _gainmap_and_coefs(
            y8, u8, v8, p010_y, p010_uv, sdr_gamut, hdr_gamut, hdr_tf,
            base_quality)
        inter = de.interleave_blocks_device(yz, uz, vz, mcus_x, mcus_y)
        sw, cbits, total, ovf = de.encode_yuv420_rst_stream(
            inter, RST_INTERVAL, cap)
        gsw, gcbits, gtotal, govf = de.encode_gray_rst_stream(
            gz, RST_INTERVAL, cap)
        meta = jnp.concatenate([
            jnp.stack([(ovf | govf).astype(jnp.int32),
                       total.astype(jnp.int32),
                       gtotal.astype(jnp.int32),
                       jnp.int32(gsw.shape[0])]),
            gcbits.astype(jnp.int32),
            cbits.astype(jnp.int32)])
        return _compact_streams(gsw, gtotal, sw), meta

    @partial(jax.jit, in_shardings=(spec,) * 7, out_shardings=(spec,) * 2)
    def kernel(yh, yl, uh, ul, y8, u8, v8):
        return jax.vmap(one)(yh, yl, uh, ul, y8, u8, v8)

    return kernel, max_boost


def batched_encode_api1(p010_y_batch, p010_uv_batch, sdr_y_batch,
                        sdr_u_batch, sdr_v_batch, mesh: Mesh,
                        sdr_gamut: str = "bt709",
                        hdr_gamut: str = "bt2100", hdr_tf: str = "hlg",
                        quality: int = 95) -> list[bytes]:
    """Batched API-1 encode (raw HDR + raw SDR), fully on device."""
    from ..container import icc as icc_mod, mux
    from ..jpeg import codec, device_entropy as de

    n, h, w = p010_y_batch.shape
    if h % 16 or w % 16:
        raise ValueError(f"batched encode requires 16-aligned dims, "
                         f"got {w}x{h}")
    metadata = None
    yh, yl = pack_p010_host(p010_y_batch)
    uh, ul = pack_p010_host(p010_uv_batch)
    sdr = (jnp.asarray(sdr_y_batch), jnp.asarray(sdr_u_batch),
           jnp.asarray(sdr_v_batch))
    # Tight sort cap first; dense content retries at full width (still
    # scatter-free, ~2x slower sort).
    from ..jpeg.device_entropy import DEFAULT_CHUNK_CAP

    for cap in (DEFAULT_CHUNK_CAP, None):
        kernel, max_boost = _batched_encode_api1_kernel(
            mesh, sdr_gamut, hdr_gamut, hdr_tf, int(quality), h, w, cap)
        metadata = GainMapMetadata(
            max_content_boost=max_boost, min_content_boost=1.0,
            hdr_capacity_min=1.0, hdr_capacity_max=max_boost)
        combined, meta = kernel(yh, yl, uh, ul, *sdr)
        try:
            return _assemble_rst_outputs(combined, np.asarray(meta), n,
                                         h, w, quality, sdr_gamut,
                                         metadata)
        except OverflowError:
            if cap is None:
                raise
    raise AssertionError("unreachable")


def _rst_chunk_geometry(h: int, w: int) -> tuple[int, int]:
    """Per-frame chunk counts of the RST-batched encode layout — the
    base stream's (nc) and the gain map's (ncg) — shared by the blob
    assembly and the device-handoff construction so the meta-row
    slicing can never drift between them (ADVICE r4)."""
    nc = -(-((w // 16) * (h // 16)) // RST_INTERVAL)
    gbh, gbw = -(-(h // 4) // 8), -(-(w // 4) // 8)
    ncg = -(-(gbh * gbw) // RST_INTERVAL)
    return nc, ncg


def _base_word_offsets(gm_totals):
    """Per-frame base-stream word offsets in the compacted
    [gainmap | base] layout (_compact_streams): the base starts just
    past the gain map's used prefix, _COMPACT_ALIGN-word aligned."""
    return ((gm_totals + _COMPACT_ALIGN - 1)
            // _COMPACT_ALIGN * _COMPACT_ALIGN)


def _assemble_rst_outputs(combined, meta, n, h, w, quality, gamut,
                          metadata, stats=None):
    """Host tail shared by the batched RST encode paths."""
    from ..container import icc as icc_mod, mux
    from ..jpeg import codec, device_entropy as de

    nc, ncg = _rst_chunk_geometry(h, w)
    if bool(np.any(meta[:, 0])):
        raise OverflowError("dense-content overflow")  # caller fallback
    totals = meta[:, 1]
    gm_totals = meta[:, 2]
    # Per-frame base-stream offset: the compacted layout
    # (_compact_streams) parks the base right past the gain map's used
    # prefix, 64-word aligned (meta[0, 3] keeps the static gain-map
    # capacity for reference/debug only).
    base_off = _base_word_offsets(gm_totals)
    gm_cbits = meta[:, 4:4 + ncg]
    base_cbits = meta[:, 4 + ncg:4 + ncg + nc]

    icc = icc_mod.write_icc_profile("srgb", gamut)
    base_hdr = codec.yuv420_jpeg_headers(
        w, h, quality, icc=icc, restart_interval=RST_INTERVAL)
    gm_hdr = codec.gray_jpeg_headers(w // 4, h // 4,
                                     MAP_COMPRESS_QUALITY,
                                     restart_interval=RST_INTERVAL)
    # 16Ki-word (64 KiB) fetch granularity: coarse enough to bound the
    # compiled slice-variant count, fine enough that rounding waste is
    # ~32 KiB/frame (it was 256 KiB granularity over a worst-case
    # layout before the compaction above).
    gran = 16 * 1024
    k = -(-int(max(base_off + totals)) // gran) * gran
    k = min(k, combined.shape[1])
    rows = {}
    for shard in combined.addressable_shards:
        lo = shard.index[0].start or 0
        data = np.asarray(shard.data[:, :k])
        if stats is not None:
            stats["d2h_bytes"] = stats.get("d2h_bytes", 0) + data.nbytes
        for j in range(data.shape[0]):
            rows[lo + j] = data[j]
    out = []
    for i in range(n):
        gs = de.finalize_rst_stream(rows[i][:int(gm_totals[i])],
                                    gm_cbits[i], RST_INTERVAL)
        bs = de.finalize_rst_stream(
            rows[i][int(base_off[i]):int(base_off[i]) + int(totals[i])],
            base_cbits[i], RST_INTERVAL)
        out.append(mux.append_gainmap(base_hdr + bs + b"\xff\xd9",
                                      gm_hdr + gs + b"\xff\xd9",
                                      metadata))
    return out


def batched_encode_device_stage(p010_y_batch, p010_uv_batch, mesh: Mesh,
                                gamut: str = "bt2100", hdr_tf: str = "hlg",
                                base_quality: int = 95):
    """Run the device portion of API-0 encode for a batch of same-size
    P010 images: returns per-image zigzag coefficient arrays
    (y, u, v, gainmap) and the shared metadata. Host entropy coding
    consumes these per image."""
    kernel, max_boost = _batched_encode_compute(mesh, gamut, hdr_tf,
                                                int(base_quality))
    yz, uz, vz, gz = kernel(jnp.asarray(p010_y_batch),
                            jnp.asarray(p010_uv_batch))
    metadata = GainMapMetadata(
        max_content_boost=max_boost, min_content_boost=1.0,
        hdr_capacity_min=1.0, hdr_capacity_max=max_boost)
    return (yz, uz, vz, gz), metadata


def batched_encode_api0(p010_y_batch, p010_uv_batch, mesh: Mesh,
                        gamut: str = "bt2100", hdr_tf: str = "hlg",
                        quality: int = 95, device_input=None,
                        stats=None, return_handoff: bool = False):
    """Full batched API-0 encode: device compute (entropy coding
    included) in one sharded jit, then host marker/mux assembly. Dims
    must be multiples of 16 and the batch must divide the mesh's batch
    axis (pad to a bucket for mixed sizes).

    device_input: optional (y_dev, uv_dev) MSB-aligned u16 device
    batches from upload_p010_batch — skips the dense host pack and
    rides the segment-packed upload (pass the host batches too for
    the rare scatter fallback).

    return_handoff: also return a DeviceEncodedBatch handle (or None
    on the rare scatter fallback) so a same-process batched_decode can
    consume the encoder's device-resident entropy streams directly —
    the analog of the reference's zero-copy in-process encode->
    decode handoff (/root/reference/lib/src/jpegr.cpp:167-247), which
    never re-parses its own in-memory buffers either. Saves the whole
    decode-side h2d upload (~1.8 MB/4K frame) plus the host
    destuff/boundary-scan prep."""
    from ..container import icc as icc_mod, mux
    from ..jpeg import codec, device_entropy as de

    if device_input is not None:
        n, h, w = (int(s) for s in device_input[0].shape)
    else:
        n, h, w = p010_y_batch.shape
    if h % 16 or w % 16:
        raise ValueError(f"batched encode requires 16-aligned dims, "
                         f"got {w}x{h}")
    from ..jpeg.device_entropy import DEFAULT_CHUNK_CAP

    if device_input is None:
        yh, yl = pack_p010_host(p010_y_batch)
        uh, ul = pack_p010_host(p010_uv_batch)
        if stats is not None:
            stats["h2d_bytes"] = stats.get("h2d_bytes", 0) + (
                yh.nbytes + yl.nbytes + uh.nbytes + ul.nbytes)
            stats["h2d_pack"] = "dense"
    metadata = None
    # Tight sort cap first; dense content retries at full width (still
    # scatter-free), then the exact scatter path as a last resort.
    for cap in (DEFAULT_CHUNK_CAP, None):
        kernel, max_boost = _batched_encode_to_streams_rst(
            mesh, gamut, hdr_tf, int(quality), h, w, cap)
        metadata = GainMapMetadata(
            max_content_boost=max_boost, min_content_boost=1.0,
            hdr_capacity_min=1.0, hdr_capacity_max=max_boost)
        if device_input is not None:
            combined, meta = kernel.device_input_variant(*device_input)
        else:
            combined, meta = kernel(yh, yl, uh, ul)
        meta_np = np.asarray(meta)
        try:
            out = _assemble_rst_outputs(combined, meta_np, n, h, w,
                                        quality, gamut, metadata,
                                        stats=stats)
        except OverflowError:
            counters.bump("encode_overflow_full_width_sort"
                          if cap is not None else
                          "encode_overflow_scatter")
            continue
        if not return_handoff:
            return out
        nc, ncg = _rst_chunk_geometry(h, w)
        gm_totals = meta_np[:, 2].astype(np.int64)
        handoff = DeviceEncodedBatch(
            combined=combined,
            gm_cbits=meta_np[:, 4:4 + ncg].astype(np.int64),
            base_cbits=meta_np[:, 4 + ncg:4 + ncg + nc].astype(np.int64),
            base_off=_base_word_offsets(gm_totals),
            width=w, height=h, quality=int(quality),
            metadata=metadata)
        return out, handoff

    # Rare dense-content fallback: exact scatter-based assembly.
    gran = 64 * 1024

    def read_prefixes(arr, n_words_used):
        k = -(-max(int(max(n_words_used)), 1) // gran) * gran
        k = min(k, arr.shape[1])
        rows = {}
        for shard in arr.addressable_shards:
            lo = shard.index[0].start or 0
            data = np.asarray(shard.data[:, :k])
            for j in range(data.shape[0]):
                rows[lo + j] = data[j]
        return [rows[i] for i in range(arr.shape[0])]

    kernel2, _ = _batched_encode_to_streams(
        mesh, gamut, hdr_tf, int(quality), h, w)
    base_words, base_bits, gm_words, gm_bits = kernel2(
        jnp.asarray(p010_y_batch), jnp.asarray(p010_uv_batch))
    base_bits = np.asarray(base_bits)
    gm_bits = np.asarray(gm_bits)
    icc = icc_mod.write_icc_profile("srgb", gamut)
    base_hdr = codec.yuv420_jpeg_headers(w, h, quality, icc=icc)
    gm_hdr = codec.gray_jpeg_headers(w // 4, h // 4,
                                     MAP_COMPRESS_QUALITY)
    base_prefixes = read_prefixes(
        base_words, [(int(b) + 31) // 32 for b in base_bits])
    gm_prefixes = read_prefixes(
        gm_words, [(int(b) + 31) // 32 for b in gm_bits])
    out = []
    for i in range(n):
        base = (base_hdr + de._finalize(base_prefixes[i], base_bits[i])
                + b"\xff\xd9")
        gmap = (gm_hdr + de._finalize(gm_prefixes[i], gm_bits[i])
                + b"\xff\xd9")
        out.append(mux.append_gainmap(base, gmap, metadata))
    # The scatter fallback has no RST chunking, so no device-resident
    # stream the parallel decode kernel could consume.
    return (out, None) if return_handoff else out


class DeviceEncodedBatch:
    """Zero-reupload handoff from batched API-0 encode to batched
    decode: the encoder's compacted [gainmap | base] stream words stay
    device-resident (batch-sharded) and the decoder gathers its lane
    windows straight from them — no JFIF re-parse, no host destuff, no
    h2d stream upload. The analog of the reference's in-process
    zero-copy encode->decode loop (jpegr.cpp:167-247). The host-side
    fields are the per-frame chunk geometry the encode already fetched
    for blob assembly (meta rows), so building this handle costs no
    extra link traffic."""

    __slots__ = ("combined", "gm_cbits", "base_cbits", "base_off",
                 "width", "height", "quality", "metadata")

    def __init__(self, combined, gm_cbits, base_cbits, base_off,
                 width, height, quality, metadata):
        self.combined = combined      # (n, words) u32, batch-sharded
        self.gm_cbits = gm_cbits      # (n, ncg) per-chunk bit counts
        self.base_cbits = base_cbits  # (n, ncb)
        self.base_off = base_off      # (n,) base word offsets
        self.width = width
        self.height = height
        self.quality = quality
        self.metadata = metadata


def handoff_apply_scalars(handoff: "DeviceEncodedBatch",
                          max_display_boost: float) -> np.ndarray:
    """Apply scalars for a device handoff, round-tripped through the
    XMP writer/parser so they are bit-identical to what a decode of
    the assembled blob computes (XMP serializes boosts as decimal
    text; skipping the round trip leaves last-ulp float deltas that
    flip the odd rounding-boundary pixel)."""
    from ..container import xmp as _xmp

    md_rt = _xmp.get_metadata_from_xmp(
        _xmp.XMP_NAMESPACE.encode() + b"\x00"
        + _xmp.generate_xmp_for_secondary_image(
            handoff.metadata).encode())
    return _decode_scalars(md_rt, max_display_boost)


def batched_decode_from_handoff(handoff: DeviceEncodedBatch,
                                output_format: str,
                                max_display_boost: float, mesh: Mesh,
                                use_luts: bool = False, stats=None):
    """Batched decode that consumes a DeviceEncodedBatch in place of
    JFIF blobs: bitwise-identical output to batched_decode on the
    assembled blobs (tests/test_parallel.py::TestDeviceHandoffDecode),
    but the only h2d traffic is a ~4 B/lane starts/scalars row. The
    quant/Huffman tables are the encoder's own (standard Annex-K
    scaled to the encode quality), so no stream parsing is needed."""
    from ..jpeg.device_decode import _bucket_len, serialize_tables

    n, nwords = (int(s) for s in handoff.combined.shape)
    w, h = handoff.width, handoff.height
    gw, gh = w // 4, h // 4
    gmx, gmy = -(-gw // 8), -(-gh // 8)
    ncb = handoff.base_cbits.shape[1]
    ncg = handoff.gm_cbits.shape[1]

    # Lane byte offsets inside each section: chunks are word-aligned
    # in the compacted stream (device_entropy._rst_assemble 1-fills to
    # the 32-bit boundary), so the alignment fill doubles as the
    # decoder's never-consumed lookahead and no compaction is needed.
    bcw = (handoff.base_cbits + 31) >> 5
    gcw = (handoff.gm_cbits + 31) >> 5
    bstarts = 4 * (np.cumsum(bcw, axis=1) - bcw)
    gstarts = 4 * (np.cumsum(gcw, axis=1) - gcw)
    win_b = _bucket_len(4 * int(bcw.max()))
    win_g = _bucket_len(4 * int(gcw.max()))
    cap_b = _bucket_len(max(4 * int(bcw.sum(1).max()), 4)) // 4
    cap_g = _bucket_len(max(4 * int(gcw.sum(1).max()), 4)) // 4
    base_dlen = _bucket_len(4 * cap_b + win_b)
    gm_dlen = _bucket_len(4 * cap_g + win_g)
    # Starts/offsets ride an int32 aux row and int32 device indexing;
    # mirror split_rst_stream's 2^31 guard instead of silently
    # wrapping on a pathologically large stream (ADVICE r4).
    if max(4 * cap_b + base_dlen, 4 * cap_g + gm_dlen,
           int(handoff.base_off.max(initial=0)) + cap_b,
           int(bstarts.max(initial=0)),
           int(gstarts.max(initial=0))) >= 2**31:
        raise ValueError("handoff stream exceeds int32 index range")

    qkey = np.stack([
        tables.scale_quant_table(tables.STD_LUMINANCE_QUANT,
                                 handoff.quality),
        tables.scale_quant_table(tables.STD_CHROMINANCE_QUANT,
                                 handoff.quality),
        tables.scale_quant_table(tables.STD_LUMINANCE_QUANT,
                                 MAP_COMPRESS_QUALITY),
    ]).astype(np.int32).tobytes()
    base_tkey = serialize_tables(
        (tables.DC_LUMA_BITS, tables.DC_LUMA_VALS),
        (tables.AC_LUMA_BITS, tables.AC_LUMA_VALS),
        (tables.DC_CHROMA_BITS, tables.DC_CHROMA_VALS),
        (tables.AC_CHROMA_BITS, tables.AC_CHROMA_VALS))
    gm_tkey = serialize_tables(
        (tables.DC_LUMA_BITS, tables.DC_LUMA_VALS),
        (tables.AC_LUMA_BITS, tables.AC_LUMA_VALS))

    batch_kernel = _handoff_decode_kernel(
        mesh, output_format, (ncb, win_b), (ncg, win_g), w, h,
        gmx, gmy, gw, gh, bool(use_luts), qkey, base_tkey, gm_tkey,
        base_dlen=base_dlen, gm_dlen=gm_dlen, cap_b=cap_b,
        cap_g=cap_g, nwords=nwords)

    sc = handoff_apply_scalars(handoff, max_display_boost)
    aux = np.empty((n, 5 + ncb + ncg), np.int32)
    aux[:, :4] = np.broadcast_to(sc.view(np.int32), (n, 4))
    aux[:, 4] = handoff.base_off.astype(np.int32)
    aux[:, 5:5 + ncb] = bstarts.astype(np.int32)
    aux[:, 5 + ncb:] = gstarts.astype(np.int32)
    if stats is not None:
        stats["h2d_bytes"] = stats.get("h2d_bytes", 0) + aux.nbytes
        stats["h2d_pack"] = "device-handoff"
    return batch_kernel(handoff.combined, aux)


@lru_cache(maxsize=None)
def _handoff_decode_kernel(mesh: Mesh, output_format: str, base_shape,
                           gm_shape, w: int, h: int, gmx: int, gmy: int,
                           gw: int, gh: int, use_luts: bool,
                           qkey: bytes, base_tkey: bytes,
                           gm_tkey: bytes, *, base_dlen: int,
                           gm_dlen: int, cap_b: int, cap_g: int,
                           nwords: int):
    """Cached vmapped+sharded decode over the encoder's device-resident
    compacted stream words: per frame, slice the base section at its
    dynamic word offset, expand words to the JPEG byte order (the u32
    packing of device_entropy._assemble_bits is big-endian), and feed
    the same fused decode kernel the blob path compiles."""
    from ..jpegr import _fused_decode_kernel_dev

    kernel = _fused_decode_kernel_dev(
        output_format, base_shape, gm_shape, RST_INTERVAL, RST_INTERVAL,
        w, h, w // 16, h // 16, gmx, gmy, gw, gh, w // gw,
        use_luts, qkey, base_tkey, gm_tkey, False, False,
        base_dlen=base_dlen, gm_dlen=gm_dlen)
    spec = _batch_sharding(mesh)
    ncb = base_shape[0]
    cap_gc = min(cap_g, nwords)

    def _be_bytes(words_u32, outlen):
        shifts = (jnp.uint32(24)
                  - jnp.arange(4, dtype=jnp.uint32) * 8)[None, :]
        b = ((words_u32[:, None] >> shifts) & jnp.uint32(0xFF)) \
            .astype(jnp.uint8).reshape(-1)
        return jnp.concatenate(
            [b, jnp.zeros(outlen - b.shape[0], jnp.uint8)])

    @partial(jax.jit, in_shardings=(spec, spec), out_shardings=spec)
    def batch_kernel(words, aux):
        def one(wrow, arow):
            sc = jax.lax.bitcast_convert_type(arow[:4], jnp.float32)
            starts = jnp.concatenate([arow[5:5 + ncb],
                                      arow[5 + ncb:]])
            starts2 = jnp.stack([starts, jnp.zeros_like(starts)])
            # Pad so the dynamic base slice never clamps (base_off +
            # cap_b can pass the static capacity by bucket rounding).
            wp = jnp.concatenate(
                [wrow, jnp.zeros(cap_b, jnp.uint32)])
            bw = jax.lax.dynamic_slice(wp, (arow[4],), (cap_b,))
            combined_u8 = jnp.concatenate(
                [_be_bytes(bw, base_dlen),
                 _be_bytes(wrow[:cap_gc], gm_dlen)])
            return kernel(combined_u8, sc, starts2)

        return jax.vmap(one)(words, aux)

    return batch_kernel


def _batched_decode_device(blobs, output_format: str,
                           max_display_boost: float, mesh: Mesh,
                           use_luts: bool, stats=None, meta_out=None):
    """Batched fully-on-device decode (parallel RST entropy decode +
    IDCT + apply, one vmapped jit) for blobs this framework encoded.
    Returns None when any blob's bitstreams don't qualify."""
    import math

    from ..container import mux, xmp
    from ..jpeg import device_decode as dd
    from ..jpegr import _fused_decode_kernel_dev

    def prep(blob):
        primary, gmap = mux.extract_primary_and_gainmap(blob)
        return (dd.parse_device_stream(primary),
                dd.parse_device_stream(gmap))

    # Host prep is ~25 ms/4K frame of numpy work that releases the
    # GIL; overlap it across the batch.
    if len(blobs) > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(min(len(blobs), 8)) as pool:
            parsed = list(pool.map(prep, blobs))
    else:
        parsed = [prep(blobs[0])]
    for ds, dsg in parsed:
        if ds is None or ds.gray or ds.sampling != (2, 2) \
                or dsg is None or not dsg.gray or dsg.xmp is None:
            return None

    ds0, dsg0 = parsed[0]

    def sig(ds, dsg):
        # One compiled kernel serves the batch, so everything baked
        # into it (geometry AND quant/Huffman tables, and whether each
        # stream is a real-RST or a synthesized restart-less one) must
        # match; a mixed-quality batch falls back rather than silently
        # dequantizing frames 1..N-1 with frame 0's tables.
        return (ds.width, ds.height, ds.n_lanes,
                dsg.n_lanes, ds.restart_interval,
                dsg.restart_interval, ds.tables_key, dsg.tables_key,
                ds.start_bits is not None, dsg.start_bits is not None,
                tuple(np.asarray(q).tobytes() for q in ds.qtables),
                np.asarray(dsg.qtables[0]).tobytes())

    geom = sig(ds0, dsg0)
    for ds, dsg in parsed[1:]:
        if sig(ds, dsg) != geom:
            return None

    # Unify window widths and (bucketed) dest lengths across the batch.
    from ..jpeg.device_decode import _bucket_len
    Lb = max(ds.win_len for ds, _ in parsed)
    Lg = max(dsg.win_len for _, dsg in parsed)
    Db = _bucket_len(max(ds.dest.size for ds, _ in parsed) + Lb)
    Dg = _bucket_len(max(dsg.dest.size for _, dsg in parsed) + Lg)

    def padd(d, target):
        return np.pad(d, (0, target - d.size))

    combined = np.stack([
        np.concatenate([padd(ds.dest, Db), padd(dsg.dest, Dg)])
        for ds, dsg in parsed])

    w, h = ds0.width, ds0.height
    gw, gh = dsg0.width, dsg0.height
    qkey = np.stack([ds0.qtables[0], ds0.qtables[1],
                     dsg0.qtables[0]]).astype(np.int32).tobytes()
    base_carry = ds0.start_bits is not None
    gm_carry = dsg0.start_bits is not None
    batch_kernel = _batched_decode_kernel_dev(
        mesh, output_format, (ds0.n_lanes, Lb),
        (dsg0.n_lanes, Lg), ds0.restart_interval,
        dsg0.restart_interval, w, h, ds0.mcus_x, ds0.mcus_y,
        dsg0.mcus_x, dsg0.mcus_y, gw, gh, w // gw, bool(use_luts), qkey,
        ds0.tables_key, dsg0.tables_key, base_carry, gm_carry,
        base_dlen=Db, gm_dlen=Dg)

    # Gain-map metadata is per-frame (frames may differ in content
    # boost even at identical geometry/tables).
    scalars = np.stack([
        _decode_scalars(xmp.get_metadata_from_xmp(dsg.xmp),
                        max_display_boost)
        for _, dsg in parsed])
    if meta_out is not None:
        meta_out.update(w=w, h=h, gw=gw, gh=gh, scalars=scalars)

    # Per-frame (2, lanes) starts: byte offsets for the on-device
    # window gather, bit offsets for foreign synthesized lanes.
    starts2 = np.stack([
        np.stack([
            np.concatenate([ds.starts_byte, dsg.starts_byte]),
            np.concatenate([
                ds.start_bits if base_carry
                else np.zeros(ds.n_lanes, np.int32),
                dsg.start_bits if gm_carry
                else np.zeros(dsg.n_lanes, np.int32)])])
        for ds, dsg in parsed])

    # ONE h2d transfer per batch: each transfer has a fixed cost, so
    # scalars + starts + dest streams ride a single i32 buffer per frame
    # ([f32-bits scalars | starts2 | dest words], LE byte order on
    # both sides by construction: host .view, device shift/mask).
    nl = starts2.shape[2]
    fused = np.empty((len(parsed), 4 + 2 * nl + (Db + Dg) // 4),
                     np.int32)
    fused[:, :4] = scalars.view(np.int32)
    fused[:, 4:4 + 2 * nl] = starts2.reshape(len(parsed), 2 * nl)
    fused[:, 4 + 2 * nl:] = combined.view(np.int32)

    if stats is not None:
        stats["h2d_bytes"] = stats.get("h2d_bytes", 0) + fused.nbytes
    return batch_kernel(fused)


@lru_cache(maxsize=None)
def _batched_decode_kernel_dev(mesh: Mesh, output_format: str,
                               base_shape, gm_shape, r_base: int,
                               r_gm: int, w: int, h: int, bmx: int,
                               bmy: int, gmx: int, gmy: int, gw: int,
                               gh: int, scale: int, use_luts: bool,
                               qkey: bytes, base_tkey: bytes,
                               gm_tkey: bytes, base_carry: bool = False,
                               gm_carry: bool = False, *,
                               base_dlen: int, gm_dlen: int):
    """Cached vmapped+sharded wrapper of the fused device decode
    kernel. MUST be cached: a fresh jax.jit object per batched_decode
    call would re-trace and re-compile the whole batch graph on every
    invocation. Takes per-frame contiguous
    destuffed streams + (2, lanes) starts (see
    _fused_decode_kernel_dev)."""
    from ..jpegr import _fused_decode_kernel_dev

    kernel = _fused_decode_kernel_dev(
        output_format, base_shape, gm_shape, r_base, r_gm, w, h, bmx,
        bmy, gmx, gmy, gw, gh, scale, use_luts, qkey, base_tkey,
        gm_tkey, base_carry, gm_carry, base_dlen=base_dlen,
        gm_dlen=gm_dlen)
    spec = _batch_sharding(mesh)
    nl = base_shape[0] + gm_shape[0]

    @partial(jax.jit, in_shardings=(spec,), out_shardings=spec)
    def batch_kernel(fused):
        # Split the single-transfer i32 row back into the kernel's
        # (dest u8, scalars f32, starts2 i32) inputs on device; the
        # word->byte expansion is a shift/mask over ~2 MB (negligible
        # next to one saved transfer).
        def one(row):
            sc = jax.lax.bitcast_convert_type(row[:4], jnp.float32)
            starts2 = row[4:4 + 2 * nl].reshape(2, nl)
            words = jax.lax.bitcast_convert_type(row[4 + 2 * nl:],
                                                 jnp.uint32)
            shifts = (jnp.arange(4, dtype=jnp.uint32) * 8)[None, :]
            dest = ((words[:, None] >> shifts)
                    & jnp.uint32(0xFF)).astype(jnp.uint8).reshape(-1)
            return kernel(dest, sc, starts2)

        return jax.vmap(one)(fused)

    return batch_kernel


def _decode_scalars(metadata, max_display_boost: float) -> np.ndarray:
    import math

    display_boost = min(max_display_boost, metadata.max_content_boost)
    boost_factor = (display_boost / metadata.max_content_boost
                    if display_boost > 0 else 1.0)
    return np.asarray(
        [math.log2(metadata.min_content_boost),
         math.log2(metadata.max_content_boost),
         boost_factor, display_boost], np.float32)


def batched_decode(blobs, output_format: str, max_display_boost: float,
                   mesh: Mesh, use_luts: bool = False, stats=None):
    """Decode N same-geometry JPEG/R blobs with one batched device
    dispatch. Streams this framework encoded take the fully-on-device
    path (parallel RST entropy decode); foreign streams fall back to
    host Huffman decode (sequential C++) + a vmapped fused
    dequant/IDCT/apply kernel. Returns a device array stacked on axis 0
    (callers materialize)."""
    import math

    from ..container import mux, xmp
    from ..jpeg import codec
    from ..jpegr import _fused_decode_kernel

    fast = _batched_decode_device(blobs, output_format,
                                  max_display_boost, mesh, use_luts,
                                  stats)
    if fast is not None:
        return fast

    counters.bump("batched_decode_host_entropy")
    coefs = []
    for blob in blobs:
        primary, gmap = mux.extract_primary_and_gainmap(blob)
        base = codec.decode_jpeg_coefs(primary)
        gdec = codec.decode_jpeg_coefs(gmap)
        coefs.append((base, gdec))

    base0, g0 = coefs[0]
    w, h = base0.width, base0.height
    yg, ql = base0.comps[0][0], base0.comps[0][1]
    ug, qc = base0.comps[1][0], base0.comps[1][1]
    gg, qg, gh, gw = g0.comps[0][0], g0.comps[0][1], g0.comps[0][2], \
        g0.comps[0][3]
    scale = w // gw
    qkey = np.stack([ql, qc, qg]).astype(np.int32).tobytes()

    def _geom(b, g):
        return (b.width, b.height,
                tuple(c[0].shape for c in b.comps),
                tuple(c[0].shape for c in g.comps))

    geom0 = _geom(base0, g0)
    for b, g in coefs[1:]:
        # Different dimensions can't share a stacked output array at
        # all (even per-frame results wouldn't stack) — reject with a
        # real error instead of a numpy broadcast crash downstream.
        if _geom(b, g) != geom0:
            from ..types import err
            raise err("UHDR_CODEC_INVALID_PARAM",
                      "batched_decode requires same-geometry frames; "
                      f"got {geom0[:2]} and {_geom(b, g)[:2]}")
    # One compiled kernel -> quant tables must match across the batch;
    # a mixed-quality batch decodes per frame instead (still one
    # device array out).
    for b, g in coefs[1:]:
        other = np.stack([b.comps[0][1], b.comps[1][1],
                          g.comps[0][1]]).astype(np.int32).tobytes()
        if other != qkey:
            from ..jpegr import JpegR
            from ..types import OutputFormat
            outs = [JpegR().decode(blob, OutputFormat(output_format),
                                   max_display_boost, use_luts)
                    .image.planes["rgba"] for blob in blobs]
            return jnp.stack([jnp.asarray(o) for o in outs])
    batch_kernel = _batched_decode_kernel_host(
        mesh, output_format, yg.shape, ug.shape, gg.shape, w, h, scale,
        bool(use_luts), qkey)

    scalars_b = np.stack([
        _decode_scalars(xmp.get_metadata_from_xmp(g.xmp),
                        max_display_boost)
        for _, g in coefs])

    flats = np.stack([
        np.concatenate([b.comps[0][0].ravel(), b.comps[1][0].ravel(),
                        b.comps[2][0].ravel(), g.comps[0][0].ravel()])
        for b, g in coefs])

    return batch_kernel(flats, scalars_b)


@lru_cache(maxsize=None)
def _batched_decode_kernel_host(mesh: Mesh, output_format: str, y_shape,
                                c_shape, g_shape, w: int, h: int,
                                scale: int, use_luts: bool,
                                qkey: bytes):
    """Cached vmapped+sharded wrapper of the host-entropy fused decode
    kernel (same re-compile-per-call hazard as
    _batched_decode_kernel_dev)."""
    from ..jpegr import _fused_decode_kernel

    kernel = _fused_decode_kernel(output_format, y_shape, c_shape,
                                  g_shape, w, h, scale, use_luts, qkey)
    spec = _batch_sharding(mesh)

    @partial(jax.jit, in_shardings=(spec, spec), out_shardings=spec)
    def batch_kernel(flat_batch, sc):
        return jax.vmap(kernel)(flat_batch, sc)

    return batch_kernel


def batched_apply_gainmap(y8_batch, u8_batch, v8_batch, gmap_batch,
                          metadata: GainMapMetadata, output_format: str,
                          max_display_boost: float, mesh: Mesh):
    """Batch variant of ops.gainmap.apply_gainmap, batch-sharded."""
    w = y8_batch.shape[-1]
    mw = gmap_batch.shape[-1]
    kernel = _batched_apply_kernel(mesh, output_format, w // mw)
    sc = _decode_scalars(metadata, max_display_boost)
    return kernel(jnp.asarray(y8_batch), jnp.asarray(u8_batch),
                  jnp.asarray(v8_batch), jnp.asarray(gmap_batch),
                  jnp.asarray(sc))


@lru_cache(maxsize=None)
def _batched_apply_kernel(mesh: Mesh, output_format: str, scale: int):
    """Cached sharded wrapper; metadata scalars are runtime args so one
    compilation serves every boost configuration."""
    spec = _batch_sharding(mesh)
    base = gm._apply_kernel(output_format, scale, False)

    @partial(jax.jit, in_shardings=(spec, spec, spec, spec, None),
             out_shardings=spec)
    def kernel(yb, ub, vb, gb, sc):
        return jax.vmap(lambda a, b, c, g: base(
            a, b, c, g, sc[0], sc[1], sc[2], sc[3]))(yb, ub, vb, gb)

    return kernel
