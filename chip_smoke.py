#!/usr/bin/env python
"""On-device smoke run of the JPEG/R codec: the quickest proof that the
system starts on the GPU and computes the right answers there.

    python chip_smoke.py              # one GPU, phases 1-4
    python chip_smoke.py --chips 4    # four GPUs, the multi-device phase only

Phases (one process; a failing check raises and the run exits non-zero):

1. Device: requires JAX's default backend to be a GPU (no CPU
   fallback); prints the device kind and count, the card's name and
   power limit from nvidia-smi, the JAX version and the compile-cache
   directory.
2. Reference decodes: the six reference-encoded 1280x720 goldens in
   tests/goldens decode through api.UhdrDecoder on the device path, to
   F16 and to RGBA1010102, against the reference's own decodes.
3. Main path at 12 MP: four seeded 4080x3072 P010 frames through the
   batched API-0 encode, the batched decodes to HLG and linear with their
   packed fetches, the host-apply decode and the encoder->decoder device
   handoff. Every device stage is compared with its plain reference:
   entropy decode and encode bit-exact against the native host codec,
   fDCT and gain map against the CPU backend, device-apply pixels
   against host-apply pixels, and no float32 matrix product without an
   explicit precision. Every data-route counter must stay zero.
4. Stable API and CLI: one-shot UhdrEncoder/UhdrDecoder at 12 MP, the
   uhdr CLI in this process, and examples/serving_loop.py's main().

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import gzip
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from libultrahdr_dev.utils import jaxcache
from libultrahdr_dev.utils.synth import synth_p010, synth_p010_batch

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDENS = os.path.join(REPO, "tests", "goldens")
GOLDEN_CONFIGS = tuple((g, t) for g in ("709", "p3", "2100")
                       for t in ("hlg", "pq"))
GOLDEN_W, GOLDEN_H = 1280, 720
# Display boost the goldens were decoded at (max content boost).
GOLDEN_BOOST = {"hlg": 4.926108, "pq": 49.261084}

FULL_FRAMES, FULL_H, FULL_W = 4, 3072, 4080
MULTI_FRAMES = 8
BOOST = 1000 / 203
QUALITY = 95

# Tolerances, each printed beside the value it bounds.
F16_PSNR_MIN = 55.0           # dB vs the reference decode (test_jpegr)
CH1010102_PSNR_MIN = 50.0     # dB, every 10-bit channel (test_jpegr)
# fDCT: bf16 operands are exact and the sum is f32, so only the order
# of summation differs between backends.
FDCT_MAX_DELTA = 1
FDCT_MAX_SHARE = 1e-4
# Gain map: log2/exp2/pow and FMA contraction may move a value by one
# ULP near a rounding edge.
GAINMAP_MAX_DELTA = 1
GAINMAP_MAX_SHARE = 1e-3
# Device apply vs host apply (tests/test_hostapply.py).
PIXEL_MAX_CODE = 1
PIXEL_MAX_F16_ULP = 1


class CheckFailed(AssertionError):
    """One or more checks of a phase were outside their tolerance."""


class Checks:
    """Prints each check beside its tolerance and records failures;
    done() raises CheckFailed if any check failed."""

    def __init__(self, phase: str):
        self.phase = phase
        self.failed: list[str] = []

    def _record(self, name, value, rel, limit, ok):
        line = f"[{self.phase}] {name}: {value} ({rel} {limit}) " + (
            "ok" if ok else "FAIL")
        print(line, flush=True)
        if not ok:
            self.failed.append(line)
        return ok

    def le(self, name, value, limit):
        return self._record(name, value, "<=", limit, value <= limit)

    def ge(self, name, value, limit):
        return self._record(name, value, ">=", limit, value >= limit)

    def eq(self, name, value, want):
        return self._record(name, value, "==", want, value == want)

    def done(self):
        if self.failed:
            raise CheckFailed(f"{self.phase}: {len(self.failed)} check(s) "
                              "failed:\n" + "\n".join(self.failed))


# ---------------------------------------------------------------------
# Comparison helpers (plain numpy, testable on the CPU)
# ---------------------------------------------------------------------

def psnr(a, b, peak: float) -> float:
    """PSNR in dB of a against b (99.0 when identical)."""
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return 99.0 if mse == 0 else float(10 * np.log10(peak * peak / mse))


def delta_stats(a, b):
    """(max |a-b|, count of differing elements, their share)."""
    d = np.abs(np.asarray(a, np.int64) - np.asarray(b, np.int64))
    count = int(np.count_nonzero(d))
    return int(d.max(initial=0)), count, count / max(d.size, 1)


def channels_1010102(px):
    """(..., 3) int64 array of the R, G, B 10-bit codes of packed
    RGBA1010102 pixels."""
    p = np.asarray(px).astype(np.uint32)
    return np.stack([(p >> s) & 0x3FF for s in (0, 10, 20)],
                    -1).astype(np.int64)


def channel_psnr_1010102(ours, want):
    """Per-channel PSNR (dB) of two packed RGBA1010102 images."""
    a, b = channels_1010102(ours), channels_1010102(want)
    return [psnr(a[..., c], b[..., c], 1023.0) for c in range(3)]


def f16_bits(px):
    """(..., 4) uint16 bit patterns of an RGBA F16 image, whether it is
    held as (..., 4) halves or one u64 per pixel."""
    a = np.ascontiguousarray(np.asarray(px))
    if a.dtype.itemsize == 8:
        return a.view(np.uint16).reshape(*a.shape, 4)
    return a.view(np.uint16)


def f16_ulp_diff(a, b) -> int:
    """Largest distance in units of the last place between two F16
    images (bit patterns mapped to an ordered integer line)."""
    def ordered(x):
        u = f16_bits(x).astype(np.int64)
        mag = u & 0x7FFF
        return np.where(u & 0x8000, -mag, mag)

    return int(np.abs(ordered(a) - ordered(b)).max(initial=0))


def unpinned_f32_dots(closed_jaxpr) -> list[str]:
    """dot_general equations with a float32 operand whose precision is
    not HIGHEST on both operands, anywhere in a (closed) jaxpr and its
    sub-jaxprs. On the GPU such a product may run in TF32."""
    import jax

    highest = jax.lax.Precision.HIGHEST
    found: list[str] = []

    def pinned(prec):
        if prec is None:
            return False
        prec = prec if isinstance(prec, (tuple, list)) else (prec,)
        return all(p == highest for p in prec)

    def subjaxprs(value):
        if hasattr(value, "eqns"):
            yield value
        elif hasattr(value, "jaxpr") and hasattr(value.jaxpr, "eqns"):
            yield value.jaxpr
        elif isinstance(value, (tuple, list)):
            for v in value:
                yield from subjaxprs(v)

    seen = set()

    def walk(jaxpr):
        if id(jaxpr) in seen:
            return
        seen.add(id(jaxpr))
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                f32 = any(getattr(v.aval, "dtype", None) == np.float32
                          for v in eqn.invars)
                if f32 and not pinned(eqn.params.get("precision")):
                    found.append(str(eqn)[:160])
            for value in eqn.params.values():
                for sub in subjaxprs(value):
                    walk(sub)

    walk(closed_jaxpr.jaxpr if hasattr(closed_jaxpr, "jaxpr")
         else closed_jaxpr)
    return found


def last_line(devices) -> str:
    """The run's final JSON line."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def nvidia_smi() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def decode_path(dec) -> str:
    """Which path a UhdrDecoder's decode took: "device" for the fused
    device entropy decode, "host" for the host Huffman decode."""
    part = dec._result._gainmap_parts[0]
    return part if isinstance(part, str) else "host"


def _devices():
    """(accelerator device, CPU device) of this process."""
    import jax

    return jax.devices()[0], jax.devices("cpu")[0]


# ---------------------------------------------------------------------
# Phase 1: device
# ---------------------------------------------------------------------

def phase_device():
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"chip_smoke: JAX's default backend is "
                         f"{backend!r}; this run needs a GPU")
    devs = jax.devices()
    print(f"[device] platform={devs[0].platform} "
          f"kind={devs[0].device_kind} count={len(devs)}")
    print(f"[device] nvidia-smi: {nvidia_smi()}")
    print(f"[device] jax {jax.__version__}, compile cache "
          f"{jaxcache.configure()}", flush=True)
    from libultrahdr_dev.jpeg import native

    t0 = time.perf_counter()
    if native.get_lib() is None:
        raise SystemExit("chip_smoke: the native host codec "
                         "(jpeg/native/*.cpp) did not build; g++ needed")
    print(f"[device] native host codec ready in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return devs


# ---------------------------------------------------------------------
# Phase 2: reference decodes
# ---------------------------------------------------------------------

def _golden(name: str) -> str:
    return os.path.join(GOLDENS, name)


def check_golden(checks: Checks, gn: str, tn: str):
    """Decode one reference-encoded golden through the stable API to F16
    and to its RGBA1010102 format; compare with the reference decodes
    and require the device decode path."""
    from libultrahdr_dev.api import UhdrDecoder
    from libultrahdr_dev.types import ColorTransfer, PixelFormat

    with open(_golden(f"enc0_{gn}_{tn}.jpegr"), "rb") as f:
        blob = f.read()
    boost = GOLDEN_BOOST[tn]
    tf = ColorTransfer.HLG if tn == "hlg" else ColorTransfer.PQ
    for fmt, ct, kind in ((PixelFormat.RGBA_F16, ColorTransfer.LINEAR,
                           "f16"),
                          (PixelFormat.RGBA1010102, tf, "1010102")):
        dec = (UhdrDecoder().set_image(blob).set_out_img_format(fmt)
               .set_out_color_transfer(ct)
               .set_out_max_display_boost(boost))
        ours = np.asarray(dec.decode().planes["rgba"])
        checks.eq(f"golden {gn}/{tn} {kind} decode path",
                  decode_path(dec), "device")
        with gzip.open(_golden(f"dec0_{gn}_{tn}_{kind}.raw.gz")) as f:
            raw = f.read()
        if kind == "f16":
            want = np.frombuffer(raw, np.uint16).reshape(
                GOLDEN_H, GOLDEN_W, 4)
            p = psnr(f16_bits(ours)[..., :3].view(np.float16),
                     want[..., :3].view(np.float16), 1.0)
            checks.ge(f"golden {gn}/{tn} F16 PSNR dB", round(p, 2),
                      F16_PSNR_MIN)
        else:
            want = np.frombuffer(raw, np.uint32).reshape(GOLDEN_H,
                                                         GOLDEN_W)
            worst = min(channel_psnr_1010102(ours, want))
            checks.ge(f"golden {gn}/{tn} 1010102 min channel PSNR dB",
                      round(worst, 2), CH1010102_PSNR_MIN)


def phase_goldens():
    checks = Checks("goldens")
    for gn, tn in GOLDEN_CONFIGS:
        check_golden(checks, gn, tn)
    checks.done()


# ---------------------------------------------------------------------
# Phase 3: main path
# ---------------------------------------------------------------------

def _entropy_segment(jpeg: bytes) -> bytes:
    """The entropy-coded bytes of a one-scan JPEG (after SOS, before
    EOI)."""
    from libultrahdr_dev.container import jfif

    _, sos_end = jfif.scan_segments(jpeg, 0)
    return jpeg[sos_end:jfif.find_eoi(jpeg, sos_end) - 2]


def check_entropy_decode(checks: Checks, jpeg: bytes, name: str):
    """Device entropy decode (device_decode.decode_rst_chunks) of one
    JPEG against the native host decode of the same stream: the
    coefficients must be bit-exact. Returns (while_loop trips, device
    decode wall ms)."""
    import jax

    from libultrahdr_dev.jpeg import codec, device_decode as dd

    ds = dd.parse_device_stream(jpeg)
    if ds is None:
        raise CheckFailed(f"{name}: stream is not device-decodable")
    chains = dd.chains_from_key(ds.tables_key) if ds.tables_key else None
    mcb = dd.min_code_len_from_key(ds.tables_key)
    n_mcus = ds.mcus_x * ds.mcus_y
    hs, vs = ds.sampling

    @jax.jit
    def decode(chunks):
        blocks, trips = dd.decode_rst_chunks(
            chunks, ds.restart_interval, n_mcus, ds.gray, chains, mcb,
            ypm=hs * vs, return_steps=True)
        if ds.gray:
            return (blocks[:n_mcus],), trips
        return dd.deinterleave_ycbcr_device(blocks, ds.mcus_x, ds.mcus_y,
                                            hs, vs), trips

    chunks = jax.device_put(ds.chunks)
    jax.block_until_ready(decode(chunks))  # compile
    t0 = time.perf_counter()
    planes, trips = jax.block_until_ready(decode(chunks))
    ms = (time.perf_counter() - t0) * 1e3
    host = codec.decode_jpeg_coefs(jpeg)
    for c, dev in enumerate(planes):
        want = host.comps[c][0].reshape(-1, 64)
        got = np.asarray(dev)[:want.shape[0]]
        mx, count, _ = delta_stats(got, want)
        checks.eq(f"{name} entropy decode comp {c} differing coefs",
                  count, 0)
    trips = int(trips)
    print(f"[main] {name} entropy decode while_loop trips={trips} "
          f"wall={ms:.3f} ms", flush=True)
    return trips, ms


def check_entropy_encode(checks: Checks, jpeg: bytes, name: str):
    """The device-encoded entropy segment of one JPEG must be
    byte-identical to the native host encoder's output for the same
    quantized coefficients (decoded from the stream by the host)."""
    from libultrahdr_dev.jpeg import codec, device_decode as dd, tables

    host = codec.decode_jpeg_coefs(jpeg)
    restart = dd.parse_device_stream(jpeg).restart_interval
    luma = [(tables.DC_LUMA_BITS, tables.DC_LUMA_VALS)], \
        [(tables.AC_LUMA_BITS, tables.AC_LUMA_VALS)]
    if host.ncomp == 1:
        blocks = host.comps[0][0].reshape(-1, 64)
        seg = codec.entropy_encode(
            blocks, np.zeros(blocks.shape[0], np.uint8), [0], [0],
            *luma, restart, 1)
    else:
        yb, ub, vb = (host.comps[c][0] for c in range(3))
        hs, vs = host.comps[0][4]
        mcus_x, mcus_y = ub.shape[1], ub.shape[0]
        blocks, comp_ids = codec._interleave_ycbcr(yb, ub, vb, mcus_x,
                                                   mcus_y, hs, vs)
        seg = codec.entropy_encode(
            blocks, comp_ids, [0, 1, 1], [0, 1, 1],
            luma[0] + [(tables.DC_CHROMA_BITS, tables.DC_CHROMA_VALS)],
            luma[1] + [(tables.AC_CHROMA_BITS, tables.AC_CHROMA_VALS)],
            restart, hs * vs + 2)
    checks.eq(f"{name} entropy segment identical to host encoder "
              f"({len(seg)} B)", seg == _entropy_segment(jpeg), True)


def check_fdct(checks: Checks, plane_u8, qtable, name: str):
    """fDCT + quantization (jpeg/dct.py fdct_zigzag) on the accelerator
    against the same jitted function on the CPU backend."""
    import jax

    from libultrahdr_dev.jpeg import dct, tables

    accel, cpu = _devices()
    q_zig = np.asarray(qtable, np.float32).reshape(64)[tables.ZIGZAG]
    fn = jax.jit(dct.fdct_zigzag)
    got = np.asarray(fn(jax.device_put(plane_u8, accel),
                        jax.device_put(q_zig, accel)))
    want = np.asarray(fn(jax.device_put(plane_u8, cpu),
                         jax.device_put(q_zig, cpu)))
    mx, count, share = delta_stats(got, want)
    checks.le(f"fDCT {name} max |delta| vs CPU", mx, FDCT_MAX_DELTA)
    checks.le(f"fDCT {name} share of differing coefs ({count} of "
              f"{got.size})", share, FDCT_MAX_SHARE)
    return count, share


def check_gainmap(checks: Checks, p010_y, p010_uv):
    """API-0 tone map + gain map (ops/gainmap.py, ops/color.py) on the
    accelerator against the CPU backend on the same frame."""
    import jax

    from libultrahdr_dev.ops import gainmap as gm

    def run(dev):
        y = jax.device_put(p010_y, dev)
        uv = jax.device_put(p010_uv, dev)
        y8, u8, v8 = gm.tonemap_p010(y, uv)
        gmap, _ = gm.generate_gainmap(y8, u8, v8, y, uv,
                                      sdr_gamut="bt2100",
                                      hdr_gamut="bt2100", hdr_tf="hlg")
        return np.asarray(gmap)

    accel, cpu = _devices()
    got, want = run(accel), run(cpu)
    mx, count, share = delta_stats(got, want)
    checks.le("gain map max |delta| code vs CPU", mx, GAINMAP_MAX_DELTA)
    checks.le(f"gain map share of differing pixels ({count} of "
              f"{got.size})", share, GAINMAP_MAX_SHARE)
    return count, share


def check_pixels(checks: Checks, device_px, host_px, fmt: str, name):
    """Device-apply pixels against host-apply pixels."""
    if fmt == "hdr_linear":
        checks.le(f"{name} max F16 ULP device vs host apply",
                  f16_ulp_diff(device_px, host_px), PIXEL_MAX_F16_ULP)
    else:
        mx, _, _ = delta_stats(channels_1010102(device_px),
                               channels_1010102(host_px))
        checks.le(f"{name} max 10-bit code device vs host apply", mx,
                  PIXEL_MAX_CODE)


def check_precision(checks: Checks, traced: dict):
    """No float32 matrix product of the traced device programs runs
    without an explicit HIGHEST precision (so none runs in TF32)."""
    for name, closed in traced.items():
        bad = unpinned_f32_dots(closed)
        for eqn in bad:
            print(f"[main] unpinned f32 dot in {name}: {eqn}")
        checks.eq(f"{name}: f32 dot_general without HIGHEST", len(bad), 0)


def run_main_path(frames: int = FULL_FRAMES, h: int = FULL_H,
                  w: int = FULL_W) -> dict:
    """Phase 3 at the given size on a one-device mesh. Raises
    CheckFailed when a check is out of tolerance; returns the measured
    values."""
    import jax

    from libultrahdr_dev.container import mux
    from libultrahdr_dev.jpeg import tables
    from libultrahdr_dev.jpeg.device_entropy import DEFAULT_CHUNK_CAP
    from libultrahdr_dev.jpegr import JpegR
    from libultrahdr_dev.parallel import sharding
    from libultrahdr_dev.types import OutputFormat
    from libultrahdr_dev.utils import counters

    checks = Checks("main")
    counters.reset()
    ys, uvs = synth_p010_batch(frames, h, w)
    mesh = sharding.default_mesh(jax.devices()[:1])
    t0 = time.perf_counter()
    blobs, handoff = sharding.batched_encode_api0(
        ys, uvs, mesh, quality=QUALITY, return_handoff=True)
    print(f"[main] batched encode {frames}x{w}x{h}: "
          f"{[len(b) for b in blobs]} B "
          f"({time.perf_counter() - t0:.1f} s incl. compile)", flush=True)
    checks.eq("encode handoff available", handoff is not None, True)

    dec = {}
    for fmt, fetch in (("hdr_hlg", sharding.fetch_1010102_packed),
                       ("hdr_linear", sharding.fetch_f16_packed)):
        out = sharding.batched_decode(blobs, fmt, BOOST, mesh)
        st = {}
        px = fetch(out, st)
        raw = np.asarray(out)
        checks.eq(f"{fmt} packed fetch ({st.get('d2h_pack')}) == raw "
                  "fetch", np.array_equal(px, raw), True)
        hand = np.asarray(sharding.batched_decode_from_handoff(
            handoff, fmt, BOOST, mesh))
        checks.eq(f"{fmt} handoff decode == blob decode",
                  np.array_equal(hand, raw), True)
        ha = sharding.decode_batch_hostapply(blobs, fmt, BOOST, mesh)
        checks.eq(f"{fmt} host-apply decode available", ha is not None,
                  True)
        check_pixels(checks, raw, ha, fmt, fmt)
        ha_hand = sharding.decode_batch_hostapply(None, fmt, BOOST, mesh,
                                                  handoff=handoff)
        checks.eq(f"{fmt} host-apply from handoff == from blobs",
                  np.array_equal(ha_hand, ha), True)
        dec[fmt] = raw

    primary, gmap = mux.extract_primary_and_gainmap(blobs[0])
    trips, ms = check_entropy_decode(checks, primary, "base")
    gtrips, gms = check_entropy_decode(checks, gmap, "gain map")
    check_entropy_encode(checks, primary, "base")
    check_entropy_encode(checks, gmap, "gain map")

    from libultrahdr_dev.ops import gainmap as gm

    y8, u8, _ = (np.asarray(p) for p in gm.tonemap_p010(
        jax.device_put(ys[0], _devices()[1]),
        jax.device_put(uvs[0], _devices()[1])))
    fd_y = check_fdct(checks, y8, tables.scale_quant_table(
        tables.STD_LUMINANCE_QUANT, QUALITY), "luma")
    fd_c = check_fdct(checks, u8[:u8.shape[0] // 8 * 8,
                                 :u8.shape[1] // 8 * 8],
                      tables.scale_quant_table(
                          tables.STD_CHROMINANCE_QUANT, QUALITY),
                      "chroma")
    gmc = check_gainmap(checks, ys[0], uvs[0])

    enc_kernel, _ = sharding._batched_encode_to_streams_rst(
        mesh, "bt2100", "hlg", QUALITY, h, w, DEFAULT_CHUNK_CAP)
    u16 = np.uint16
    traced = {"batched encode": jax.make_jaxpr(
        enc_kernel.device_input_variant)(
            jax.ShapeDtypeStruct((frames, h, w), u16),
            jax.ShapeDtypeStruct((frames, h // 2, w), u16))}
    for fmt in ("hdr_hlg", "hdr_linear", "planes"):
        traced[f"batched decode {fmt}"] = jax.make_jaxpr(
            lambda f=fmt: sharding.batched_decode(blobs, f, BOOST, mesh))()
        traced[f"handoff decode {fmt}"] = jax.make_jaxpr(
            lambda f=fmt: sharding.batched_decode_from_handoff(
                handoff, f, BOOST, mesh))()
    traced["stable-API decode"] = jax.make_jaxpr(
        lambda: JpegR().decode(blobs[0], OutputFormat.HDR_LINEAR,
                               BOOST).image.planes["rgba"])()
    check_precision(checks, traced)

    snap = counters.snapshot()
    print(f"[main] counters: {snap}", flush=True)
    checks.eq("non-zero route counters", sorted(
        k for k, v in snap.items() if v), [])
    checks.done()
    return {"blob_bytes": [len(b) for b in blobs],
            "entropy_decode_trips": trips, "entropy_decode_ms": ms,
            "gm_entropy_decode_trips": gtrips, "gm_entropy_decode_ms": gms,
            "fdct_luma_diff": fd_y, "fdct_chroma_diff": fd_c,
            "gainmap_diff": gmc}


# ---------------------------------------------------------------------
# Phase 4: stable API, CLI, serving loop
# ---------------------------------------------------------------------

def run_api_cli(h: int = FULL_H, w: int = FULL_W, serving_argv=None):
    """One-shot stable-API encode/decode of one frame, the uhdr CLI
    (encode, then decode) in this process, and the example serving
    loop's main()."""
    from libultrahdr_dev import cli
    from libultrahdr_dev.api import HDR_IMG, UhdrDecoder, UhdrEncoder
    from libultrahdr_dev.container import mux
    from libultrahdr_dev.types import (ColorGamut, ColorTransfer,
                                       PixelFormat, RawImage)

    checks = Checks("api")
    y, uv = synth_p010(h, w, seed=0)
    raw = RawImage(fmt=PixelFormat.P010, width=w, height=h,
                   gamut=ColorGamut.BT2100, transfer=ColorTransfer.HLG,
                   planes={"y": y, "uv": uv})
    enc = UhdrEncoder()
    enc.set_raw_image(raw, HDR_IMG)
    blob = enc.encode().data
    checks.eq("stable-API encode is Ultra HDR", mux.is_uhdr_image(blob),
              True)
    dec = UhdrDecoder().set_image(blob)
    px = f16_bits(np.asarray(dec.decode().planes["rgba"]))
    checks.eq("stable-API decode path", decode_path(dec), "device")
    checks.eq("stable-API F16 pixels shape", px.shape, (h, w, 4))
    checks.eq("stable-API F16 pixels finite",
              bool(np.isfinite(px.view(np.float16)).all()), True)

    with tempfile.TemporaryDirectory(prefix=".smoke-", dir=REPO) as tmp:
        p010 = os.path.join(tmp, "in.p010")
        np.concatenate([y.ravel(), uv.ravel()]).tofile(p010)
        jr = os.path.join(tmp, "out.jpegr")
        out = os.path.join(tmp, "out.raw")
        checks.eq("cli encode rc", cli.main([
            "-m", "0", "-p", p010, "-w", str(w), "-h", str(h), "-C", "2",
            "-t", "1", "-q", str(QUALITY), "-z", jr]), 0)
        checks.eq("cli decode rc", cli.main(
            ["-m", "1", "-j", jr, "-o", "1", "-O", "5", "-z", out]), 0)
        checks.eq("cli decode bytes", os.path.getsize(out), h * w * 4)

    spec = importlib.util.spec_from_file_location(
        "serving_loop", os.path.join(REPO, "examples", "serving_loop.py"))
    loop = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(loop)
    checks.eq("serving loop rc", loop.main(
        ["--rounds", "3"] if serving_argv is None else serving_argv), 0)
    checks.done()


# ---------------------------------------------------------------------
# --chips 4: the multi-device path
# ---------------------------------------------------------------------

def run_multichip(n: int) -> dict:
    """dryrun_multichip(n) at 12 MP: the (batch, rows) encode and decode
    steps, the pipelined serving pass, and 8 frames over
    default_mesh(devices[:n]) byte-identical to a one-device mesh."""
    import __graft_entry__

    res = __graft_entry__.dryrun_multichip(n, MULTI_FRAMES, FULL_H,
                                           FULL_W)
    print(f"[multichip] {json.dumps(res)}", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, default=1,
                    help="with 4: run only the multi-device phase on "
                         "four GPUs")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    devs = phase_device()
    if args.chips != 1:
        if len(devs) < args.chips:
            raise SystemExit(f"chip_smoke: --chips {args.chips} needs "
                             f"{args.chips} GPUs; {len(devs)} visible")
        run_multichip(args.chips)
        devs = devs[:args.chips]
    else:
        devs = devs[:1]
        phase_goldens()
        print(f"[goldens] done at {time.perf_counter() - t0:.1f} s",
              flush=True)
        run_main_path()
        print(f"[main] done at {time.perf_counter() - t0:.1f} s",
              flush=True)
        run_api_cli()
        print(f"[api] done at {time.perf_counter() - t0:.1f} s",
              flush=True)
    print(last_line(devs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
