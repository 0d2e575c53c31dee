#!/usr/bin/env python
"""Headline benchmark: batched 4K JPEG/R encode+decode throughput on
one device (ms/frame), pipelined like a production serving loop.

Prints ONE JSON line:
  {"metric": "4k_jpegr_encode_decode", "value": <ms/frame>,
   "unit": "ms", "vs_baseline": <speedup vs reference>}

Baseline: the reference implementation compiled on the x86 host
(tools/build_reference_oracle.sh) measured 25.5 ms encode + 115 ms
decode at 1280x720 (BASELINE.md); scaled by pixel count to 4080x3072
(13.6x) -> 1911 ms/frame for encode+decode on one x86 core.

Decode output is RGBA1010102/HLG (one of the reference benchmark's
decode configs). Both directions ride a lossless segment pack
(parallel/packio.py), and the serving loop keeps three stages in
flight (host pack of batch N+1, device work of batch N, readback
fetch+unpack of batch N-1). The detail block reports exact
bytes/frame, dispatch-amortized device-compute times and roofline
context against the peaks of the device it ran on."""

import json
import os
import sys
import time

import numpy as np

from libultrahdr_dev.utils.synth import synth_p010

BASELINE_4K_MS = 1911.0
W, H = 4080, 3072
FRAMES = 4
if os.environ.get("UHDR_BENCH_SMALL") == "1":
    # Logic smoke mode (CPU CI): tiny shapes, same control flow. The
    # printed numbers are meaningless; vs_baseline is not comparable.
    W, H = 192, 128
    FRAMES = 2

# Published peaks for the roofline context fields, keyed by JAX's
# device_kind. Source: NVIDIA H100 data sheet, SXM part, dense rates
# at the full 700 W power limit. A device not listed is an error.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_GBps": 3350.0, "bf16_tflops": 989.0},
}


def device_peaks(device_kind: str) -> dict:
    """Published peaks of a device kind; raises for an unlisted one."""
    if device_kind not in DEVICE_PEAKS:
        raise KeyError(f"no published peaks for device kind "
                       f"{device_kind!r} (bench.py DEVICE_PEAKS)")
    return DEVICE_PEAKS[device_kind]


def foreign_decode_ms():
    """Host-side cost of ingesting a foreign (no-restart-marker) 4K
    baseline JPEG, built by the repo's own encoder without restart
    markers. Two numbers:
    - full_ms: complete host entropy decode (jpeg/native/entropy.cpp),
      the path decode_jpeg_coefs exposes;
    - scan_ms: the lengths-only scan (uhdr_huff_scan_offsets) that is
      the ONLY serial host work when the frame rides the lane-parallel
      device decoder via synthesized segments
      (device_decode.scan_foreign_stream) — the decode itself then
      runs on-device alongside our own RST streams.
    Pure host work."""
    from libultrahdr_dev.jpeg import codec, device_decode as dd

    y10, _ = synth_p010(H, W, seed=9)
    img = (y10 >> 8).astype(np.uint8)
    chroma = np.full((H // 2, W // 2), 128, np.uint8)
    blob = codec.encode_jpeg(
        {"y": img, "u": chroma + (img[::2, ::2] >> 3),
         "v": chroma - (img[1::2, 1::2] >> 3)},
        quality=95, restart_interval=0)
    codec.decode_jpeg_coefs(blob)  # warm table/ctypes setup
    full = scan = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        codec.decode_jpeg_coefs(blob)
        full = min(full, (time.perf_counter() - t0) * 1000)
    for _ in range(3):
        t0 = time.perf_counter()
        ds = dd.parse_device_stream(blob)
        scan = min(scan, (time.perf_counter() - t0) * 1000)
    if ds is None or ds.start_bits is None:
        scan = -1.0  # scan path unavailable (no native lib)
    return full, scan, len(blob)


def _host_contention_probe():
    """Load average + a 10M-iteration single-thread CPU probe. The
    host half of the serving loop (pack/unpack/plan) runs on this
    CPU; if another process is eating the core while this script
    runs, every host stage stretches by the contention factor and the
    headline is measurement contamination, not code. (Round 5 learned
    this the hard way: a 25-minute pytest suite running alongside the
    20:22Z 2026-08-19 bench turned a 1.5x headline into 0.634x.)"""
    t0 = time.perf_counter()
    x = 0
    for i in range(10_000_000):
        x += i
    spin_ms = (time.perf_counter() - t0) * 1000
    try:
        load1 = round(os.getloadavg()[0], 2)
    except OSError:
        load1 = None
    return {"load_1m": load1, "spin10M_ms": round(spin_ms, 1)}


def main():
    from concurrent.futures import ThreadPoolExecutor

    import jax

    from libultrahdr_dev.parallel import sharding
    from libultrahdr_dev.utils import counters as _counters
    from libultrahdr_dev.utils import jaxcache

    jaxcache.configure()
    host_env_start = _host_contention_probe()
    dev = jax.devices()[0]
    peaks = device_peaks(dev.device_kind)
    mesh = sharding.default_mesh(jax.devices()[:1])
    boost = 1000 / 203

    ys = np.stack([synth_p010(H, W, seed=i)[0] for i in range(FRAMES)])
    uvs = np.stack([synth_p010(H, W, seed=i)[1] for i in range(FRAMES)])

    def sync(x):
        leaf = jax.tree_util.tree_leaves(x)[-1]
        np.asarray(leaf[(0,) * leaf.ndim])

    # ---- Warmup: compile everything, and verify the packed readback
    # matches the raw fetch bit-for-bit on this content.
    wstats = {}
    pre = sharding.pack_p010_batch_host(ys, uvs)
    ydev, uvdev, _ = sharding.upload_p010_batch(ys, uvs, wstats, pre)
    blobs = sharding.batched_encode_api0(
        ys, uvs, mesh, device_input=(ydev, uvdev), stats=wstats)
    out = sharding.batched_decode(blobs, "hdr_hlg", boost, mesh,
                                  stats=wstats)
    pixels = sharding.fetch_1010102_packed(out, wstats)
    # Verify the packed readback against a device-side checksum
    # (bitwise equality is covered by tests/test_packio.py).
    import jax.numpy as _jnp0

    csum = jax.jit(lambda x: (
        _jnp0.sum(x & 0xFFFF, dtype=_jnp0.uint32),
        _jnp0.sum(x >> 16, dtype=_jnp0.uint32)))
    lo, hi = (int(v) for v in jax.device_get(csum(out)))
    plo = int(pixels.astype(np.uint64).__and__(0xFFFF).sum()
              & 0xFFFFFFFF)
    phi = int((pixels >> 16).astype(np.uint64).sum() & 0xFFFFFFFF)
    assert (lo, hi) == (plo, phi), "packed readback checksum mismatch"

    # ---- Sequential serving loop (for the per-phase split + exact
    # per-round transfer-byte accounting; the host pack of the next batch
    # still overlaps device work).
    ROUNDS = 3
    enc = dec = float("inf")
    stats = {}
    seq_rounds = []
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(sharding.pack_p010_batch_host, ys, uvs)
        for _ in range(ROUNDS):
            t0 = time.perf_counter()
            pre = fut.result()
            fut = pool.submit(sharding.pack_p010_batch_host, ys, uvs)
            rstats = {}
            ydev, uvdev, _ = sharding.upload_p010_batch(
                ys, uvs, rstats, pre)
            blobs = sharding.batched_encode_api0(
                ys, uvs, mesh, device_input=(ydev, uvdev), stats=rstats)
            t1 = time.perf_counter()
            out = sharding.batched_decode(blobs, "hdr_hlg", boost, mesh,
                                          stats=rstats)
            pixels = sharding.fetch_1010102_packed(out, rstats)
            t2 = time.perf_counter()
            seq_rounds.append(round((t2 - t0) * 1000 / FRAMES, 1))
            if (t1 - t0) + (t2 - t1) < enc + dec:
                enc, dec = (t1 - t0) * 1000 / FRAMES, \
                    (t2 - t1) * 1000 / FRAMES
                stats = rstats
    total_seq = enc + dec

    # One synced upload outside the timed loops: h2d_ms in the loop
    # stats is enqueue time by design (the transfer overlaps device
    # work); this records the true wall time of one packed upload. A
    # value the caller exported for UHDR_FETCH_SYNC_STAGES is restored.
    h2d_sync_ms = None
    user_sync = os.environ.get("UHDR_FETCH_SYNC_STAGES")
    try:
        os.environ["UHDR_FETCH_SYNC_STAGES"] = "1"
        sstats = {}
        sharding.upload_p010_batch(ys, uvs, sstats, pre)
        h2d_sync_ms = sstats.get("h2d_ms")
    finally:
        if user_sync is None:
            os.environ.pop("UHDR_FETCH_SYNC_STAGES", None)
        else:
            os.environ["UHDR_FETCH_SYNC_STAGES"] = user_sync

    # ---- Pipelined serving loop (the headline): THREE stages in
    # flight — the next batch's host pack, this batch's upload +
    # device work, and the previous batch's readback fetch + native
    # unpack — so host CPU work and the d2h drain hide under transfer
    # and compute time (the reference's analog is its zero-copy in-process
    # loop, jpegr.cpp:167-247). Steady-state cadence is measured
    # between pixel completions, so warm-up is excluded. The decode
    # consumes the encoder's device-resident streams directly
    # (batched_decode_from_handoff) — the analog of the reference's
    # in-process zero-copy handoff — skipping the blob
    # re-upload; the blob-ingest decode path stays measured by the
    # sequential loop above.
    def _pack_and_upload():
        # Stage 1 does the h2d upload too, so batch N+1's transfer
        # hides under batch N's device work.
        pre = sharding.pack_p010_batch_host(ys, uvs)
        return sharding.upload_p010_batch(ys, uvs, None, pre)

    def _pipelined_loop(out_fmt, fetch_fn, rounds, hostapply=False):
        """Run the 3-stage loop; returns (intervals_ms_per_frame,
        last_fetch_stats, decode_path, pixels). With hostapply=True
        (and the native apply available) the decode emits the integer
        planes composite and the fetch stage ships THAT (~2-4x fewer
        d2h bytes than the packed output pixels), reapplying the
        gain map natively on host (parallel/sharding.py
        decode_batch_hostapply semantics, staged into this loop)."""
        use_ha = hostapply and sharding.hostapply_available(out_fmt)
        dec_fmt = "planes" if use_ha else out_fmt
        t_pix = []
        box = {}
        decode_path = "device-handoff"
        if use_ha:
            decode_path += "+hostapply"

        def _fetch(out_p, scalars):
            # scalars is None when this round fell back to the classic
            # device-apply decode (out_p is pixels, not planes).
            st = {}
            if use_ha and scalars is not None:
                px = sharding.apply_planes_host(
                    sharding.fetch_planes(out_p, st), scalars, H, W,
                    H // 4, W // 4, out_fmt, st)
            else:
                px = fetch_fn(out_p, st)
            return px, st

        # Two fetch workers: batch N's d2h drain (a GIL-released
        # transfer wait) overlaps batch N-1's native unpack/apply (ctypes, GIL
        # released), so the fetch stage costs ~max(transfer, host work)
        # instead of their sum. Futures keep consumption in order.
        with ThreadPoolExecutor(1) as pack_pool, \
                ThreadPoolExecutor(2) as fetch_pool:
            pk = pack_pool.submit(_pack_and_upload)
            fetch_fut = None
            for r in range(rounds):
                ydev, uvdev, _ = pk.result()
                if r + 1 < rounds:  # no dangling work after the last
                    pk = pack_pool.submit(_pack_and_upload)
                blobs_p, handoff = sharding.batched_encode_api0(
                    ys, uvs, mesh, device_input=(ydev, uvdev),
                    return_handoff=True)
                out_p = None
                scalars = None
                if handoff is not None:
                    out_p = sharding.batched_decode_from_handoff(
                        handoff, dec_fmt, boost, mesh)
                    if use_ha and out_p is not None:
                        sc = sharding.handoff_apply_scalars(handoff,
                                                            boost)
                        scalars = np.broadcast_to(
                            sc, (int(out_p.shape[0]), 4))
                if out_p is None:
                    meta = {}
                    if use_ha:
                        out_p = sharding._batched_decode_device(
                            blobs_p, dec_fmt, boost, mesh, False,
                            meta_out=meta)
                    if out_p is not None:
                        decode_path = "blob+hostapply"
                        scalars = meta["scalars"]
                    else:
                        # planes path unavailable for this batch:
                        # classic device-apply decode + packed fetch
                        # (scalars stays None -> _fetch classic arm).
                        decode_path = "blob"
                        out_p = sharding.batched_decode(
                            blobs_p, out_fmt, boost, mesh)
                if fetch_fut is not None:
                    px, box = fetch_fut.result()
                    t_pix.append(time.perf_counter())
                fetch_fut = fetch_pool.submit(_fetch, out_p, scalars)
            px, box = fetch_fut.result()
            t_pix.append(time.perf_counter())
        iv = [round((b - a) * 1000 / FRAMES, 1)
              for a, b in zip(t_pix, t_pix[1:])]
        return iv, box, decode_path, px

    # >=6 steady-state intervals so one lucky/unlucky interval can't
    # carry the headline. The FINAL interval
    # is a flush — its fetch overlaps no subsequent device work, so it
    # runs optimistically fast; it stays in the reported list but is
    # excluded from the median/min.
    # Warm the planes+hostapply kernels/plan caches so the measured
    # intervals are steady-state (first planes decode compiles, first
    # planes fetch runs the two-phase plan).
    ha_ok = sharding.hostapply_available("hdr_hlg")
    if ha_ok:
        ha_px = sharding.decode_batch_hostapply(
            blobs, "hdr_hlg", boost, mesh)
        ha_ok = ha_px is not None
        if ha_ok:
            # Output-parity guard vs the device-apply pixels already
            # fetched (sampled rows; full parity in test_hostapply).
            a, b = ha_px[:, ::64, :], pixels[:, ::64, :]
            for s in (0, 10, 20):
                d = np.abs(((a >> s) & 1023).astype(np.int64)
                           - ((b >> s) & 1023).astype(np.int64))
                assert int(d.max()) <= 1, \
                    f"hostapply parity: code diff {int(d.max())}"

    PIPE_ROUNDS = 8
    pipe_iv, pipe_stats, decode_path, pixels = _pipelined_loop(
        "hdr_hlg", sharding.fetch_1010102_packed, PIPE_ROUNDS,
        hostapply=ha_ok)
    pipe_med = float(np.median(pipe_iv[:-1]))
    pipe_min = float(np.min(pipe_iv[:-1]))
    # Both configurations are real serving loops; the headline takes
    # the faster of sequential best-of-3 and the pipelined MEDIAN
    # interval (median, not min: robust to one lucky interval).
    total = min(total_seq, pipe_med)

    # F16 decode-to-host: the reference's DEFAULT decode output
    # (RGBA_F16, ultrahdr_api.cpp:1287-1289). Raw readback would be
    # ~100 MB/frame; the RCT+Rice bit-pattern pack
    # (sharding.fetch_f16_packed) cuts that. Sequential split first
    # (exact bytes), then the SAME 3-stage pipelined loop as the
    # headline.
    f16_stats = {}
    f16_ms = float("inf")
    out16 = sharding.batched_decode(blobs, "hdr_linear", boost, mesh)
    sharding.fetch_f16_packed(out16)         # warm compile
    for _ in range(2):
        rstats = {}
        t0 = time.perf_counter()
        out16 = sharding.batched_decode(blobs, "hdr_linear", boost,
                                        mesh)
        px16 = sharding.fetch_f16_packed(out16, rstats)
        el = (time.perf_counter() - t0) * 1000 / FRAMES
        if el < f16_ms:
            f16_ms, f16_stats = el, rstats
    assert px16.shape == (FRAMES, H, W, 4)
    F16_PIPE_ROUNDS = 6
    f16_iv, f16_pipe_stats, f16_path, px16p = _pipelined_loop(
        "hdr_linear", sharding.fetch_f16_packed, F16_PIPE_ROUNDS,
        hostapply=sharding.hostapply_available("hdr_linear"))
    f16_pipe_med = float(np.median(f16_iv[:-1]))  # drop flush interval
    assert px16p.shape == (FRAMES, H, W, 4)

    # Decode-to-device (device-serving path: consumers read the
    # decoded planes on device, no host materialization). Sync via a
    # jitted scalar reduction that reads back one element.
    import jax.numpy as _jnp

    scalar_probe = jax.jit(lambda x: x.ravel()[0].astype(_jnp.float32))
    dec_dev = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        out = sharding.batched_decode(blobs, "hdr_hlg", boost, mesh)
        float(scalar_probe(out))
        dec_dev = min(dec_dev, (time.perf_counter() - t0) * 1000 / FRAMES)

    # Device-compute-only times: N frames chained inside ONE dispatch
    # (fori_loop, inputs perturbed per iteration to defeat CSE) so the
    # per-dispatch/sync overhead amortizes away.
    import math

    import jax.numpy as jnp

    from libultrahdr_dev.container import mux, xmp as xmp_mod
    from libultrahdr_dev.jpeg import device_decode as dd
    from libultrahdr_dev.jpeg import device_entropy as de
    from libultrahdr_dev.jpeg.dct import dequant_idct
    from libultrahdr_dev.jpeg.device_entropy import DEFAULT_CHUNK_CAP
    from libultrahdr_dev.ops import gainmap as gm

    NLOOP = 8
    mcus_x, mcus_y = W // 16, H // 16
    yh, yl = sharding.pack_p010_host(ys[0])
    uh, ul = sharding.pack_p010_host(uvs[0])
    dp = [jax.device_put(p) for p in (yh, yl, uh, ul)]
    sync(dp)

    @jax.jit
    def enc_many(yh, yl, uh, ul):
        def body(i, acc):
            yy = sharding._unpack_p010_device(yh + i.astype(jnp.uint8),
                                              yl)
            uu = sharding._unpack_p010_device(uh, ul)
            yz, uz, vz, gz = sharding._encode_one_image_coefs(
                yy, uu, "bt2100", "hlg", 95)
            inter = de.interleave_blocks_device(yz, uz, vz, mcus_x,
                                                mcus_y)
            sw, _, total, _ = de.encode_yuv420_rst_stream(
                inter, sharding.RST_INTERVAL, DEFAULT_CHUNK_CAP)
            gsw, _, gt, _ = de.encode_gray_rst_stream(
                gz, sharding.RST_INTERVAL, DEFAULT_CHUNK_CAP)
            # Consume the sorted streams so XLA can't dead-code-
            # eliminate the compaction sort.
            return (acc + total + gt + sw[0].astype(jnp.int32)
                    + gsw[0].astype(jnp.int32))
        return jax.lax.fori_loop(0, NLOOP, body, jnp.int32(0))

    out2 = enc_many(*dp)
    sync(out2)
    enc_kernel = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        out2 = enc_many(*dp)
        sync(out2)
        enc_kernel = min(enc_kernel,
                         (time.perf_counter() - t0) * 1000 / NLOOP)

    primary, gmapb = mux.extract_primary_and_gainmap(blobs[0])
    ds = dd.parse_device_stream(primary)
    dsg = dd.parse_device_stream(gmapb)
    md = xmp_mod.get_metadata_from_xmp(dsg.xmp)
    # Same inputs the production kernel sees: contiguous destuffed
    # streams + per-lane starts, windows gathered on device.
    bdest = jax.device_put(ds.padded_dest())
    gdest = jax.device_put(dsg.padded_dest())
    bst = jax.device_put(ds.starts_byte)
    gst = jax.device_put(dsg.starts_byte)
    sync((bdest, gdest, bst, gst))
    qb, qc_, qg = ds.qtables[0], ds.qtables[1], dsg.qtables[0]
    apply_k = gm._apply_kernel("hdr_hlg", 4, False)
    sc = (math.log2(md.min_content_boost),
          math.log2(md.max_content_boost), 1.0, md.max_content_boost)

    @jax.jit
    def dec_many(bdest, gdest, bst, gst):
        bwin = jnp.arange(ds.win_len, dtype=jnp.int32)[None, :]
        gwin = jnp.arange(dsg.win_len, dtype=jnp.int32)[None, :]

        def body(i, acc):
            # Data-dependent zero offset: ties each iteration's input
            # to the previous iteration's decode output so XLA can't
            # CSE the loop body, while every lane still decodes the
            # genuine stream (acc is < 8*255, so min(acc, 0) == 0).
            off = jnp.minimum(acc.astype(jnp.int32), 0)
            b = jnp.take(bdest, (bst + off)[:, None] + bwin)
            g = jnp.take(gdest, (gst + off)[:, None] + gwin)
            blocks = dd.decode_rst_chunks(b, ds.restart_interval,
                                          mcus_x * mcus_y, False)
            yz, uz, vz = dd.deinterleave_yuv420_device(blocks, mcus_x,
                                                       mcus_y)
            y8 = dequant_idct(yz, qb, mcus_y * 16, mcus_x * 16)[:H, :W]
            u8 = dequant_idct(uz, qc_, mcus_y * 8,
                              mcus_x * 8)[:H // 2, :W // 2]
            v8 = dequant_idct(vz, qc_, mcus_y * 8,
                              mcus_x * 8)[:H // 2, :W // 2]
            gb = dd.decode_rst_chunks(g, dsg.restart_interval,
                                      dsg.mcus_x * dsg.mcus_y, True)
            gp = dequant_idct(gb[: dsg.mcus_x * dsg.mcus_y], qg,
                              dsg.mcus_y * 8,
                              dsg.mcus_x * 8)[: dsg.height, : dsg.width]
            hdr = apply_k(y8, u8, v8, gp, jnp.float32(sc[0]),
                          jnp.float32(sc[1]), jnp.float32(sc[2]),
                          jnp.float32(sc[3]))
            return acc + (hdr[0, 0] & jnp.uint32(0xFF))
        return jax.lax.fori_loop(0, NLOOP, body, jnp.uint32(0))

    out3 = dec_many(bdest, gdest, bst, gst)
    sync(out3)
    dec_kernel = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        out3 = dec_many(bdest, gdest, bst, gst)
        sync(out3)
        dec_kernel = min(dec_kernel,
                         (time.perf_counter() - t0) * 1000 / NLOOP)

    # Context: measured host<->device bandwidth.
    probe = np.zeros(8 << 20, np.uint8)
    t0 = time.perf_counter()
    d = jax.device_put(probe)
    sync(d)
    h2d_mbps = 8.0 / max(time.perf_counter() - t0, 1e-9)
    t0 = time.perf_counter()
    np.asarray(d)
    d2h_mbps = 8.0 / max(time.perf_counter() - t0, 1e-9)

    f_ms, f_scan_ms, f_bytes = foreign_decode_ms()

    # Roofline context (estimates, not profiler counters): the pixel
    # pipeline is memory-bound, not matmul-bound — the only large
    # matmuls are the kron(D,D) fDCT/IDCT passes. Byte estimates count
    # the main HBM round trips of each fused kernel (unpack + color +
    # gainmap + DCT + entropy select/sort passes).
    npix = W * H
    nsamp = int(npix * 1.5)
    enc_hbm_gb = (nsamp * 2 * 2       # P010 unpack r/w
                  + npix * 4 * 3      # tonemap+gainmap f32 traffic
                  + nsamp * 2 * 4     # fDCT in/out + quant r/w
                  + nsamp * 2 * 6     # entropy units/words/sort passes
                  ) / 1e9
    dec_hbm_gb = (nsamp * 2 * 4       # entropy decode passes
                  + nsamp * 2 * 4     # IDCT in/out
                  + npix * 4 * 2      # apply + pack
                  ) / 1e9
    fdct_tflops = (nsamp / 64) * 64 * 64 * 2 * 3 / 1e12  # bf16x3 kron

    def _xla_cost(jitted, args):
        """XLA's own cost analysis of the compiled kernel, so the
        roofline isn't only hand-estimated. The NLOOP frames chain in
        ONE fori_loop whose body (= one frame) HloCostAnalysis counts
        once — verified empirically — so the module totals are already
        per-frame (plus negligible outside-loop ops). The AOT
        lower/compile path hits the persistent cache."""
        ca = jitted.lower(*args).compile().cost_analysis()
        d = ca[0] if isinstance(ca, (list, tuple)) else ca
        return {"flops": round(float(d.get("flops", 0))),
                "bytes_accessed": round(float(d.get("bytes accessed",
                                                    0)))}

    enc_cost = _xla_cost(enc_many, dp)
    dec_cost = _xla_cost(dec_many, (bdest, gdest, bst, gst))
    roofline = {
        "xla_cost_per_frame": {"encode": enc_cost, "decode": dec_cost},
        "assumed_peaks": {"device_kind": dev.device_kind, **peaks},
        "encode_kernel_hbm_gb_est": round(enc_hbm_gb, 3),
        "encode_kernel_hbm_frac": round(
            enc_hbm_gb / (enc_kernel / 1e3) / peaks["hbm_GBps"], 3),
        "decode_kernel_hbm_gb_est": round(dec_hbm_gb, 3),
        "decode_kernel_hbm_frac": round(
            dec_hbm_gb / (dec_kernel / 1e3) / peaks["hbm_GBps"], 3),
        "fdct_tflop_est": round(fdct_tflops, 4),
        "fdct_bf16_frac_at_kernel_time": round(
            fdct_tflops / (enc_kernel / 1e3) / peaks["bf16_tflops"], 4),
    }
    if enc_cost:
        roofline["encode_hbm_frac_xla"] = round(
            enc_cost["bytes_accessed"] / (enc_kernel / 1e3)
            / (peaks["hbm_GBps"] * 1e9), 3)
    if dec_cost:
        roofline["decode_hbm_frac_xla"] = round(
            dec_cost["bytes_accessed"] / (dec_kernel / 1e3)
            / (peaks["hbm_GBps"] * 1e9), 3)

    result = {
        "metric": "4k_jpegr_encode_decode",
        "value": round(total, 2),
        "unit": "ms",
        "vs_baseline": round(BASELINE_4K_MS / total, 3),
        "detail": {
            "pipelined_ms_per_frame": round(pipe_med, 2),
            "pipelined_min_ms_per_frame": round(pipe_min, 2),
            "pipelined_intervals_ms_per_frame": pipe_iv,
            "pipelined_decode_path": decode_path,
            "sequential_ms_per_frame": round(total_seq, 2),
            "sequential_rounds_ms_per_frame": seq_rounds,
            "encode_ms_per_frame": round(enc, 2),
            "decode_ms_per_frame": round(dec, 2),
            "decode_to_device_ms_per_frame": round(dec_dev, 2),
            "decode_f16_to_host_ms_per_frame": round(f16_ms, 2),
            "decode_f16_pipelined_ms_per_frame": round(f16_pipe_med, 2),
            "decode_f16_pipelined_intervals_ms_per_frame": f16_iv,
            "decode_f16_pipelined_decode_path": f16_path,
            "decode_f16_d2h_bytes_per_frame": round(
                f16_stats.get("d2h_bytes", 0) / FRAMES),
            "decode_f16_d2h_pack": f16_stats.get("d2h_pack", "?"),
            "d2h_stages_seq": stats.get("d2h_stages"),
            "d2h_stages_pipe": pipe_stats.get("d2h_stages"),
            "d2h_stages_f16_pipe": f16_pipe_stats.get("d2h_stages"),
            "pipe_d2h_bytes_per_frame": round(
                pipe_stats.get("d2h_bytes", 0) / FRAMES),
            "pipe_d2h_pack": pipe_stats.get("d2h_pack", "?"),
            "pipe_host_apply_ms_per_frame": round(
                pipe_stats.get("host_apply_ms", 0) / FRAMES, 1),
            "f16_pipe_d2h_bytes_per_frame": round(
                f16_pipe_stats.get("d2h_bytes", 0) / FRAMES),
            "f16_pipe_d2h_pack": f16_pipe_stats.get("d2h_pack", "?"),
            "f16_pipe_host_apply_ms_per_frame": round(
                f16_pipe_stats.get("host_apply_ms", 0) / FRAMES, 1),
            "h2d_upload_ms_seq": stats.get("h2d_ms"),
            "h2d_upload_ms_synced": h2d_sync_ms,
            "encode_device_compute_ms_per_frame": round(enc_kernel, 2),
            "decode_device_compute_ms_per_frame": round(dec_kernel, 2),
            "device_compute_vs_baseline": round(
                BASELINE_4K_MS / (enc_kernel + dec_kernel), 2),
            "frames": FRAMES,
            "device": {"platform": dev.platform,
                       "kind": dev.device_kind,
                       "count": len(jax.devices())},
            "jpegr_bytes": len(blobs[0]),
            "transfer_bytes_per_frame": {
                "h2d": round(stats.get("h2d_bytes", 0) / FRAMES),
                "d2h": round(stats.get("d2h_bytes", 0) / FRAMES),
                "h2d_pack": stats.get("h2d_pack", "?"),
                "d2h_pack": stats.get("d2h_pack", "?"),
            },
            "h2d_MBps": round(h2d_mbps, 1),
            "d2h_MBps": round(d2h_mbps, 1),
            "host_env_start": host_env_start,
            "host_env_end": _host_contention_probe(),
            "foreign_entropy_decode_ms": round(f_ms, 1),
            "foreign_scan_to_device_ms": round(f_scan_ms, 1),
            "foreign_jpeg_bytes": f_bytes,
            "roofline_est": roofline,
            "route_counters": _counters.snapshot(),
            "note": "lossless segment-packed transfers both ways "
                    "(parallel/packio.py) + 3-stage pipelined serving "
                    "loop (host pack N+1 / device work N / readback "
                    "fetch+unpack N-1); pipelined decode consumes the "
                    "encoder's device-resident streams "
                    "(batched_decode_from_handoff) and, when "
                    "*+hostapply, ships the integer planes composite "
                    "and reapplies the gain map natively on host "
                    "(jpeg/native/apply.cpp, <=1-code parity asserted "
                    "in-run) — ~2-4x fewer d2h bytes than packing the "
                    "output pixels; headline = min(sequential "
                    "best-of-3, pipelined MEDIAN interval); "
                    "transfer_bytes_per_frame are the exact bytes "
                    "moved and d2h_stages_* attribute the fetch "
                    "latency per stage",
        },
    }
    assert pixels.shape == (FRAMES, H, W)
    if os.environ.get("UHDR_BENCH_SMALL") == "1":
        result["note_small"] = "UHDR_BENCH_SMALL logic smoke; not 4K"
    print(json.dumps(result))


if __name__ == "__main__":
    sys.exit(main())
