#!/usr/bin/env python
"""Micro-benchmarks mirroring the reference's measurement points:

- ProfileGainMapFuncs (tests/jpegr_test.cpp:2203-2304): generateGainMap
  / applyGainMap ms over 1280x720, mean of 10 iters
- benchmark_test.cpp configs: encode API-0/1 and decode at 12MP
  (4080x3072) and 3MP (2048x1536)

Run on the GPU (default platform) or CPU (JAX_PLATFORMS=cpu).
Usage: python benchmarks/microbench.py [--quick]
"""

import argparse
import os
import sys
import time

import numpy as np

# Runnable as a plain script from anywhere: the package lives one
# directory up from this file.
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def timeit(fn, iters=10, warmup=1):
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1000.0


def synth(h, w, seed=0):
    rng = np.random.default_rng(seed)
    small = rng.integers(64, 940, (h // 32 + 1, w // 32 + 1)).astype(
        np.float32)
    y = np.kron(small, np.ones((32, 32), np.float32))[:h, :w]
    y10 = np.clip(y, 64, 940).astype(np.uint16) << 6
    uv = np.full((h // 2, w), 512 << 6, np.uint16)
    return y10, uv


def decode_units_sweep(iters: int):
    """Time the entropy-decode while_loop at 1..4 units per step on a
    production 4K RST stream. Total per-unit work is invariant — the
    knob only amortizes loop-carried latency — so this directly
    answers the 'is the loop latency-bound' question on real hardware.
    Prints ms per variant; the winner can then be pinned process-wide
    with UHDR_DECODE_UNITS."""
    import jax
    import jax.numpy as jnp
    from libultrahdr_dev.jpeg import device_decode as dd
    from libultrahdr_dev.parallel import sharding
    from libultrahdr_dev.container import mux
    from libultrahdr_dev.jpeg.dct import dequant_idct

    print(f"device: {jax.devices()[0]}")
    w, h = 3840, 2160
    y10, uv = synth(h, w, seed=2)
    mesh = sharding.default_mesh(jax.devices()[:1])
    blob = bytes(sharding.batched_encode_api0(y10[None], uv[None],
                                              mesh)[0])
    primary, _ = mux.extract_primary_and_gainmap(blob)
    ds = dd.parse_device_stream(primary)
    mcus = ds.mcus_x * ds.mcus_y
    dest = jax.device_put(ds.padded_dest())
    st = jax.device_put(ds.starts_byte)
    jax.block_until_ready((dest, st))
    win = np.arange(ds.win_len, dtype=np.int32)[None, :]
    qy = ds.qtables[0]

    results = {}
    for units in (1, 2, 3, 4):
        @jax.jit
        def k(dest, st, _u=units):
            chunks = jnp.take(dest, st[:, None] + win)
            blocks = dd.decode_rst_chunks(chunks, ds.restart_interval,
                                          mcus, False,
                                          units_per_step=_u)
            yz, _, _ = dd.deinterleave_yuv420_device(
                blocks, ds.mcus_x, ds.mcus_y)
            y = dequant_idct(yz, qy, ds.mcus_y * 16, ds.mcus_x * 16)
            return jnp.sum(y.astype(jnp.uint32))

        ref = jax.block_until_ready(k(dest, st))  # compile + warm
        ms = timeit(lambda: jax.block_until_ready(k(dest, st)), iters)
        results[units] = ms
        print(f"decode 4K luma-path units={units}: {ms:.1f} ms "
              f"(checksum {int(ref)})")
    best = min(results, key=results.get)
    print(f"best: UHDR_DECODE_UNITS={best} ({results[best]:.1f} ms)")
    return results


def decode_emit_sweep(iters: int):
    """Time the entropy-decode loop's emission strategies on a
    production 4K RST stream: dense (carried (nc, cb*64) rewrite per
    step) vs log (in-place (key, val) appends + one post-loop
    lower-bound reconstruction), at 1..3 units per step. The dense
    loop's HBM traffic scales with steps x cb*128 B/lane; the log
    loop's is ~constant — which wins is an on-chip question. Winner
    pins UHDR_DECODE_EMIT (+ UHDR_DECODE_UNITS) process-wide."""
    import jax
    import jax.numpy as jnp
    from libultrahdr_dev.jpeg import device_decode as dd
    from libultrahdr_dev.parallel import sharding
    from libultrahdr_dev.container import mux
    from libultrahdr_dev.jpeg.dct import dequant_idct

    print(f"device: {jax.devices()[0]}")
    w, h = 3840, 2160
    y10, uv = synth(h, w, seed=2)
    mesh = sharding.default_mesh(jax.devices()[:1])
    blob = bytes(sharding.batched_encode_api0(y10[None], uv[None],
                                              mesh)[0])
    primary, _ = mux.extract_primary_and_gainmap(blob)
    ds = dd.parse_device_stream(primary)
    mcus = ds.mcus_x * ds.mcus_y
    dest = jax.device_put(ds.padded_dest())
    st = jax.device_put(ds.starts_byte)
    jax.block_until_ready((dest, st))
    win = np.arange(ds.win_len, dtype=np.int32)[None, :]
    qy = ds.qtables[0]

    results = {}
    ref0 = None
    for mode in ("dense", "log"):
        for units in (1, 2, 3):
            @jax.jit
            def k(dest, st, _u=units, _m=mode):
                chunks = jnp.take(dest, st[:, None] + win)
                blocks = dd.decode_rst_chunks(
                    chunks, ds.restart_interval, mcus, False,
                    units_per_step=_u, emit_mode=_m)
                yz, _, _ = dd.deinterleave_yuv420_device(
                    blocks, ds.mcus_x, ds.mcus_y)
                y = dequant_idct(yz, qy, ds.mcus_y * 16, ds.mcus_x * 16)
                return jnp.sum(y.astype(jnp.uint32))

            ref = int(jax.block_until_ready(k(dest, st)))
            ref0 = ref if ref0 is None else ref0
            assert ref == ref0, f"checksum drift {mode}/{units}"
            ms = timeit(lambda: jax.block_until_ready(k(dest, st)),
                        iters)
            results[(mode, units)] = ms
            print(f"decode 4K luma-path emit={mode} units={units}: "
                  f"{ms:.1f} ms (checksum {ref})")
    best = min(results, key=results.get)
    print(f"best: UHDR_DECODE_EMIT={best[0]} UHDR_DECODE_UNITS="
          f"{best[1]} ({results[best]:.1f} ms)")
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--decode-units-sweep", action="store_true",
                    help="sweep units-per-step of the device entropy "
                         "decode loop on a 4K stream, print winner")
    ap.add_argument("--decode-emit-sweep", action="store_true",
                    help="sweep {dense, log} emission x units of the "
                         "device entropy decode loop on a 4K stream, "
                         "print winner")
    args = ap.parse_args()
    iters = 3 if args.quick else 10
    from libultrahdr_dev.utils import jaxcache

    jaxcache.configure()

    if args.decode_units_sweep:
        return decode_units_sweep(max(iters // 2, 3))
    if args.decode_emit_sweep:
        return decode_emit_sweep(max(iters // 2, 3))

    import jax
    from libultrahdr_dev.ops import gainmap as gm
    from libultrahdr_dev.jpegr import JpegR
    from libultrahdr_dev.parallel import sharding
    from libultrahdr_dev.types import (ColorGamut, ColorTransfer,
                                           OutputFormat, PixelFormat,
                                           RawImage)

    print(f"device: {jax.devices()[0]}")
    jr = JpegR()
    mesh = sharding.default_mesh(jax.devices()[:1])

    # --- ProfileGainMapFuncs parity: 1280x720 ---
    w, h = 1280, 720
    y10, uv = synth(h, w)
    y8, u8, v8 = (np.asarray(p) for p in gm.tonemap_p010(y10, uv))

    def gen():
        g, _ = gm.generate_gainmap(y8, u8, v8, y10, uv,
                                   sdr_gamut="bt2100", hdr_gamut="bt2100",
                                   hdr_tf="hlg")
        np.asarray(g)

    print(f"generateGainMap 1280x720: {timeit(gen, iters):.2f} ms "
          f"(reference: 13.0 ms on this host)")

    gmap, md = gm.generate_gainmap(y8, u8, v8, y10, uv,
                                   sdr_gamut="bt2100", hdr_gamut="bt2100",
                                   hdr_tf="hlg")
    gmap = np.asarray(gmap)

    def apply_():
        out = gm.apply_gainmap(y8, u8, v8, gmap, md, "hdr_linear",
                               md.max_content_boost)
        np.asarray(out)

    print(f"applyGainMap 1280x720 (F16 + readback): "
          f"{timeit(apply_, iters):.2f} ms")

    # --- benchmark_test configs ---
    for label, (bw_, bh_) in (("3MP 2048x1536", (2048, 1536)),
                              ("12MP 4080x3072", (4080, 3072))):
        if args.quick and "12MP" in label:
            continue
        y10, uv = synth(bh_, bw_, seed=1)

        def enc():
            sharding.batched_encode_api0(y10[None], uv[None], mesh)

        enc()  # warm/compile
        print(f"encode API-0 {label}: {timeit(enc, max(iters // 2, 2)):.1f} ms")

        blob = sharding.batched_encode_api0(y10[None], uv[None], mesh)[0]

        def dec():
            res = jr.decode(blob, OutputFormat.HDR_HLG, 4.926)
            np.asarray(res.image.planes["rgba"])

        dec()
        print(f"decode->HLG {label}: {timeit(dec, max(iters // 2, 2)):.1f} ms")


if __name__ == "__main__":
    sys.exit(main())
