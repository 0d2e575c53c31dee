#!/usr/bin/env python
"""Batched JPEG/R serving loop — the batched analog of the reference
demo app's encode/decode driver (examples/ultrahdr_app.cpp).

Three stages stay in flight, the same pattern bench.py measures:

  pack thread     : lossless host pack of batch N+1's P010 planes
  main thread     : upload + fused device encode/decode of batch N
  fetch thread    : packed readback + native unpack of batch N-1

Run on the GPU (default backend) with synthetic 4K frames:

    python examples/serving_loop.py

or anywhere on CPU with small frames:

    python examples/serving_loop.py --cpu --height 64 --width 96
"""
import argparse
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# Runnable as a plain script from anywhere: the package lives one
# directory up from this file.
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def synth_p010(n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    small = rng.integers(64, 940, (n, h // 16 + 1, w // 16 + 1))
    y = np.kron(small, np.ones((1, 16, 16)))[:, :h, :w]
    y = np.clip(y, 64, 940).astype(np.uint16) << 6
    uv = np.full((n, h // 2, w), 512 << 6, np.uint16)
    return y, uv


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (tiny shapes advised)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--height", type=int, default=3072)
    ap.add_argument("--width", type=int, default=4080)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--f16", action="store_true",
                    help="decode to linear RGBA F16 (the reference's "
                         "default decode output) instead of HLG "
                         "RGBA1010102; readback rides the F16 "
                         "bit-pattern Rice pack")
    ap.add_argument("--no-hostapply", action="store_true",
                    help="disable the planes-composite readback + "
                         "native host gain-map apply (the default "
                         "decode-to-host path when the native lib is "
                         "present; ~2-4x fewer d2h bytes)")
    args = ap.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from libultrahdr_dev.parallel import sharding
    from libultrahdr_dev.utils import jaxcache

    jaxcache.configure()

    n, h, w = args.batch, args.height, args.width
    ys, uvs = synth_p010(n, h, w)
    mesh = sharding.default_mesh()
    boost = 1000 / 203
    out_fmt = "hdr_linear" if args.f16 else "hdr_hlg"
    use_ha = (not args.no_hostapply
              and sharding.hostapply_available(out_fmt))
    dec_fmt = "planes" if use_ha else out_fmt
    gw, gh = w // 4, h // 4

    def fetch(out, scalars=None):
        if use_ha and scalars is not None:
            return sharding.apply_planes_host(
                sharding.fetch_planes(out), scalars, h, w, gh, gw,
                out_fmt)
        return (sharding.fetch_f16_packed if args.f16
                else sharding.fetch_1010102_packed)(out)

    def pack_and_upload():
        # Stage 1 includes the h2d upload so the next batch's transfer
        # hides under this batch's device work (in a real service
        # the next batch comes from the request queue; here the same
        # frames loop).
        pre = sharding.pack_p010_batch_host(ys, uvs)
        return sharding.upload_p010_batch(ys, uvs, None, pre)

    t_pix = []
    # Two fetch workers let batch N's d2h drain (a transfer wait) overlap
    # batch N-1's native unpack (ctypes releases the GIL); futures
    # keep the consumption order.
    with ThreadPoolExecutor(1) as pack_pool, \
            ThreadPoolExecutor(2) as fetch_pool:
        pk = pack_pool.submit(pack_and_upload)
        fetch_fut = None
        for r in range(args.rounds):
            ydev, uvdev, _ = pk.result()
            if r + 1 < args.rounds:
                pk = pack_pool.submit(pack_and_upload)
            blobs, handoff = sharding.batched_encode_api0(
                ys, uvs, mesh, device_input=(ydev, uvdev),
                return_handoff=True)
            scalars = None
            if handoff is not None:
                # Decode straight off the encoder's device-resident
                # streams — no blob re-upload (the analog of the
                # reference's zero-copy in-process handoff,
                # jpegr.cpp:167-247).
                out = sharding.batched_decode_from_handoff(
                    handoff, dec_fmt, boost, mesh)
                if use_ha and out is not None:
                    scalars = np.broadcast_to(
                        sharding.handoff_apply_scalars(handoff, boost),
                        (n, 4))
            else:
                out = None
            if out is None:  # rare scatter fallback: decode the blobs
                out = sharding.batched_decode(blobs, out_fmt, boost,
                                              mesh)
                scalars = None
            if fetch_fut is not None:
                pixels = fetch_fut.result()
                t_pix.append(time.perf_counter())
                print(f"round {r - 1}: {pixels.shape} pixels ready, "
                      f"{len(blobs[0])} B/JPEG-R", flush=True)
            fetch_fut = fetch_pool.submit(fetch, out, scalars)
        pixels = fetch_fut.result()
        t_pix.append(time.perf_counter())
        print(f"round {args.rounds - 1}: {pixels.shape} pixels ready")

    if len(t_pix) > 1:
        cadence = (t_pix[-1] - t_pix[0]) / ((len(t_pix) - 1) * n)
        print(f"steady-state cadence: {cadence * 1000:.1f} ms/frame")
    return 0


if __name__ == "__main__":
    sys.exit(main())
