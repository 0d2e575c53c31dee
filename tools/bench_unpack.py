"""Host-side unpack throughput at production size.

Measures the native Rice/MED unpack (the fetch stage's host half) for
the exact shapes the 4K serving loop moves, for both schemes and both
sample widths, on THIS host. Context for the cost-aware scheme pick:
the round-4 on-chip probe showed throughput EWMAs measured at
microbench sizes were ~20x optimistic at production sizes (cache
effects), which made the auto-pick choose MED and spend 6.5 s/batch in
the host unpack — _auto_pick_scheme therefore explores each scheme
once AT THE SERVING SHAPE before trusting the cost model.

Run on CPU: JAX_PLATFORMS=cpu python tools/bench_unpack.py [--small]

--threads additionally sweeps UHDR_UNPACK_THREADS in {1,2,4} for the
MT walkers (uhdr_*_unpack_mt) and prints a threads-vs-time table —
meaningful only on multi-core hosts.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402


def synth_1010102(n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    base = ((yy * 3 + xx * 2) // 5) % 1024
    base = np.broadcast_to(base, (n, h, w)).astype(np.int64)
    noise = rng.integers(-6, 7, (n, h, w))
    r = (base + noise) & 1023
    g = (base * 3 // 4 + noise) & 1023
    b = (base // 2 + noise) & 1023
    return (r | (g << 10) | (b << 20)
            | 0xC0000000).astype(np.uint32)


def synth_f16(n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    base = (((yy + xx) * 7) % 16384).astype(np.int64)
    noise = rng.integers(-15, 16, (n, h, w))
    out = np.zeros((n, h, w, 4), np.uint16)
    out[..., 0] = ((base * 13 + noise) % 30000).astype(np.uint16)
    out[..., 1] = ((base * 11 + noise) % 30000).astype(np.uint16)
    out[..., 2] = ((base * 7 + noise) % 30000).astype(np.uint16)
    out[..., 3] = 0x3C00
    return out


def main():
    import jax

    from libultrahdr_dev.parallel import packio

    small = "--small" in sys.argv
    n, h, w = (1, 256, 512) if small else (4, 2160, 3840)
    reps = 3
    res = {"shape": [n, h, w], "cpu": os.uname().machine,
           "cores": os.cpu_count()}
    if "--threads" in sys.argv:
        # Threads-vs-time for the MT walkers (VERDICT r4 item 6): the
        # bitwise identity is proven by tests on any host; the SPEEDUP
        # needs >1 core, so this mode is wired into CI where runners
        # have 2-4 cores.
        x = synth_1010102(n, h, w)
        xd = jax.device_put(x)
        os.environ["UHDR_FUSED_FETCH"] = "0"
        for nt in (1, 2, 4):
            os.environ["UHDR_UNPACK_THREADS"] = str(nt)
            best = None
            for _ in range(reps):
                out, _ = packio.fetch_rgba1010102_rice(xd)
                u = dict(packio.LAST_FETCH_STAGES).get("unpack")
                if out is not None and u is not None \
                        and (best is None or u < best):
                    best = u
            res[f"mt_unpack_ms_t{nt}"] = best
        os.environ.pop("UHDR_UNPACK_THREADS", None)
        print(json.dumps(res))
        return
    for bits in (10, 16):
        x = synth_1010102(n, h, w) if bits == 10 else synth_f16(n, h, w)
        raw = x.nbytes
        xd = jax.device_put(x)
        for scheme in ("vert", "med"):
            os.environ["UHDR_READBACK_SCHEME"] = scheme
            os.environ["UHDR_FUSED_FETCH"] = "0"
            fn = (packio.fetch_rgba1010102_auto if bits == 10
                  else packio.fetch_rgba_f16_auto)
            best_unpack = None
            wire = None
            for _ in range(reps):
                out, nbytes = fn(xd)
                st = dict(packio.LAST_FETCH_STAGES)
                if out is None:
                    break
                u = st.get("unpack")
                if u is not None and (best_unpack is None
                                      or u < best_unpack):
                    best_unpack = u
                wire = nbytes
            key = f"{scheme}{bits}"
            if best_unpack is None:
                res[key] = None
                continue
            res[key] = {
                "unpack_ms": best_unpack,
                "raw_MBps": round(raw / 2**20 / (best_unpack / 1e3), 1),
                "wire_bytes": wire,
                "wire_frac": round(wire / raw, 3),
            }
        os.environ.pop("UHDR_READBACK_SCHEME", None)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
