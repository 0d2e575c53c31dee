"""Seeded synthetic P010 content for benchmarks and device smoke runs."""

from __future__ import annotations

import numpy as np


def synth_p010(h: int, w: int, seed: int = 0):
    """Natural-ish smooth HDR content (band-limited, so entropy coding
    sees realistic coefficient statistics). Returns MSB-aligned u16
    (h, w) luma and (h/2, w) interleaved chroma planes."""
    rng = np.random.default_rng(seed)
    small = rng.integers(64, 940, (h // 32 + 1, w // 32 + 1)).astype(
        np.float32)
    y = np.kron(small, np.ones((32, 32), np.float32))[:h, :w]
    y = (y + np.roll(y, 7, 0) + np.roll(y, 7, 1)) / 3.0
    y10 = np.clip(y, 64, 940).astype(np.uint16) << 6
    uvs = rng.integers(448, 576, (h // 32 + 1, w // 32 + 1)).astype(
        np.float32)
    uv_small = np.kron(uvs, np.ones((16, 32), np.float32))[:h // 2, :w // 2]
    uv = np.empty((h // 2, w), np.uint16)
    uv[:, 0::2] = np.clip(uv_small, 64, 960).astype(np.uint16) << 6
    uv[:, 1::2] = np.clip(uv_small[:, ::-1], 64, 960).astype(np.uint16) << 6
    return y10, uv


def synth_p010_batch(n: int, h: int, w: int):
    """n frames of synth_p010 (seeds 0..n-1), stacked: ((n, h, w),
    (n, h/2, w))."""
    frames = [synth_p010(h, w, seed=i) for i in range(n)]
    return (np.stack([f[0] for f in frames]),
            np.stack([f[1] for f in frames]))
