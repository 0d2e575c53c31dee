"""Blockwise 8x8 DCT / IDCT + (de)quantization on the device.

Replaces libjpeg's jdct (JDCT_ISLOW) used by the reference's
encoder/decoder wrappers (/root/reference/lib/src/jpegencoderhelper.cpp,
jpegdecoderhelper.cpp). A plane is reshaped into its 8x8 blocks; the
forward 2-D DCT is ONE (64, 64) kron(D, D) matmul over flattened
blocks with a 3-term bf16 split of the constant matrix (3 native bf16
matrix products — see _kron_fdct_bf16_split and docs/kernels.md); the
inverse stays a K=8 einsum at HIGHEST precision (its inputs are not
bf16-exact, and HIGHEST keeps f32 products out of TF32 on the GPU).
Quantization fuses as elementwise ops. Float DCT
(not the integer ISLOW approximation) — output feeds a standard JPEG
bitstream, bit-exactness with libjpeg's DCT is not required.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from .tables import ZIGZAG


def _dct_matrix() -> np.ndarray:
    """Orthonormal 8-point DCT-II matrix: F = D @ x."""
    d = np.zeros((8, 8), np.float64)
    for u in range(8):
        cu = np.sqrt(0.125) if u == 0 else 0.5
        for x in range(8):
            d[u, x] = cu * np.cos((2 * x + 1) * u * np.pi / 16.0)
    return d


_D = _dct_matrix()
_ZIG = np.asarray(ZIGZAG)


def _split_bf16(m: np.ndarray, terms: int):
    """Split an f32 matrix into `terms` bf16 matrices summing to ~m
    (each term is the bf16 rounding of the remaining residual)."""
    out = []
    rem = m.astype(np.float32)
    for _ in range(terms):
        t = rem.astype(jnp.bfloat16)
        out.append(np.asarray(t))
        rem = rem - np.asarray(t, np.float32)
    return out


def _kron_fdct_bf16_split():
    """The 2-D 8x8 DCT as ONE (64, 64) matrix (kron(D, D)) acting on
    flattened blocks, with the constant matrix split into three bf16
    terms M = M0 + M1 + M2 (each the bf16 rounding of the residual).

    Why: the kron form contracts K=64 instead of K=8, and because
    level-shifted JPEG samples are integers in [-128, 127] — exactly
    representable in bf16 — the split gives 3 native bf16 products
    with f32 accumulation whose only error is the ~2^-25-relative
    residual of the constant matrix (orders of magnitude below the 0.5
    quantization-rounding threshold). Whether one f32 matmul at
    HIGHEST is as fast on the H100 is an open measurement (ROADMAP
    speed item 9).

    Columns are pre-permuted into zigzag order so the matmul output
    feeds the entropy coder directly.
    """
    m = np.kron(_D, _D).astype(np.float32).T  # (xy, uv)
    return tuple(_split_bf16(m[:, _ZIG], 3))


_KRON_ZIG_SPLIT = _kron_fdct_bf16_split()


def fdct_zigzag(plane_u8, q_zig):
    """Traceable fDCT + quantization: u8 plane (dims multiple of 8) ->
    int16 (nblocks, 64) quantized coefficients in zigzag order.
    q_zig: (64,) f32 quant table already in zigzag order."""
    x = (plane_u8.astype(jnp.int16) - 128).astype(jnp.bfloat16)
    xb = plane_to_blocks(x).reshape(-1, 64)
    dot = partial(jnp.dot, preferred_element_type=jnp.float32)
    m0, m1, m2 = _KRON_ZIG_SPLIT
    c = dot(xb, m0) + dot(xb, m1) + dot(xb, m2)
    return jnp.round(c / q_zig.reshape(1, 64)).astype(jnp.int16)


def plane_to_blocks(plane):
    """(H, W) -> (H//8 * W//8, 8, 8) row-major block order."""
    h, w = plane.shape
    x = plane.reshape(h // 8, 8, w // 8, 8)
    return x.transpose(0, 2, 1, 3).reshape(-1, 8, 8)


def blocks_to_plane(blocks, h: int, w: int):
    x = blocks.reshape(h // 8, w // 8, 8, 8)
    return x.transpose(0, 2, 1, 3).reshape(h, w)


@lru_cache(maxsize=None)
def _fdct_kernel(h: int, w: int):
    zig = _ZIG

    @jax.jit
    def kernel(plane_u8, qtable):
        q_zig = qtable.astype(jnp.float32).reshape(64)[zig]
        return fdct_zigzag(plane_u8, q_zig)

    return kernel


def fdct_quant(plane_u8, qtable_natural) -> jnp.ndarray:
    """u8 plane (dims multiple of 8) -> int16 (nblocks, 64) zigzag
    quantized coefficients."""
    h, w = plane_u8.shape
    assert h % 8 == 0 and w % 8 == 0, (h, w)
    return _fdct_kernel(h, w)(jnp.asarray(plane_u8),
                              jnp.asarray(qtable_natural, jnp.int32))


@lru_cache(maxsize=None)
def _idct_kernel(h: int, w: int):
    d = np.asarray(_D, np.float32)
    inv_zig = np.argsort(_ZIG)

    @jax.jit
    def kernel(zig_coefs_i16, qtable):
        nat = zig_coefs_i16[:, inv_zig].astype(jnp.float32)
        q = qtable.astype(jnp.float32).reshape(1, 64)
        blocks = (nat * q).reshape(-1, 8, 8)
        # X = D^T F D: contract D over its first (frequency) axis.
        pix = jnp.einsum("ux,nuv,vy->nxy", d, blocks, d,
                         precision=jax.lax.Precision.HIGHEST,
                         preferred_element_type=jnp.float32)
        pix = jnp.clip(jnp.round(pix + 128.0), 0, 255).astype(jnp.uint8)
        return blocks_to_plane(pix, h, w)

    return kernel


def dequant_idct(zig_coefs_i16, qtable_natural, h: int, w: int):
    """int16 (nblocks, 64) zigzag coefficients -> u8 plane (h, w),
    dims multiple of 8."""
    assert h % 8 == 0 and w % 8 == 0, (h, w)
    return _idct_kernel(h, w)(jnp.asarray(zig_coefs_i16),
                              jnp.asarray(qtable_natural, jnp.int32))
