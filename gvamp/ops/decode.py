"""SWAR 2-bit genotype decode on uint32 lanes (JAX/XLA path).

Replaces the reference's 1024-entry gather tables (dotp_lut.hpp:3,1030) with
pure arithmetic on packed words: for bit-pair ``k``,

    c  = (word >> 2k) & 0x03030303          # 4 codes, one per byte lane
    lo = c & 0x01010101 ; hi = (c >> 1) & 0x01010101
    dosage   = ((lo ^ 1) << 1) - (hi & (lo ^ 1))   # {2,0,1,0} per code
    nonmiss  = hi | (lo ^ 1)                        # {1,0,1,1} per code

then a u32 -> 4 x u8 bitcast exposes each byte lane as its own element, in
exactly the planar order defined by :class:`gvamp.ops.layout.PlanarLayout`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

import numpy as np

_M1 = np.uint32(0x01010101)
_M3 = np.uint32(0x03030303)


def _u32_to_u8(x: jax.Array) -> jax.Array:
    """uint32[..., W] -> uint8[..., 4W], little-endian byte order."""
    b = jax.lax.bitcast_convert_type(x, jnp.uint8)  # [..., W, 4]
    return b.reshape(*x.shape[:-1], x.shape[-1] * 4)


def decode_plane(words: jax.Array, k: int) -> tuple[jax.Array, jax.Array]:
    """Decode bit-pair plane ``k`` of packed words.

    Args:
      words: uint32[..., Nw] packed genotypes (16 per word).
      k: bit-pair index in [0, 4).

    Returns:
      (dosage, nonmiss) uint8 arrays of shape [..., 4*Nw] in planar order.
    """
    c = (words >> np.uint32(2 * k)) & _M3
    lo = c & _M1
    hi = (c >> np.uint32(1)) & _M1
    notlo = lo ^ _M1
    a = (notlo << np.uint32(1)) - (hi & notlo)
    b = hi | notlo
    return _u32_to_u8(a), _u32_to_u8(b)


def decode_planar(words: jax.Array, dtype=jnp.float32) -> tuple[jax.Array, jax.Array]:
    """Full planar decode: uint32[M, Nw] -> (a, b) dtype[4, M, Nb]."""
    outs = [decode_plane(words, k) for k in range(4)]
    a = jnp.stack([o[0] for o in outs]).astype(dtype)
    b = jnp.stack([o[1] for o in outs]).astype(dtype)
    return a, b
