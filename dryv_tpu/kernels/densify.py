"""Bitmap coefficient ABI -> dense int16 rows, in plain jax.numpy.

The host ships, per frame, a per-MB nonzero bitmap (51 bytes = 408 bits
per MB) and per-MB nonzero values in row order (int8, clipped to +/-127,
``W`` slots per MB).  The dense row is rebuilt with one inclusive
``cumsum`` over the bits (the rank of each nonzero) and one
``take_along_axis`` into the values.  Ranks past ``W`` read 0: such MBs
ship their whole dense row through the overflow channel, and |v| > 127
corrections ride a separate (idx, delta) scatter (unpack_coeffs).
"""
from __future__ import annotations

import jax.numpy as jnp

L = 408        # coefficient row length per MB
NB = 51        # bitmap bytes per MB row (408 bits)
BLK = 128      # the MB count is padded to a multiple of this (npad)


def round_up(x: int, q: int) -> int:
    return (x + q - 1) // q * q


def densify(bmp, vals):
    """(bmp [..., 51] u8, vals [..., W] i8) -> dense [..., 408] i16.

    Bit c of a row sits at byte c >> 3, bit c & 7."""
    W = vals.shape[-1]
    lane = jnp.arange(L, dtype=jnp.int32)
    bytes_i = bmp.astype(jnp.int32)[..., lane >> 3]
    bits = (bytes_i >> (lane & 7)) & 1
    rank = jnp.cumsum(bits, axis=-1, dtype=jnp.int32)     # inclusive
    v = jnp.take_along_axis(vals, jnp.clip(rank - 1, 0, W - 1), axis=-1)
    keep = (bits == 1) & (rank <= W)
    return jnp.where(keep, v.astype(jnp.int16), jnp.int16(0))


def unpack_coeffs(bmp, vals, exc_idx, exc_delta, ovf_idx, ovf_rows):
    """One frame of the wire ABI -> dense [npad, 408] int16 rows.

    bmp [npad, 51] u8, vals [npad, W] i8; exc_idx [E] i32 flat indices
    into the dense rows with exc_delta [E] i16 corrections for |v| > 127
    (padding slots: index 0, delta 0); ovf_idx [O] i32 MB rows replaced
    whole by ovf_rows [O, 408] i16 (padding slots: index npad, dropped)."""
    npad = bmp.shape[0]
    flat = densify(bmp, vals).reshape(npad * L)
    flat = flat.at[exc_idx].add(exc_delta)
    return flat.reshape(npad, L).at[ovf_idx].set(ovf_rows, mode="drop")
