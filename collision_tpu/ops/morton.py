"""30-bit Morton (Z-order) encoding of 3D points.

Equivalent of the reference's Morton kernels
(/root/reference/collision/collision.cl:14-40): ``expand_bits`` is the same
multiply-and-mask bit interleave, and ``morton_encode`` reproduces the exact
quantization — normalize into the scene AABB, scale by 2**10 - 1 = 1023, clamp
to [0, 1023], truncating cast to uint32, pack ``(x << 2) + (y << 1) + z``.
Golden values pinned by the reference test suite
(tests/test_collision.py:262-263) are reproduced bit-for-bit.

Everything here is plain jnp — XLA fuses the whole encode into the surrounding
pipeline, so there is no reason for a hand-written kernel.
"""

import jax.numpy as jnp

#: Number of bits per axis in the packed code.
MORTON_BITS = 10

#: Largest representable code: 2**30 - 1. Codes never exceed this, which is
#: what lets sort padding use 0xFFFFFFFF sentinels (reference
#: collision.py:138-142) — we keep the invariant even though XLA sorts any N.
MAX_CODE = (1 << (3 * MORTON_BITS)) - 1


def expand_bits(v):
    """Interleave the low 10 bits of ``v`` with two zero bits.

    Same multiply/mask sequence as the reference (collision.cl:14-20);
    uint32 in, uint32 out, elementwise over any shape.
    """
    v = jnp.asarray(v, jnp.uint32)
    v = (v * jnp.uint32(0x00010001)) & jnp.uint32(0xFF0000FF)
    v = (v * jnp.uint32(0x00000101)) & jnp.uint32(0x0F00F00F)
    v = (v * jnp.uint32(0x00000011)) & jnp.uint32(0xC30C30C3)
    v = (v * jnp.uint32(0x00000005)) & jnp.uint32(0x49249249)
    return v


def morton_encode(coords, lo, hi):
    """Encode points into 30-bit Morton codes over the AABB [lo, hi].

    Args:
      coords: [..., 3] float array of positions.
      lo, hi: [3] float arrays — the scene bounds (componentwise min/max of
        the centers, per reference collision.py:157-159).

    Returns:
      uint32 array of shape coords.shape[:-1], each in [0, MAX_CODE].

    The arithmetic runs in the coordinate dtype. Each point is scaled by
    the reciprocal of the extent, ``((c - lo) * (1 / ext)) * 1023``: one
    correctly rounded reciprocal per axis, then a subtract and two
    multiplies per point, which round the same way on every backend. (A
    per-point ``(c - lo) / ext`` does not: XLA's GPU code divides by a
    broadcast operand through its reciprocal, so the codes of points near a
    quantum boundary would depend on the device.) Degenerate axes
    (hi == lo) quantize to 0 instead of propagating NaN — a defined
    behavior the reference leaves undefined.
    """
    coords = jnp.asarray(coords)
    dt = coords.dtype
    lo = jnp.asarray(lo, dt)
    hi = jnp.asarray(hi, dt)
    scale = jnp.asarray((1 << MORTON_BITS) - 1, dt)

    extent = hi - lo
    safe = extent > 0
    inv = jnp.where(safe, 1 / jnp.where(safe, extent, 1), 0)
    pos = jnp.clip((coords - lo) * inv * scale, 0, scale)
    q = pos.astype(jnp.uint32)

    x = expand_bits(q[..., 0])
    y = expand_bits(q[..., 1])
    z = expand_bits(q[..., 2])
    return (x << 2) + (y << 1) + z
