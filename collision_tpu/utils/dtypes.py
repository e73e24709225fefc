"""Small dtype / size utilities.

Re-design of the reference's host-side helpers
(/root/reference/collision/misc.py:28-71). The OpenCL-specific pieces
(``dtype_decl`` producing OpenCL C type names, ``Program`` compilation) have no
equivalent — XLA compiles jitted functions — but the arithmetic helpers and
the "a 3-vector occupies 4 slots" padding rule carry over for API parity.
"""

from functools import reduce

import numpy as np


def round_up(x: int, base: int) -> int:
    """Round ``x`` up to the next multiple of ``base``.

    Parity with reference ``roundUp`` (misc.py:28-29; goldens in
    tests/test_misc.py:5-10): round_up(4, 5) == 5, round_up(5, 2) == 6,
    round_up(0, 5) == 0.
    """
    if base <= 0:
        raise ValueError("base must be positive")
    return -(-x // base) * base


# camelCase alias matching the reference spelling, for drop-in familiarity.
roundUp = round_up


def next_power_of_2(x: int) -> int:
    """Smallest power of two >= x (reference ``nextPowerOf2``, misc.py:31-32)."""
    if x < 1:
        raise ValueError("x must be >= 1")
    return 1 << (x - 1).bit_length()


nextPowerOf2 = next_power_of_2


def product(xs) -> int:
    """Product of an iterable; empty product is 1 (reference misc.py:34-35)."""
    return reduce(lambda a, b: a * b, xs, 1)


def padded_vec_width(width: int) -> int:
    """Storage slots for a vector of ``width`` components.

    The reference stores 3-vectors padded to 4 slots (OpenCL float3 rule,
    misc.py:37-49); we keep the same rule so payload shapes round-trip.
    """
    if width == 3:
        return 4
    if width not in (1, 2, 4, 8, 16):
        raise ValueError("Invalid vector width: {}".format(width))
    return width


def dtype_sizeof(dt) -> int:
    """Size in bytes of a numpy dtype under the padded-3-vector rule.

    Parity with reference ``dtype_sizeof`` (misc.py:62-71; goldens in
    tests/test_misc.py:35-46): float32x3 -> 16 bytes, nested sub-arrays
    multiply out, structured dtypes are rejected.
    """
    dt = np.dtype(dt)
    if dt.fields is not None:
        raise TypeError("Structured dtypes are not supported: {}".format(dt))
    if dt.subdtype is None:
        return dt.itemsize
    base, shape = dt.subdtype
    if base.fields is not None:
        raise TypeError("Structured dtypes are not supported: {}".format(dt))
    inner = shape[-1]
    outer = product(shape[:-1])
    if base.subdtype is not None:
        return dtype_sizeof(base) * product(shape)
    return base.itemsize * padded_vec_width(inner) * outer
