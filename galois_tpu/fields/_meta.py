"""FieldMeta: the static field descriptor.

The reference implements per-field state as a metaclass (`ArrayMeta`,
reference: src/galois/_domains/_meta.py:22-203). Here that state becomes
a hashable *descriptor* object carried as a static closure into jitted
kernels. The descriptor owns:

- the field parameters (p, m, q, irreducible poly, primitive element),
- the device storage format (single ints, digit vectors, or 16-bit limbs),
- lazily-built host-side constants (EXP/LOG tables, reduction matrices,
  Barrett constants) that kernels embed as jnp constants.

Nothing in this module runs on device.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np

from ..polys._conversions import integer_to_poly, poly_to_integer

# External dtypes permitted for the user-facing representation, identical to
# the reference's master list (reference: src/galois/_domains/_meta.py:19).
DTYPES = [np.uint8, np.uint16, np.uint32, np.int8, np.int16, np.int32, np.int64]

# Fields at or below this order get lookup tables (reference auto rule:
# src/galois/_domains/_meta.py:39-48 uses 2^20).
LOOKUP_TABLE_MAX_ORDER = 2**20

# Storage kinds for device arrays.
STORAGE_INT = "int"        # one unsigned integer per element
STORAGE_DIGITS = "digits"  # (..., m) base-p digit vectors (odd p^m, order > 2^31)
STORAGE_LIMBS = "limbs"    # (L, ...) PLANAR base-2^16 limb vectors (huge primes / GF(2^m), m > 32)
# Limb storage is planar (limb axis LEADING, little-endian): each limb
# plane is a full contiguous (elem_shape) array and slicing a limb is free,
# where a trailing limb axis of 4 would interleave the limbs of every
# element. Digit storage keeps the trailing axis: digit fields interact
# with contractions that want the digit axis minor.

LIMB_BITS = 16
LIMB_BASE = 1 << LIMB_BITS


class FieldMeta:
    """Immutable descriptor of a finite field GF(p^m) plus device-layout info.

    Hash/equality are defined by (p, m, irreducible_poly_int,
    primitive_element_int) so descriptors can key kernel caches.
    """

    def __init__(
        self,
        characteristic: int,
        degree: int,
        irreducible_poly_int: int,
        primitive_element_int: int,
    ):
        p, m = int(characteristic), int(degree)
        self.characteristic = p
        self.degree = m
        self.order = p**m
        self.irreducible_poly_int = int(irreducible_poly_int)
        self.primitive_element_int = int(primitive_element_int)

        self.is_prime_field = m == 1
        self.is_extension_field = m > 1

        # --- device storage layout -------------------------------------
        q = self.order
        if m == 1:
            if q <= 2**32:
                self.storage = STORAGE_INT
            else:
                self.storage = STORAGE_LIMBS
        elif p == 2:
            if m <= 32:
                self.storage = STORAGE_INT
            else:
                self.storage = STORAGE_LIMBS
        else:
            if q <= 2**31:
                self.storage = STORAGE_INT
            else:
                self.storage = STORAGE_DIGITS

        if self.storage == STORAGE_INT:
            self.internal_dtype = np.uint32 if q > 2**16 else (np.uint16 if q > 2**8 else np.uint8)
            self.storage_width = 0  # scalar storage, no trailing axis
        elif self.storage == STORAGE_DIGITS:
            self.internal_dtype = np.uint32
            self.storage_width = m
        else:
            self.internal_dtype = np.uint16
            nbits = (q - 1).bit_length()
            self.storage_width = -(-nbits // LIMB_BITS)

        # True when the storage axis leads (planar limb layout); False for
        # trailing-axis digit storage and scalar int storage.
        self.storage_first = self.storage == STORAGE_LIMBS

        # --- external dtypes (reference parity) ------------------------
        # Valid external dtypes are those that can hold order-1
        # (reference: src/galois/_domains/_meta.py:94-102).
        self.dtypes = [d for d in DTYPES if np.iinfo(d).max >= q - 1]
        if not self.dtypes:
            self.dtypes = [np.object_]

        # --- compile-mode default -------------------------------------
        # The reference defaults to lookup tables for order <= 2^20
        # (reference: src/galois/_domains/_meta.py:39-48) because Numba CPU
        # table reads beat its scalar arithmetic. Here the vectorized
        # calculate kernels are the default everywhere; lookup (XLA table
        # gathers) stays available via compile().
        self.default_ufunc_mode = "jit-calculate"
        # GF(2) has no lookup mode (bitwise ops are already optimal —
        # reference: src/galois/_fields/_gf2.py:155-157).
        self.ufunc_modes = (
            ["jit-lookup", "jit-calculate", "python-calculate"]
            if q <= LOOKUP_TABLE_MAX_ORDER and q > 2
            else ["jit-calculate", "python-calculate"]
        )

        self._key = (p, m, self.irreducible_poly_int, self.primitive_element_int)

    # ------------------------------------------------------------------
    def __hash__(self):
        return hash(self._key)

    def __eq__(self, other):
        return isinstance(other, FieldMeta) and self._key == other._key

    def __repr__(self):
        return f"FieldMeta(GF({self.characteristic}^{self.degree}))"

    @property
    def key(self):
        return self._key

    @property
    def name(self) -> str:
        if self.degree == 1:
            return f"GF({self.characteristic})"
        return f"GF({self.characteristic}^{self.degree})"

    # --- host-side constants ------------------------------------------
    @functools.cached_property
    def irreducible_coeffs(self) -> Tuple[int, ...]:
        """Coefficients of the irreducible polynomial, descending degrees."""
        return tuple(integer_to_poly(self.irreducible_poly_int, self.characteristic, self.degree))

    @functools.cached_property
    def primitive_element_digits(self) -> Tuple[int, ...]:
        """Base-p digits of the primitive element, descending (length m)."""
        return tuple(
            integer_to_poly(self.primitive_element_int, self.characteristic, self.degree - 1)
        ) if self.degree > 1 else (self.primitive_element_int,)

    @functools.cached_property
    def reduction_matrix(self) -> np.ndarray:
        """(m-1, m) matrix R with R[i] = coeffs of x^(m+i) mod f(x), ascending.

        Reduces a 2m-1 coefficient product: out = low + high @ R (mod p),
        where high[i] is the coefficient of x^(m+i). Lets extension-field
        multiply be (conv, then one small matmul) — vectorizable, unlike
        the reference's per-element division loops
        (reference: src/galois/_domains/_calculate.py:288-324).
        """
        p, m = self.characteristic, self.degree
        f = list(self.irreducible_coeffs)  # descending, monic, length m+1
        assert f[0] == 1
        # x^m mod f = -(f[1..m]) ascending
        cur = [(-c) % p for c in f[1:][::-1]]  # ascending coeffs of x^m mod f
        rows = [cur[:]]
        for _ in range(m - 2):
            # multiply by x: shift up; reduce the overflow coefficient
            hi = cur[-1]
            cur = [0] + cur[:-1]
            cur = [(c + hi * rows[0][j]) % p for j, c in enumerate(cur)]
            rows.append(cur[:])
        if m <= 1:
            return np.zeros((0, 1), dtype=np.int64)
        return np.array(rows, dtype=np.int64)

    @functools.cached_property
    def frobenius_matrix(self) -> np.ndarray:
        """(m, m) matrix F over GF(p): digits(x^p) = F @ digits(x) (ascending).

        The Frobenius map a -> a^p is GF(p)-linear; as a matrix it turns
        field_trace / Itoh-Tsujii inversion into small matmuls.
        """
        p, m = self.characteristic, self.degree
        cols = []
        for i in range(m):
            # (x^i)^p = x^(i*p) mod f
            e = i * p
            coeffs = self._x_power_mod_f(e)
            cols.append(coeffs)
        return np.array(cols, dtype=np.int64).T

    def _x_power_mod_f(self, e: int) -> List[int]:
        """Ascending coefficients of x^e mod f(x) over GF(p), length m."""
        p, m = self.characteristic, self.degree
        # Square-and-multiply in GF(p)[x]/f
        def polymulmod(a, b):
            res = [0] * (2 * m - 1)
            for i, ai in enumerate(a):
                if ai:
                    for j, bj in enumerate(b):
                        res[i + j] = (res[i + j] + ai * bj) % p
            R = self.reduction_matrix if m > 1 else None
            low, high = res[:m], res[m:]
            for k, h in enumerate(high):
                if h:
                    for j in range(m):
                        low[j] = (low[j] + h * int(R[k, j])) % p
            return low
        result = [1] + [0] * (m - 1)
        base = ([0, 1] + [0] * (m - 2))[:m] if m > 1 else [0]
        if m == 1:
            # f(x) = x - alpha, so x^e = alpha^e (mod f)
            return [pow(self.primitive_element_int, e, p)]
        for bit in bin(e)[2:]:
            result = polymulmod(result, result)
            if bit == "1":
                result = polymulmod(result, base)
        return result

    # --- limb-field constants -----------------------------------------
    @functools.cached_property
    def limb_count(self) -> int:
        return self.storage_width if self.storage == STORAGE_LIMBS else 0

    @functools.cached_property
    def prime_limbs(self) -> np.ndarray:
        """p as base-2^16 limbs, little-endian, length limb_count."""
        return int_to_limbs(self.characteristic, self.limb_count)

    @functools.cached_property
    def barrett_mu_limbs(self) -> np.ndarray:
        """floor(4^(16*L) / p) as limbs for Barrett reduction (L = limb_count)."""
        L = self.limb_count
        mu = (1 << (2 * LIMB_BITS * L)) // self.characteristic
        return int_to_limbs(mu, L + 1)

    # --- utility -------------------------------------------------------
    def int_to_digits(self, x: int) -> List[int]:
        """Int repr -> base-p digits ascending, length m."""
        p, m = self.characteristic, self.degree
        return [(x // p**i) % p for i in range(m)]

    def digits_to_int(self, digits) -> int:
        p = self.characteristic
        return sum(int(d) * p**i for i, d in enumerate(digits))


def int_to_limbs(x: int, count: int) -> np.ndarray:
    """Python int -> little-endian base-2^16 limb array of length `count`."""
    limbs = []
    for _ in range(count):
        limbs.append(x & (LIMB_BASE - 1))
        x >>= LIMB_BITS
    if x:
        raise OverflowError("integer does not fit in the requested limb count")
    return np.array(limbs, dtype=np.int64)


def limbs_to_int(limbs) -> int:
    x = 0
    for i, l in enumerate(limbs):
        x |= int(l) << (LIMB_BITS * i)
    return x
