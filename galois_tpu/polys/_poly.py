"""Univariate polynomials over Galois fields.

API parity with the reference's `Poly` (reference: src/galois/_polys/_poly.py:32).
Architecture differs: coefficient arithmetic for construction-time work runs
host-side on exact Python ints (polys/_hostpoly.py) — polynomials are
trace-time objects in a device program. Batched device kernels are used where
arrays get large: evaluation over element arrays (Horner via lax.scan),
root-finding (Chien scan over powers of alpha), and NTT-based multiplication
(ops/_ntt.py) for high degrees.

Like the reference, three internal representations are used per instance
(reference: src/galois/_polys/_poly.py:56-68): "dense" (int-repr coefficient
list), "binary" (GF(2)[x] packed into one Python int), and "sparse"
({degree: coeff} dict, for astronomically large degrees).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np

from .._options import get_printoptions
from . import _binary as bp
from . import _hostpoly as hp
from ._conversions import (
    integer_to_poly,
    poly_to_integer,
    sparse_poly_to_integer,
    sparse_poly_to_str,
    str_to_sparse_poly,
)

__all__ = ["Poly"]

# Density threshold below which Random/Degrees-constructed polys use the
# sparse representation (reference: src/galois/_polys/_poly.py:26-28).
SPARSE_VS_DENSE_POLY_FACTOR = 0.0125
SPARSE_VS_DENSE_POLY_MIN_COEFFS = int(1 / SPARSE_VS_DENSE_POLY_FACTOR)


def _default_field():
    from ..fields import GF2

    return GF2


# Host synthetic division / schoolbook multiply are Python-int loops; above
# this many coefficient operations the work moves to the device kernels
# (ops/_poly_div.py scan divmod, ops/_convolve.py product).
_DEVICE_POLY_WORK = 1 << 17


def _use_device_poly_ops(field) -> bool:
    return field._mode != "python-calculate"


def _field_of(field):
    if field is None:
        return _default_field()
    from ..fields._array import FieldArray

    if not (isinstance(field, type) and issubclass(field, FieldArray)):
        raise TypeError(
            f"Argument 'field' must be a FieldArray subclass, not {field!r}."
        )
    return field


class Poly:
    """A univariate polynomial f(x) over GF(p^m)."""

    __slots__ = ("_field", "_degrees", "_coeffs", "_type", "_int")

    def __init__(self, coeffs, field=None, order: str = "desc"):
        from ..fields._array import FieldArray

        if isinstance(coeffs, Poly):
            self._field = coeffs._field if field is None else field
            self._degrees = coeffs._degrees
            self._coeffs = coeffs._coeffs
            self._type = coeffs._type
            self._int = coeffs._int
            return

        if isinstance(coeffs, FieldArray) and field is None:
            field = type(coeffs)
        field = _field_of(field)

        if isinstance(coeffs, FieldArray):
            clist = [int(v) for v in np.asarray(coeffs, dtype=object).reshape(-1)]
        elif isinstance(coeffs, (list, tuple, np.ndarray)):
            arr = np.asarray(coeffs, dtype=object).reshape(-1)
            clist = []
            for v in arr:
                if not isinstance(v, (int, np.integer)):
                    raise TypeError(
                        f"Argument 'coeffs' must contain integers or field "
                        f"elements, not {type(v).__name__} ({v!r})."
                    )
                v = int(v)
                if v < 0:
                    # Negative coefficients mean field negation (reference
                    # convention: -3 == -GF(3)).
                    v = _hf(field).negative((-v) % field.order)
                clist.append(v)
        else:
            raise TypeError(f"Argument 'coeffs' must be array-like, not {type(coeffs)}.")

        if order not in ("desc", "asc"):
            raise ValueError(f"Argument 'order' must be 'desc' or 'asc', not {order!r}.")
        if order == "asc":
            clist = clist[::-1]

        self._field = field
        self._init_dense(clist)

    # -- internal initializers --
    def _init_dense(self, clist_desc):
        if self._field.order == 2:
            v = 0
            n = len(clist_desc)
            for i, c in enumerate(clist_desc):
                if c:
                    v |= 1 << (n - 1 - i)
            self._init_binary(v)
            return
        # strip leading zeros
        while len(clist_desc) > 1 and clist_desc[0] == 0:
            clist_desc = clist_desc[1:]
        self._type = "dense"
        self._int = None
        degree = len(clist_desc) - 1
        self._degrees = tuple(range(degree, -1, -1))
        self._coeffs = tuple(clist_desc)
        self._compact()

    def _init_binary(self, v: int):
        """GF(2)[x]: the whole polynomial is one packed Python int
        (reference: src/galois/_polys/_binary.py). Term tuples materialize
        lazily via _ensure_terms()."""
        self._type = "binary"
        self._int = v
        self._degrees = None
        self._coeffs = None

    @classmethod
    def _from_int2(cls, v: int, field) -> "Poly":
        obj = object.__new__(cls)
        obj._field = field
        obj._init_binary(v)
        return obj

    def _ensure_terms(self) -> "Poly":
        """Materialize (_degrees, _coeffs) for a binary poly; no-op otherwise."""
        if self._degrees is None:
            v = self._int
            degs = []
            while v:
                lsb = v & -v
                degs.append(lsb.bit_length() - 1)
                v ^= lsb
            if degs:
                self._degrees = tuple(reversed(degs))
                self._coeffs = (1,) * len(degs)
            else:
                self._degrees, self._coeffs = (0,), (0,)
        return self

    def _compact(self):
        nz = [(d, c) for d, c in zip(self._degrees, self._coeffs) if c != 0]
        if not nz:
            self._degrees, self._coeffs = (0,), (0,)
            return
        self._degrees = tuple(d for d, _ in nz)
        self._coeffs = tuple(c for _, c in nz)

    @classmethod
    def _from_sparse(cls, degrees, coeffs, field) -> "Poly":
        obj = object.__new__(cls)
        obj._field = field
        if field.order == 2:
            v = 0
            for d, c in zip(degrees, coeffs):
                if c:
                    v |= 1 << int(d)
            obj._init_binary(v)
            return obj
        pairs = sorted(
            ((int(d), int(c)) for d, c in zip(degrees, coeffs) if c != 0),
            key=lambda t: -t[0],
        )
        if not pairs:
            pairs = [(0, 0)]
        obj._int = None
        obj._degrees = tuple(d for d, _ in pairs)
        obj._coeffs = tuple(c for _, c in pairs)
        obj._type = "sparse" if obj._is_sparse_worthy() else "dense"
        return obj

    def _is_sparse_worthy(self) -> bool:
        deg = self._degrees[0]
        return deg + 1 >= SPARSE_VS_DENSE_POLY_MIN_COEFFS and len(self._degrees) / (deg + 1) <= SPARSE_VS_DENSE_POLY_FACTOR

    # ------------------------------------------------------------------
    # Alternate constructors (reference: src/galois/_polys/_poly.py:133-617)
    # ------------------------------------------------------------------

    @classmethod
    def Like(cls, poly_like, field=None) -> "Poly":
        """Construct a Poly from any PolyLike object (int => integer repr,
        str => poly string, sequence/array => coefficients, Poly => itself).
        Reference semantics: src/galois/_polys/_poly.py:134-169."""
        from ..fields._array import FieldArray

        if isinstance(poly_like, (int, np.integer)):
            return cls.Int(int(poly_like), field=field)
        if isinstance(poly_like, str):
            return cls.Str(poly_like, field=field)
        if isinstance(poly_like, (tuple, list, np.ndarray, FieldArray)):
            return cls(poly_like, field=field)
        if isinstance(poly_like, Poly):
            return poly_like
        raise TypeError(
            f"A 'poly-like' object must be an int, str, tuple, list, np.ndarray, or Poly, "
            f"not {type(poly_like)}."
        )

    @classmethod
    def Zero(cls, field=None) -> "Poly":
        return cls([0], field=field)

    @classmethod
    def One(cls, field=None) -> "Poly":
        return cls([1], field=field)

    @classmethod
    def Identity(cls, field=None) -> "Poly":
        return cls([1, 0], field=field)

    @classmethod
    def Random(cls, degree: int, seed=None, field=None) -> "Poly":
        field = _field_of(field)
        degree = int(degree)
        rng = np.random.default_rng(seed)
        q = field.order
        if q <= 2**62:
            coeffs = rng.integers(0, q, size=degree + 1, dtype=np.int64).astype(object)
        else:
            coeffs = np.array(
                [int(rng.integers(0, 2**62)) * q // 2**62 for _ in range(degree + 1)],
                dtype=object,
            )
        while coeffs[0] == 0:
            coeffs[0] = (
                int(rng.integers(1, q)) if q <= 2**62 else 1 + int(rng.integers(0, 2**62)) * (q - 1) // 2**62
            )
        return cls(coeffs, field=field)

    @classmethod
    def Str(cls, string: str, field=None) -> "Poly":
        field = _field_of(field)
        degrees, coeffs = str_to_sparse_poly(string)
        p = field.characteristic
        hf = _hf(field)
        conv = []
        for c in coeffs:
            if c < 0:
                conv.append(hf.negative((-c) % field.order))
            else:
                conv.append(c)
        return cls.Degrees(degrees, conv, field=field)

    @classmethod
    def Int(cls, integer: int, field=None) -> "Poly":
        field = _field_of(field)
        integer = int(integer)
        if integer < 0:
            raise ValueError(f"Argument 'integer' must be non-negative, not {integer}.")
        if field.order == 2:
            return cls._from_int2(integer, field)
        return cls(integer_to_poly(integer, field.order), field=field)

    @classmethod
    def Degrees(cls, degrees, coeffs=None, field=None) -> "Poly":
        field = _field_of(field)
        degrees = [int(d) for d in np.asarray(degrees, dtype=object).reshape(-1)]
        if coeffs is None:
            coeffs = [1] * len(degrees)
        else:
            coeffs = [int(c) for c in np.asarray(coeffs, dtype=object).reshape(-1)]
        if len(degrees) != len(coeffs):
            raise ValueError("Arguments 'degrees' and 'coeffs' must have equal length.")
        if any(d < 0 for d in degrees):
            raise ValueError("Argument 'degrees' must be non-negative.")
        hf = _hf(field)
        coeffs = [hf.negative((-c) % field.order) if c < 0 else c for c in coeffs]
        return cls._from_sparse(degrees, coeffs, field)

    @classmethod
    def Roots(cls, roots, multiplicities=None, field=None) -> "Poly":
        from ..fields._array import FieldArray

        if isinstance(roots, FieldArray) and field is None:
            field = type(roots)
        field = _field_of(field)
        roots = [int(r) for r in np.asarray(field(roots), dtype=object).reshape(-1)]
        if multiplicities is None:
            multiplicities = [1] * len(roots)
        F = _hf(field)
        result = [1]
        for r, mult in zip(roots, multiplicities):
            factor = [F.negative(r), 1]  # (x - r), ascending
            for _ in range(int(mult)):
                result = hp.mul(F, result, factor)
        return cls(result[::-1], field=field)

    # ------------------------------------------------------------------
    # Properties
    # ------------------------------------------------------------------

    @property
    def field(self):
        return self._field

    @property
    def degree(self) -> int:
        if self._type == "binary":
            return max(self._int.bit_length() - 1, 0)
        return int(self._degrees[0]) if self._coeffs != (0,) else 0

    @property
    def nonzero_degrees(self) -> np.ndarray:
        self._ensure_terms()
        if self._coeffs == (0,):
            return np.array([], dtype=np.int64)
        return np.array(self._degrees, dtype=np.int64)

    @property
    def nonzero_coeffs(self):
        self._ensure_terms()
        if self._coeffs == (0,):
            return self._field([])
        return self._field(list(self._coeffs))

    @property
    def degrees(self) -> np.ndarray:
        return np.arange(self.degree, -1, -1)

    @property
    def coeffs(self):
        if self._type == "sparse" and self.degree > 10**6:
            raise ValueError(
                "The dense coefficient array of a sparse polynomial with degree "
                f"{self.degree} is too large to materialize."
            )
        self._ensure_terms()
        out = [0] * (self.degree + 1)
        for d, c in zip(self._degrees, self._coeffs):
            out[self.degree - d] = c
        return self._field(out)

    def coefficients(self, size: Optional[int] = None, order: str = "desc"):
        """Dense coefficients, optionally zero-padded to `size`
        (reference: src/galois/_polys/_poly.py:618-679)."""
        self._ensure_terms()
        n = self.degree + 1
        size = n if size is None else int(size)
        if size < n:
            raise ValueError(f"Argument 'size' must be >= {n}, not {size}.")
        out = [0] * size
        for d, c in zip(self._degrees, self._coeffs):
            out[size - 1 - d] = c
        if order == "asc":
            out = out[::-1]
        return self._field(out)

    @property
    def is_monic(self) -> bool:
        if self._type == "binary":
            return self._int != 0
        return self._coeffs[0] == 1

    @property
    def is_zero(self) -> bool:
        if self._type == "binary":
            return self._int == 0
        return self._coeffs == (0,)

    @property
    def is_one(self) -> bool:
        if self._type == "binary":
            return self._int == 1
        return self._degrees == (0,) and self._coeffs == (1,)

    # ------------------------------------------------------------------
    # Conversions
    # ------------------------------------------------------------------

    def __int__(self) -> int:
        if self._type == "binary":
            return self._int
        return sparse_poly_to_integer(self._degrees, self._coeffs, self._field.order)

    def __index__(self) -> int:
        return int(self)

    def __str__(self) -> str:
        self._ensure_terms()
        return sparse_poly_to_str(self._degrees, self._coeffs)

    def __repr__(self) -> str:
        return f"Poly({self}, {self._field.name})"

    def __hash__(self):
        if self._type == "binary":
            return hash((self._field.order, self._int))
        return hash((self._field.order, self._degrees, self._coeffs))

    def reverse(self) -> "Poly":
        """x^d * f(1/x) (reference: src/galois/_polys/_poly.py:680-705)."""
        if self._type == "binary":
            return Poly._from_int2(bp.reverse(self._int), self._field)
        d = self.degree
        return Poly._from_sparse(
            [d - dd for dd in self._degrees], self._coeffs, self._field
        )

    # ------------------------------------------------------------------
    # Host arithmetic (exact, trace-time)
    # ------------------------------------------------------------------

    def _asc(self):
        """Ascending dense coefficient list of Python ints."""
        self._ensure_terms()
        out = [0] * (self.degree + 1)
        for d, c in zip(self._degrees, self._coeffs):
            out[d] = c
        return out

    @classmethod
    def _from_asc(cls, coeffs_asc, field) -> "Poly":
        return cls(coeffs_asc[::-1], field=field)

    def _check_same_field(self, other) -> "Poly":
        other = _coerce_poly(other, self._field)
        if other._field.order != self._field.order or other._field._meta != self._field._meta:
            raise TypeError(
                f"Polynomials are over different fields: {self._field.name} and {other._field.name}."
            )
        return other

    def __add__(self, other):
        other = self._check_same_field(other)
        if self._type == "binary" and other._type == "binary":
            return Poly._from_int2(self._int ^ other._int, self._field)
        F = _hf(self._field)
        self._ensure_terms(), other._ensure_terms()
        if self._type == "sparse" or other._type == "sparse":
            merged = dict(zip(self._degrees, self._coeffs))
            for d, c in zip(other._degrees, other._coeffs):
                merged[d] = F.add(merged.get(d, 0), c)
            return Poly._from_sparse(list(merged), list(merged.values()), self._field)
        return Poly._from_asc(hp.add(F, self._asc(), other._asc()), self._field)

    def __radd__(self, other):
        return self.__add__(other)

    def __neg__(self):
        if self._type == "binary":
            return self  # -f == f in characteristic 2; Poly is immutable
        F = _hf(self._field)
        return Poly._from_sparse(
            self._degrees, [F.negative(c) for c in self._coeffs], self._field
        )

    def __sub__(self, other):
        other = self._check_same_field(other)
        return self.__add__(-other)

    def __rsub__(self, other):
        other = self._check_same_field(other)
        return other.__add__(-self)

    def __mul__(self, other):
        from ..fields._array import FieldArray

        if isinstance(other, (int, np.integer)) and not isinstance(other, bool):
            # integer scalar: repeated addition
            s = int(other) % self._field.characteristic
            if self._type == "binary":
                return self if s else Poly._from_int2(0, self._field)
            F = _hf(self._field)
            return Poly._from_sparse(
                self._degrees, [F.multiply(c, s) for c in self._coeffs], self._field
            )
        if isinstance(other, FieldArray) and other.ndim == 0:
            s = int(other)
            if self._type == "binary":
                return self if s else Poly._from_int2(0, self._field)
            F = _hf(self._field)
            return Poly._from_sparse(
                self._degrees, [F.multiply(c, s) for c in self._coeffs], self._field
            )
        other = self._check_same_field(other)
        if self._type == "binary" and other._type == "binary":
            return Poly._from_int2(bp.multiply(self._int, other._int), self._field)
        F = _hf(self._field)
        self._ensure_terms(), other._ensure_terms()
        if self._type == "sparse" or other._type == "sparse":
            out = {}
            for d1, c1 in zip(self._degrees, self._coeffs):
                for d2, c2 in zip(other._degrees, other._coeffs):
                    d = d1 + d2
                    out[d] = F.add(out.get(d, 0), F.multiply(c1, c2))
            return Poly._from_sparse(list(out), list(out.values()), self._field)
        if _use_device_poly_ops(self._field) and (self.degree + 1) * (other.degree + 1) >= _DEVICE_POLY_WORK:
            # Large dense product: device convolution (NTT fast path when
            # the field admits one) instead of the O(n*m) host loop.
            from ..ops._convolve import convolve

            c = convolve(self._field(self.coefficients()), self._field(other.coefficients()))
            return Poly(c)
        return Poly._from_asc(hp.mul(F, self._asc(), other._asc()), self._field)

    def __rmul__(self, other):
        return self.__mul__(other)

    def __divmod__(self, other):
        other = self._check_same_field(other)
        if self._type == "binary" and other._type == "binary":
            q, r = bp.divmod_(self._int, other._int)
            return Poly._from_int2(q, self._field), Poly._from_int2(r, self._field)
        if (
            self._type == "dense"
            and other._type == "dense"
            and _use_device_poly_ops(self._field)
            and (self.degree - other.degree + 1) * (other.degree + 1) >= _DEVICE_POLY_WORK
        ):
            from ..ops._poly_div import poly_divmod_device

            return poly_divmod_device(self, other)
        F = _hf(self._field)
        q, r = hp.divmod_(F, self._asc(), other._asc())
        return Poly._from_asc(q, self._field), Poly._from_asc(r, self._field)

    def __rdivmod__(self, other):
        other = self._check_same_field(other)
        return other.__divmod__(self)

    def __floordiv__(self, other):
        return self.__divmod__(other)[0]

    def __rfloordiv__(self, other):
        other = self._check_same_field(other)
        return other.__divmod__(self)[0]

    def __truediv__(self, other):
        # Reference parity (src/galois/_polys/_poly.py:1361-1372): fractional
        # polynomials are unsupported, true division always raises.
        raise NotImplementedError(
            "Polynomial true division is not supported because fractional "
            "polynomials are not supported. Use floor division //, modulo %, "
            "and/or divmod() instead."
        )

    def __rtruediv__(self, other):
        raise NotImplementedError(
            "Polynomial true division is not supported because fractional "
            "polynomials are not supported. Use floor division //, modulo %, "
            "and/or divmod() instead."
        )

    def __len__(self) -> int:
        """Length of the coefficient array, degree + 1
        (reference: src/galois/_polys/_poly.py:1104-1120)."""
        return self.degree + 1

    def __mod__(self, other):
        other = self._check_same_field(other)
        if self._type == "binary" and other._type == "binary":
            return Poly._from_int2(bp.mod(self._int, other._int), self._field)
        if (
            self._type == "dense"
            and other._type == "dense"
            and _use_device_poly_ops(self._field)
            and (self.degree - other.degree + 1) * (other.degree + 1) >= _DEVICE_POLY_WORK
        ):
            from ..ops._poly_div import poly_divmod_device

            return poly_divmod_device(self, other)[1]
        F = _hf(self._field)
        if self._type == "sparse":
            # Reduce term by term: x^d mod other via repeated squaring.
            m_asc = other._asc()
            acc = [0]
            for d, c in zip(self._degrees, self._coeffs):
                xd = hp.pow_mod(F, [0, 1], d, m_asc)
                acc = hp.add(F, acc, hp.scalar_mul(F, xd, c))
            return Poly._from_asc(hp.mod(F, acc, m_asc), self._field)
        return Poly._from_asc(hp.mod(F, self._asc(), other._asc()), self._field)

    def __rmod__(self, other):
        other = self._check_same_field(other)
        return other.__mod__(self)

    def __pow__(self, exponent, modulus=None):
        e = int(exponent)
        if e < 0:
            raise ValueError(f"Argument 'exponent' must be non-negative, not {e}.")
        if self._type == "binary":
            if modulus is not None:
                modulus = self._check_same_field(modulus)
                return Poly._from_int2(bp.pow_mod(self._int, e, modulus._int), self._field)
            return Poly._from_int2(bp.pow_(self._int, e), self._field)
        F = _hf(self._field)
        if modulus is not None:
            modulus = self._check_same_field(modulus)
            # Large-modulus square-and-multiply: each squaring is a
            # (deg_m)^2-work product + reduction, so route the whole ladder
            # through Poly.__mul__ / __mod__, which dispatch to the device
            # convolution / scan-divmod kernels above _DEVICE_POLY_WORK
            # (reference keeps this JIT-resident too: _polys/_dense.py:323-401).
            deg_m = modulus.degree
            if (
                _use_device_poly_ops(self._field)
                and deg_m * deg_m >= _DEVICE_POLY_WORK
                and e > 1
            ):
                result = Poly.One(self._field)
                base = self % modulus
                while e:
                    if e & 1:
                        result = (result * base) % modulus
                    e >>= 1
                    if e:
                        base = (base * base) % modulus
                return result
            out = hp.pow_mod(F, self._asc(), e, modulus._asc())
            return Poly._from_asc(out, self._field)
        if self._degrees == (0,) or len(self._degrees) == 1:
            # monomial fast path: (c x^d)^e = c^e x^(d e)
            d, c = self._degrees[0], self._coeffs[0]
            return Poly._from_sparse([d * e], [F.power(c, e)], self._field)
        # Unreduced ladder: final degree is deg*e, so the last squaring does
        # ~(deg*e/2)^2 host coefficient ops — route big ladders through the
        # device product the same way.
        if (
            _use_device_poly_ops(self._field)
            and e > 1
            and (self.degree * e) ** 2 >= 4 * _DEVICE_POLY_WORK
        ):
            result = Poly.One(self._field)
            base = self
            while e:
                if e & 1:
                    result = result * base
                e >>= 1
                if e:
                    base = base * base
            return result
        result = [1]
        base = self._asc()
        while e:
            if e & 1:
                result = hp.mul(F, result, base)
            base = hp.mul(F, base, base)
            e >>= 1
        return Poly._from_asc(result, self._field)

    def __eq__(self, other) -> bool:
        try:
            other = _coerce_poly(other, self._field)
        except (TypeError, ValueError):
            return NotImplemented
        if self._field._meta != other._field._meta:
            return False
        if self._type == "binary" and other._type == "binary":
            return self._int == other._int
        self._ensure_terms(), other._ensure_terms()
        return self._degrees == other._degrees and self._coeffs == other._coeffs

    def __ne__(self, other) -> bool:
        eq = self.__eq__(other)
        return NotImplemented if eq is NotImplemented else not eq

    # ------------------------------------------------------------------
    # Evaluation / calculus
    # ------------------------------------------------------------------

    def __call__(self, at, field=None, elementwise: bool = True):
        """Evaluate at field elements / arrays / square matrices / polys
        (reference: src/galois/_polys/_poly.py:1021-1103)."""
        if isinstance(at, Poly):
            # composition f(g)
            self._ensure_terms()
            F = _hf(self._field)
            result = Poly.Zero(self._field)
            for d, c in zip(self._degrees, self._coeffs):
                result = result + Poly([c], field=self._field) * (at**d)
            return result

        field = self._field if field is None else field
        x = field(at)
        if not elementwise:
            if x.ndim != 2 or x.shape[0] != x.shape[1]:
                raise ValueError("Matrix evaluation requires a square matrix.")
            return self._evaluate_matrix(x)
        from ..ops._poly_eval import evaluate as dev_evaluate

        return dev_evaluate(self, x)

    def _evaluate_matrix(self, X):
        from ..ops._linalg import matmul

        field = type(X)
        n = X.shape[0]
        I = field.Identity(n)
        result = field.Zeros((n, n))
        coeffs = self.coefficients()  # descending
        for c in coeffs:
            result = matmul(result, X) + I * c
        return result

    def derivative(self, k: int = 1) -> "Poly":
        if k <= 0:
            raise ValueError(f"Argument 'k' must be positive, not {k}.")
        self._ensure_terms()
        F = _hf(self._field)
        degs, coefs = [], []
        for d, c in zip(self._degrees, self._coeffs):
            cur = c
            for i in range(k):
                cur = F.multiply(cur, (d - i) % self._field.characteristic)
            if d - k >= 0 and cur != 0:
                degs.append(d - k)
                coefs.append(cur)
        return Poly._from_sparse(degs, coefs, self._field)

    def roots(self, multiplicity: bool = False):
        from ._roots import poly_roots

        return poly_roots(self, multiplicity=multiplicity)

    # Factoring / predicate methods are attached by sibling modules
    # (_factor.py, _irreducible.py, _primitive.py, _conway.py) mirroring the
    # reference's @method_of pattern (src/galois/_polys/_poly.py:899-938).

    def square_free_factors(self):
        from ._factor import square_free_factors

        return square_free_factors(self)

    def distinct_degree_factors(self):
        from ._factor import distinct_degree_factors

        return distinct_degree_factors(self)

    def equal_degree_factors(self, degree: int):
        from ._factor import equal_degree_factors

        return equal_degree_factors(self, degree)

    def factors(self):
        from ._factor import factors

        return factors(self)

    def is_square_free(self) -> bool:
        from ._factor import is_square_free

        return is_square_free(self)

    def is_irreducible(self) -> bool:
        from ._irreducible import is_irreducible

        return is_irreducible(self)

    def is_primitive(self) -> bool:
        from ._primitive import is_primitive

        return is_primitive(self)

    def is_conway(self) -> bool:
        from ._conway import is_conway

        return is_conway(self)

    def is_conway_consistent(self) -> bool:
        from ._conway import is_conway_consistent

        return is_conway_consistent(self)


def _hf(field):
    from ..fields._hostfield import get_host_field

    return get_host_field(field._meta)


def _coerce_poly(x, field) -> Poly:
    from ..fields._array import FieldArray

    if isinstance(x, Poly):
        return x
    if isinstance(x, (int, np.integer)):
        return Poly.Int(int(x), field=field)
    if isinstance(x, str):
        return Poly.Str(x, field=field)
    if isinstance(x, FieldArray):
        return Poly(x)
    raise TypeError(f"Cannot coerce {type(x)} to a Poly.")
