"""FieldArray: the flagship user-facing class.

The reference subclasses np.ndarray and intercepts ufuncs
(reference: src/galois/_fields/_array.py:28, src/galois/_domains/_ufunc.py:660).
Here FieldArray is instead an immutable *pytree wrapper* around a
`jax.Array` in the field's internal storage format (ints / digit vectors /
limb vectors — see FieldMeta.storage). All arithmetic routes through jitted
whole-array kernels in ops/_kernels.py, so FieldArrays compose transparently
with jit / vmap / grad-free transforms and shard_map.

NumPy interop is preserved: `__array_ufunc__` / `__array_function__` are
implemented directly (NumPy dispatches to any object providing them), so
`np.multiply(x, y)`, `np.convolve(x, y)`, `np.fft.fft(x)` etc. work like they
do in the reference.
"""

from __future__ import annotations

import functools
from typing import Any, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..polys._conversions import integer_to_poly, poly_to_str, str_to_integer
from ._meta import (
    STORAGE_DIGITS,
    STORAGE_INT,
    STORAGE_LIMBS,
    FieldMeta,
    int_to_limbs,
    limbs_to_int,
)

__all__ = ["FieldArray", "FieldArrayMeta"]


# ----------------------------------------------------------------------
# Kernel dispatch (cached jitted kernels per field/mode/op)
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=2048)  # bounded: see codes/_decoder.py::make_decoder
def _kernel(meta: FieldMeta, mode: str, opname: str):
    from ..ops._kernels import get_ops

    ops = get_ops(meta, mode)
    return jax.jit(getattr(ops, opname))


@functools.lru_cache(maxsize=None)
def _raw_ops(meta: FieldMeta, mode: str):
    from ..ops._kernels import get_ops

    return get_ops(meta, mode)


# ----------------------------------------------------------------------
# Host-side conversion helpers
# ----------------------------------------------------------------------

def _ints_to_storage_np(meta: FieldMeta, arr: np.ndarray) -> np.ndarray:
    """NumPy array of int reprs (int64 or object) -> internal storage (NumPy).

    Digit storage is trailing-axis (..., m); limb storage is PLANAR with the
    limb axis leading, (L, ...) — see fields/_meta.py on why."""
    if meta.storage == STORAGE_INT:
        return arr.astype(np.int64).astype(meta.internal_dtype)
    flat = arr.reshape(-1)
    w = meta.storage_width
    if flat.dtype != object:
        # vectorized decomposition from int64 values
        x = flat.astype(np.int64)
        out = np.empty((flat.size, w), dtype=np.int64)
        if meta.storage == STORAGE_DIGITS:
            p = meta.characteristic
            for i in range(w):
                out[:, i] = x % p
                x = x // p
        else:
            for i in range(w):
                out[:, i] = x & 0xFFFF
                x = x >> 16
    else:
        out = np.empty((flat.size, w), dtype=np.int64)
        if meta.storage == STORAGE_DIGITS:
            for i, x in enumerate(flat):
                out[i] = meta.int_to_digits(int(x))
        else:
            for i, x in enumerate(flat):
                out[i] = int_to_limbs(int(x), w)
    if meta.storage_first:
        return np.ascontiguousarray(out.T).reshape((w,) + arr.shape).astype(meta.internal_dtype)
    return out.reshape(arr.shape + (w,)).astype(meta.internal_dtype)


def _ints_to_storage(meta: FieldMeta, arr: np.ndarray) -> jnp.ndarray:
    """NumPy array of int reprs (int64 or object) -> internal storage array."""
    return jnp.asarray(_ints_to_storage_np(meta, arr))


def _storage_to_ints(meta: FieldMeta, data: np.ndarray) -> np.ndarray:
    """Internal storage (as NumPy) -> int-repr array (int64 or object)."""
    if meta.storage == STORAGE_INT:
        return data.astype(np.int64)
    if meta.storage_first:
        elem_shape = data.shape[1:]
        flat = data.reshape(meta.storage_width, -1).T
    else:
        elem_shape = data.shape[:-1]
        flat = data.reshape(-1, meta.storage_width)
    use_object = meta.order > 2**63
    if not use_object:
        # vectorized recombination fits int64
        if meta.storage == STORAGE_DIGITS:
            weights = meta.characteristic ** np.arange(meta.storage_width, dtype=np.int64)
        else:
            weights = (1 << (16 * np.arange(meta.storage_width))).astype(np.int64)
        return (flat.astype(np.int64) * weights).sum(axis=1).reshape(elem_shape)
    out = np.empty(flat.shape[0], dtype=object)
    if meta.storage == STORAGE_DIGITS:
        for i in range(flat.shape[0]):
            out[i] = meta.digits_to_int(flat[i])
    else:
        for i in range(flat.shape[0]):
            out[i] = limbs_to_int(flat[i])
    return out.reshape(elem_shape)


def _expand_index(index, ndim: int, first: bool = False):
    """Normalize an index so it applies to the element axes only, keeping
    the storage axis (trailing for digits, leading for planar limbs) intact."""
    if not isinstance(index, tuple):
        index = (index,)
    if any(ix is Ellipsis for ix in index):
        # Expand the ellipsis explicitly so it can't swallow the storage axis.
        pos = index.index(Ellipsis)
        n_specified = sum(1 for ix in index if ix is not None and ix is not Ellipsis)
        fill = (slice(None),) * (ndim - n_specified)
        index = index[:pos] + fill + index[pos + 1 :]
    if first:
        return (slice(None),) + index
    return index + (slice(None),)


# ----------------------------------------------------------------------
# Metaclass: class-level properties (reference: _domains/_meta.py:112-203,
# _fields/_meta.py:73-563)
# ----------------------------------------------------------------------

class FieldArrayMeta(type):
    _meta: FieldMeta

    def __repr__(cls) -> str:
        if cls._meta is None:
            return super().__repr__()
        # Succinct factory-call repr, e.g. <class 'galois_tpu.GF(3^5)'>
        # (reference: src/galois/_fields/_meta.py:58-67).
        return f"<class 'galois_tpu.{cls.name}'>"

    # -- core parameters --
    @property
    def name(cls) -> str:
        return cls._meta.name

    @property
    def characteristic(cls) -> int:
        return cls._meta.characteristic

    @property
    def degree(cls) -> int:
        return cls._meta.degree

    @property
    def order(cls) -> int:
        return cls._meta.order

    @property
    def irreducible_poly(cls):
        from ..polys._poly import Poly

        return Poly.Int(cls._meta.irreducible_poly_int, field=cls.prime_subfield)

    @property
    def primitive_element(cls) -> "FieldArray":
        return cls(cls._meta.primitive_element_int)

    @property
    def dtypes(cls) -> list:
        return list(cls._meta.dtypes)

    @property
    def default_dtype(cls):
        d = cls._meta.dtypes[0]
        return np.object_ if d is np.object_ else np.dtype(d)

    @property
    def is_prime_field(cls) -> bool:
        return cls._meta.is_prime_field

    @property
    def is_extension_field(cls) -> bool:
        return cls._meta.is_extension_field

    @property
    def prime_subfield(cls):
        from ._factory import GF

        return GF(cls._meta.characteristic)

    @property
    def is_primitive_poly(cls) -> bool:
        from ._hostfield import get_host_field

        # f(x) is primitive iff x (= the element p) is a primitive element
        if cls._meta.degree == 1:
            # f(x) = x - alpha with alpha primitive by construction
            return True
        hf = get_host_field(cls._meta)
        return hf.is_primitive_element(cls._meta.characteristic)

    # -- compile/repr state --
    @property
    def ufunc_mode(cls) -> str:
        return cls._mode

    @property
    def ufunc_modes(cls) -> list:
        return list(cls._meta.ufunc_modes)

    @property
    def default_ufunc_mode(cls) -> str:
        return cls._meta.default_ufunc_mode

    @property
    def element_repr(cls) -> str:
        return cls._element_repr

    # -- element collections --
    @property
    def elements(cls) -> "FieldArray":
        return cls.Range(0, cls.order)

    @property
    def units(cls) -> "FieldArray":
        return cls.Range(1, cls.order)

    @property
    def primitive_elements(cls) -> "FieldArray":
        from ..nt import totatives

        alpha_pows = sorted(totatives(cls.order - 1))
        from ._hostfield import get_host_field

        hf = get_host_field(cls._meta)
        alpha = cls._meta.primitive_element_int
        elems = sorted(hf.power(alpha, k) for k in alpha_pows)
        return cls(elems)

    @property
    def normal_element(cls) -> "FieldArray":
        """The first normal element of GF(p^m) over GF(p)
        (reference: src/galois/_fields/_meta.py:350-391)."""
        from ._normal_element import _conjugate_matrix_rank

        m = cls._meta.degree
        for e in range(1, cls.order):
            if _conjugate_matrix_rank(cls, e) == m:
                return cls(e)
        return None

    @property
    def normal_elements(cls) -> "FieldArray":
        """All normal elements (reference: src/galois/_fields/_meta.py:392-432)."""
        from ._normal_element import _conjugate_matrix_rank

        m = cls._meta.degree
        elems = [e for e in range(1, cls.order) if _conjugate_matrix_rank(cls, e) == m]
        return cls(elems)

    @property
    def squares(cls) -> "FieldArray":
        x = cls.elements
        return x[np.asarray(x.is_square())]

    @property
    def non_squares(cls) -> "FieldArray":
        x = cls.elements
        return x[~np.asarray(x.is_square())]

    @property
    def properties(cls) -> str:
        from ..polys._conversions import poly_to_str

        f_str = poly_to_str(
            integer_to_poly(cls._meta.irreducible_poly_int, cls.characteristic)
        )
        lines = [
            f"Galois Field:",
            f"  name: {cls.name}",
            f"  characteristic: {cls.characteristic}",
            f"  degree: {cls.degree}",
            f"  order: {cls.order}",
            f"  irreducible_poly: {f_str}",
            f"  is_primitive_poly: {cls.is_primitive_poly}",
            # the reference always renders the primitive element as its
            # polynomial string for extension fields, independent of the
            # class's element_repr (src/galois/_fields/_meta.py:49,96)
            "  primitive_element: "
            + (
                str(cls._meta.primitive_element_int)
                if cls._meta.degree == 1
                else poly_to_str(
                    integer_to_poly(cls._meta.primitive_element_int, cls.characteristic)
                )
            ),
        ]
        return "\n".join(lines)

    def _element_to_str(cls, x: int) -> str:
        if cls._element_repr == "int" or cls._meta.degree == 1:
            return str(x)
        return poly_to_str(integer_to_poly(x, cls.characteristic), poly_var="α")

    def compile(cls, mode: str) -> None:
        """Select the compile mode: 'auto', 'jit-lookup', 'jit-calculate', or
        'python-calculate' (reference: src/galois/_domains/_array.py:322-362)."""
        if mode == "auto":
            mode = cls._meta.default_ufunc_mode
        if mode not in cls._meta.ufunc_modes:
            raise ValueError(
                f"Argument 'mode' must be in {['auto'] + cls._meta.ufunc_modes}, not {mode!r}."
            )
        cls._mode = mode

    def repr(cls, element_repr: str = "int"):
        """Set the element display mode: 'int', 'poly', or 'power'. Usable as
        a context manager (reference: src/galois/_domains/_array.py:368-407)."""
        if element_repr not in ("int", "poly", "power"):
            raise ValueError(
                f"Argument 'element_repr' must be in ['int', 'poly', 'power'], not {element_repr!r}."
            )
        prior = cls._element_repr
        cls._element_repr = element_repr

        class _ReprContext:
            def __enter__(self_ctx):
                return cls

            def __exit__(self_ctx, *exc):
                cls._element_repr = prior

        return _ReprContext()


# ----------------------------------------------------------------------
# FieldArray
# ----------------------------------------------------------------------

class Array(metaclass=FieldArrayMeta):
    """Abstract base class of all galois_tpu arrays (reference: galois.Array,
    src/galois/_domains/_array.py:25). Exists so `isinstance(x, galois_tpu.Array)`
    and `issubclass(GF, galois_tpu.Array)` behave as in the reference; concrete
    behavior lives in FieldArray and the GF()-manufactured subclasses."""

    _meta: FieldMeta = None

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "Array is abstract; create a concrete field with GF(p**m)."
        )


class FieldArray(Array):
    """An array over GF(p^m). Instances wrap a jax.Array in the field's
    internal storage layout; the class (manufactured by `GF()`) carries the
    static field descriptor."""

    _meta: FieldMeta = None
    _mode: str = None
    _element_repr: str = "int"

    def __init__(self, x, dtype=None, copy=True, order="K", ndmin=0):
        cls = type(self)
        if cls._meta is None:
            raise NotImplementedError(
                "FieldArray is abstract; create a concrete field with GF(p**m)."
            )
        data = _convert_to_storage(cls, x)
        if ndmin and data.ndim - cls._storage_ndim() < ndmin:
            extra = ndmin - (data.ndim - cls._storage_ndim())
            if cls._storage_first():
                data = data.reshape(data.shape[:1] + (1,) * extra + data.shape[1:])
            else:
                data = data.reshape((1,) * extra + data.shape)
        self._data = data
        self._dtype = _validate_dtype(cls, dtype)

    # -- construction without verification --
    @classmethod
    def _view(cls, data: jnp.ndarray, dtype=None) -> "FieldArray":
        obj = object.__new__(cls)
        obj._data = data
        obj._dtype = dtype if dtype is not None else cls.default_dtype
        return obj

    @classmethod
    def _storage_ndim(cls) -> int:
        return 0 if cls._meta.storage == STORAGE_INT else 1

    @classmethod
    def _storage_first(cls) -> bool:
        """True when the storage axis leads (planar limb layout)."""
        return cls._meta.storage_first

    # ------------------------------------------------------------------
    # Alternate constructors (reference: _domains/_array.py:159-316,
    # _fields/_array.py:334-491)
    # ------------------------------------------------------------------

    @classmethod
    def Zeros(cls, shape, dtype=None) -> "FieldArray":
        shape = _as_shape(shape)
        return cls._view(
            jnp.zeros(_full_shape(cls, shape), dtype=cls._meta.internal_dtype),
            _validate_dtype(cls, dtype),
        )

    @classmethod
    def Ones(cls, shape, dtype=None) -> "FieldArray":
        shape = _as_shape(shape)
        if cls._storage_ndim():
            data = jnp.zeros(_full_shape(cls, shape), dtype=cls._meta.internal_dtype)
            data = data.at[0].set(1) if cls._storage_first() else data.at[..., 0].set(1)
        else:
            data = jnp.ones(shape, dtype=cls._meta.internal_dtype)
        return cls._view(data, _validate_dtype(cls, dtype))

    @classmethod
    def Range(cls, start, stop, step=1, dtype=None) -> "FieldArray":
        start, stop, step = int(start), int(stop), int(step)
        if not 0 <= start <= cls.order:
            raise ValueError(
                f"Argument 'start' must be within the field's order {cls.order}."
            )
        if stop > cls.order:
            raise ValueError(f"Argument 'stop' must be <= the field order {cls.order}.")
        if cls._meta.storage == STORAGE_INT:
            arr = np.arange(start, stop, step, dtype=np.int64)
            return cls._view(
                jnp.asarray(arr, dtype=cls._meta.internal_dtype), _validate_dtype(cls, dtype)
            )
        vals = np.array(list(range(start, stop, step)), dtype=object)
        return cls._view(_ints_to_storage(cls._meta, vals), _validate_dtype(cls, dtype))

    @classmethod
    def Random(cls, shape=(), low=0, high=None, seed=None, dtype=None) -> "FieldArray":
        shape = _as_shape(shape)
        high = cls.order if high is None else int(high)
        rng = np.random.default_rng(seed)
        if cls.order <= 2**63:
            arr = rng.integers(int(low), high, size=shape, dtype=np.int64)
            arr = arr.astype(object)
        else:
            span = high - int(low)
            flat = np.empty(int(np.prod(shape)) if shape else 1, dtype=object)
            for i in range(flat.size):
                flat[i] = int(low) + int(rng.integers(0, 2**62)) * span // 2**62
            arr = flat.reshape(shape) if shape else flat[0]
            arr = np.asarray(arr, dtype=object)
        return cls._view(_ints_to_storage(cls._meta, np.asarray(arr, dtype=object)), _validate_dtype(cls, dtype))

    @classmethod
    def Identity(cls, size: int, dtype=None) -> "FieldArray":
        eye = np.eye(int(size), dtype=np.int64)
        return cls(eye, dtype=dtype)

    @classmethod
    def Vandermonde(cls, element, rows: int, cols: int, dtype=None) -> "FieldArray":
        a = cls(element)
        if a.ndim != 0:
            raise ValueError("Argument 'element' must be 0-D.")
        i = np.arange(rows).reshape(-1, 1) * np.arange(cols).reshape(1, -1)
        # V[i, j] = element^(i*j)
        base = a._data
        if cls._storage_first():
            base = base.reshape(base.shape[:1] + (1, 1))
        flat = cls._dispatch("power")(
            jnp.broadcast_to(base, _full_shape(cls, (rows, cols))),
            jnp.asarray(i, dtype=jnp.int64),
        )
        return cls._view(flat, _validate_dtype(cls, dtype))

    @classmethod
    def Vector(cls, array, dtype=None) -> "FieldArray":
        """Create from length-m vectors over GF(p), degrees descending
        (reference: src/galois/_fields/_array.py:382-442)."""
        sub = cls.prime_subfield
        v = sub(array)
        m = cls._meta.degree
        if v.shape[-1] != m:
            raise ValueError(f"The last dimension of 'array' must be {m}, not {v.shape[-1]}.")
        digits = np.asarray(v)  # int reprs of GF(p) elements, descending degrees
        digits_asc = digits[..., ::-1].astype(object)
        p = cls._meta.characteristic
        ints = np.zeros(digits.shape[:-1], dtype=object)
        for k in range(m):
            ints = ints + digits_asc[..., k] * (p**k)
        return cls(ints if ints.ndim else int(ints), dtype=dtype)

    # ------------------------------------------------------------------
    # Basic array protocol
    # ------------------------------------------------------------------

    @property
    def shape(self) -> Tuple[int, ...]:
        s = self._data.shape
        if self._storage_first():
            return s[1:]
        return s[: len(s) - self._storage_ndim()]

    @property
    def ndim(self) -> int:
        return self._data.ndim - self._storage_ndim()

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def dtype(self):
        return self._dtype

    def __len__(self) -> int:
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __getitem__(self, index) -> "FieldArray":
        cls = type(self)
        if self._storage_ndim():
            index = _expand_index(index, self.ndim, cls._storage_first())
        return cls._view(self._data[index], self._dtype)

    def __setitem__(self, index, value) -> None:
        cls = type(self)
        vdata = _convert_to_storage(cls, value)
        if self._storage_ndim():
            index = _expand_index(index, self.ndim, cls._storage_first())
        if cls._storage_first():
            # Planar limbs broadcast leading-aligned on the limb axis: pad
            # the value's ELEMENT axes just under the leading (w,) so a
            # scalar/(w,) value fills a (w, k) slice (a[0:2] = 1).
            tgt = jax.eval_shape(lambda d: d[index], self._data).shape
            if vdata.ndim < len(tgt):
                vdata = vdata.reshape(
                    vdata.shape[:1] + (1,) * (len(tgt) - vdata.ndim) + vdata.shape[1:]
                )
        self._data = self._data.at[index].set(vdata)

    def reshape(self, *shape) -> "FieldArray":
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        full = tuple(int(s) for s in shape)
        if self._storage_first():
            full = (self._meta.storage_width,) + full
        elif self._storage_ndim():
            full = full + (self._meta.storage_width,)
        return type(self)._view(self._data.reshape(full), self._dtype)

    def flatten(self) -> "FieldArray":
        return self.reshape(self.size)

    ravel = flatten

    @property
    def T(self) -> "FieldArray":
        if self._storage_first():
            axes = (0,) + tuple(a + 1 for a in reversed(range(self.ndim)))
            return type(self)._view(jnp.transpose(self._data, axes), self._dtype)
        if self._storage_ndim():
            axes = tuple(range(self.ndim))[::-1] + (self.ndim,)
            return type(self)._view(jnp.transpose(self._data, axes), self._dtype)
        return type(self)._view(self._data.T, self._dtype)

    def transpose(self, *axes) -> "FieldArray":
        if not axes:
            return self.T
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        if self._storage_first():
            axes = (0,) + tuple(a + 1 for a in axes)
        elif self._storage_ndim():
            axes = tuple(axes) + (self.ndim,)
        return type(self)._view(jnp.transpose(self._data, axes), self._dtype)

    def copy(self) -> "FieldArray":
        return type(self)._view(self._data, self._dtype)

    def astype(self, dtype) -> "FieldArray":
        return type(self)._view(self._data, _validate_dtype(type(self), dtype))

    def item(self):
        ints = _storage_to_ints(self._meta, np.asarray(self._data))
        return int(np.asarray(ints).reshape(-1)[0])

    def __int__(self):
        if self.ndim != 0:
            raise TypeError("Only 0-D arrays can be converted to int.")
        return self.item()

    def __index__(self):
        return self.__int__()

    def __array__(self, dtype=None, copy=None):
        ints = _storage_to_ints(self._meta, np.asarray(self._data))
        dt = dtype if dtype is not None else self._dtype
        if dt is np.object_ or dt == np.dtype(object):
            return ints.astype(object)
        return ints.astype(dt)

    @property
    def jax(self) -> jnp.ndarray:
        """The underlying jax.Array in internal storage layout (device
        escape hatch; zero-copy)."""
        return self._data

    # ------------------------------------------------------------------
    # Arithmetic operators
    # ------------------------------------------------------------------

    @classmethod
    def _dispatch(cls, opname: str):
        mode = cls._mode
        if mode == "python-calculate":
            return _python_op(cls._meta, opname)
        return _kernel(cls._meta, mode, opname)

    def _coerce(self, other, for_multiply=False):
        cls = type(self)
        if isinstance(other, FieldArray):
            if type(other)._meta != cls._meta:
                raise TypeError(
                    f"Operands are over different fields: {cls.name} and {type(other).name}."
                )
            return other
        if for_multiply and _is_integer_like(other):
            # Integer operand to multiply = repeated addition: reduce mod p
            # (reference: src/galois/_domains/_ufunc.py:394-401).
            arr = np.asarray(np.asarray(other, dtype=object) % cls._meta.characteristic, dtype=object)
            return cls(arr if arr.ndim else int(arr))
        return cls(other)

    def _binary(self, other, opname, reflected=False, for_multiply=False):
        if other is NotImplemented:
            return NotImplemented
        if not isinstance(other, FieldArray) and not for_multiply:
            # Reference contract: add/subtract/divide require BOTH operands
            # in the field — a plain int/list/ndarray operand is a
            # TypeError, not an implicit coercion (multiplication is the
            # one exception: an integer operand means repeated addition).
            # Reference: src/galois/_domains/_ufunc.py:200-205.
            return NotImplemented
        try:
            o = self._coerce(other, for_multiply=for_multiply)
        except (TypeError, ValueError):
            return NotImplemented
        a, b = (o, self) if reflected else (self, o)
        out = type(self)._dispatch(opname)(a._data, b._data)
        return type(self)._view(out, self._dtype)

    def __add__(self, other):
        return self._binary(other, "add")

    def __radd__(self, other):
        return self._binary(other, "add", reflected=True)

    def __sub__(self, other):
        return self._binary(other, "subtract")

    def __rsub__(self, other):
        return self._binary(other, "subtract", reflected=True)

    def __mul__(self, other):
        return self._binary(other, "multiply", for_multiply=True)

    def __rmul__(self, other):
        return self._binary(other, "multiply", reflected=True, for_multiply=True)

    def __truediv__(self, other):
        if not isinstance(other, FieldArray):
            return NotImplemented  # same-field contract, see _binary
        o = self._coerce(other)
        _check_div_by_zero(o)
        return self._binary(o, "divide")

    def __rtruediv__(self, other):
        _check_div_by_zero(self)
        return self._binary(other, "divide", reflected=True)

    __floordiv__ = __truediv__
    __rfloordiv__ = __rtruediv__

    def __neg__(self):
        out = type(self)._dispatch("negative")(self._data)
        return type(self)._view(out, self._dtype)

    def __pos__(self):
        return self.copy()

    def __pow__(self, other):
        cls = type(self)
        if isinstance(other, (int, np.integer)):
            e = int(other)
            if e < 0:
                _check_div_by_zero(self)
            if cls._mode == "python-calculate":
                return cls._view(_python_power(cls._meta, np.asarray(self._data), e), self._dtype)
            from ..ops._kernels import power_static_jit

            out = power_static_jit(cls._meta, cls._mode, e)(self._data)
            return cls._view(out, self._dtype)
        e = np.asarray(other)
        if isinstance(other, FieldArray) or (e.dtype != object and not np.issubdtype(e.dtype, np.integer)):
            raise TypeError(f"Exponents must be integers, not {e.dtype}.")
        if cls._mode == "python-calculate":
            out = _python_op(cls._meta, "power")(self._data, e)
            return cls._view(out, self._dtype)
        return _power_array(self, e)

    def __eq__(self, other):
        try:
            o = self._coerce(other)
        except (TypeError, ValueError):
            return NotImplemented
        if self._storage_first():
            # Planar storage: the leading limb axis must stay aligned while
            # the ELEMENT axes broadcast trailing-relative — pad the lower-
            # rank operand's element axes just after the limb axis.
            a, b = self._data, o._data
            nd = max(a.ndim, b.ndim)
            a = a.reshape(a.shape[:1] + (1,) * (nd - a.ndim) + a.shape[1:])
            b = b.reshape(b.shape[:1] + (1,) * (nd - b.ndim) + b.shape[1:])
            return np.asarray(jnp.all(a == b, axis=0))
        if self._storage_ndim():
            return np.asarray(jnp.all(self._data == o._data, axis=-1))
        return np.asarray(self._data == o._data)

    def __ne__(self, other):
        eq = self.__eq__(other)
        return NotImplemented if eq is NotImplemented else ~eq

    def _compare(self, other, op):
        try:
            o = self._coerce(other)
        except (TypeError, ValueError):
            return NotImplemented
        a = _storage_to_ints(self._meta, np.asarray(self._data))
        b = _storage_to_ints(self._meta, np.asarray(o._data))
        return op(np.asarray(a), np.asarray(b))

    def __lt__(self, other):
        import operator

        return self._compare(other, operator.lt)

    def __le__(self, other):
        import operator

        return self._compare(other, operator.le)

    def __gt__(self, other):
        import operator

        return self._compare(other, operator.gt)

    def __ge__(self, other):
        import operator

        return self._compare(other, operator.ge)

    def __hash__(self):
        return hash((type(self), self.item())) if self.ndim == 0 else None

    def __matmul__(self, other):
        from ..ops._linalg import matmul

        o = self._coerce(other)
        return matmul(self, o)

    def __rmatmul__(self, other):
        from ..ops._linalg import matmul

        o = self._coerce(other)
        return matmul(o, self)

    # ------------------------------------------------------------------
    # Field methods
    # ------------------------------------------------------------------

    def multiplicative_inverse(self) -> "FieldArray":
        _check_div_by_zero(self)
        out = type(self)._dispatch("reciprocal")(self._data)
        return type(self)._view(out, self._dtype)

    def additive_order(self):
        """1 for zero, else the characteristic
        (reference: src/galois/_fields/_array.py:1258-1291). jit-safe for
        p < 2^63 (the zero test and select run on device)."""
        cls = type(self)
        p = self._meta.characteristic
        traced = isinstance(self._data, jax.core.Tracer)
        if p <= np.iinfo(np.int64).max:
            ops = _raw_ops(
                cls._meta,
                cls._mode if cls._mode != "python-calculate" else cls._meta.default_ufunc_mode,
            )
            order = jnp.where(ops.is_zero(self._data), 1, p).astype(jnp.int64)
            if traced:
                return order
            out = np.asarray(order)
            return out if out.ndim else np.int64(out)
        if traced:
            raise NotImplementedError(
                f"additive_order under jit requires characteristic < 2^63, not {p}."
            )
        xo = np.asarray(np.asarray(self), dtype=object)
        out = np.frompyfunc(lambda v: 1 if v == 0 else p, 1, 1)(xo)
        out = np.asarray(out, dtype=object)
        return out if out.ndim else int(out)

    def multiplicative_order(self):
        """Order of each unit in the multiplicative group
        (reference: src/galois/_fields/_array.py:1292-1353).

        int-storage fields compute on device with the static factorization
        of q-1 (jit-safe; zero inputs are undefined under jit, checked
        eagerly otherwise): for each prime factor, repeatedly divide the
        candidate order while x^(ord/p_i) == 1."""
        cls = type(self)
        meta = self._meta
        traced = isinstance(self._data, jax.core.Tracer)
        if meta.storage == STORAGE_INT:
            if not traced and (np.asarray(self._data) == 0).any():
                raise ArithmeticError("0 has no multiplicative order.")
            from ..nt.factorization import factors as _nt_factors

            n = meta.order - 1
            primes, exps = _nt_factors(n)
            ops = _raw_ops(
                meta, cls._mode if cls._mode != "python-calculate" else meta.default_ufunc_mode
            )
            ord_arr = jnp.full(self._data.shape, n, dtype=jnp.int64)
            for pi, ei in zip(primes, exps):
                for _ in range(ei):
                    cand = ord_arr // pi
                    divides = ord_arr % pi == 0
                    pw = ops.power(self._data, jnp.where(divides, cand, 1))
                    mask = divides & (pw == 1)
                    ord_arr = jnp.where(mask, cand, ord_arr)
            if traced:
                return ord_arr
            out = np.asarray(ord_arr)
            return out if out.ndim else np.int64(out)
        if traced:
            raise NotImplementedError(
                "multiplicative_order under jit requires int storage "
                f"(order <= 2^32), not {meta.storage}."
            )
        from ._hostfield import get_host_field

        x = _storage_to_ints(self._meta, np.asarray(self._data))
        if (np.asarray(x) == 0).any():
            raise ArithmeticError("0 has no multiplicative order.")
        hf = get_host_field(self._meta)
        flat = np.asarray(x, dtype=object).reshape(-1)
        vals = [hf.multiplicative_order(int(v)) for v in flat]
        dtype = np.int64 if self._meta.order - 1 <= np.iinfo(np.int64).max else object
        out = np.array(vals, dtype=dtype).reshape(np.asarray(x).shape)
        if out.ndim:
            return out
        return np.int64(out) if dtype is np.int64 else int(out)

    def is_square(self):
        """Euler's criterion (reference: src/galois/_fields/_array.py:1354-1411).
        Fully device-resident; jit-safe (returns a device bool array when
        traced)."""
        cls = type(self)
        q = self._meta.order
        traced = isinstance(self._data, jax.core.Tracer)
        if self._meta.characteristic == 2:
            if traced:
                return jnp.ones(self.shape, dtype=bool)
            out = np.ones(self.shape, dtype=bool)
            return out if out.ndim else np.bool_(True)
        ops = _raw_ops(cls._meta, cls._mode if cls._mode != "python-calculate" else cls._meta.default_ufunc_mode)
        euler = jax.jit(lambda a: ops.power_static(a, (q - 1) // 2))(self._data)
        out_dev = jnp.logical_or(
            jnp.asarray(ops.is_zero(self._data)),
            jnp.asarray(ops._eq(euler, ops.one_like(euler))),
        )
        if traced:
            return out_dev
        out = np.asarray(out_dev)
        return out if out.ndim else np.bool_(out)

    def sqrt(self) -> "FieldArray":
        """Square roots; raises if any element is a non-square
        (reference fields' sqrt kernels, src/galois/_domains/_calculate.py:758-832).
        Under jit the non-square check needs concrete values, so results for
        non-squares are unspecified there (validate with is_square first)."""
        if not isinstance(self._data, jax.core.Tracer):
            if not np.all(np.asarray(self.is_square())):
                raise ArithmeticError("Input array has elements that are non-squares.")
        out = type(self)._dispatch("sqrt")(self._data)
        return type(self)._view(out, self._dtype)

    def log(self, base=None):
        """Discrete logarithm (reference: src/galois/_fields/_array.py:2127-2211)."""
        from ..ops._dlog import log as _log

        return _log(self, base)

    def vector(self, dtype=None):
        """Length-m GF(p) vectors, degrees descending
        (reference: src/galois/_fields/_array.py:443-491). Device-resident
        and jit-safe: the basis-digit split runs per storage kind."""
        cls = type(self)
        sub = cls.prime_subfield
        m = self._meta.degree
        p = self._meta.characteristic
        d = self._data
        if self._meta.storage == STORAGE_DIGITS:
            digits_desc = jnp.flip(d, axis=-1)
        elif self._meta.storage == STORAGE_INT:
            if p == 2:
                digs = [(d >> i) & 1 for i in range(m)]
            else:
                digs = []
                x = d.astype(jnp.uint32)
                for _ in range(m):
                    digs.append(x % p)
                    x = x // p
            digits_desc = jnp.stack(digs[::-1], axis=-1)
        elif p == 2:  # planar limb storage, binary extension: bits across limbs
            digs = [(d[i // 16] >> (i % 16)) & 1 for i in range(m)]
            digits_desc = jnp.stack(digs[::-1], axis=-1)
        else:  # limb-storage prime field: m == 1, the vector is the element
            assert m == 1
            if isinstance(d, jax.core.Tracer):
                raise NotImplementedError(
                    "vector() of a limb-storage prime field is host-only under jit."
                )
            ints = _storage_to_ints(self._meta, np.asarray(d))
            return sub(np.asarray(ints, dtype=object)[..., None], dtype=dtype)
        return sub._view(
            digits_desc.astype(sub._meta.internal_dtype), _validate_dtype(sub, dtype)
        )

    # Linear algebra and Galois-theory methods are attached by
    # ops/_linalg.py and fields/_theory.py (kept in separate modules).

    # ------------------------------------------------------------------
    # NumPy protocol interception
    # ------------------------------------------------------------------

    # -- reductions (reference: ndarray-inherited add.reduce etc., with the
    # reduce-dtype fix at src/galois/_domains/_ufunc.py:684-687) --

    def _reduce(self, opname: str, axis=None):
        cls = type(self)
        data = self._data
        storage_nd = self._storage_ndim()
        first = self._storage_first()
        ops = _raw_ops(cls._meta, cls._mode if cls._mode != "python-calculate" else cls._meta.default_ufunc_mode)
        # Normalize so the reduction axis is the leading ELEMENT axis: data
        # axis 0 for int/digit storage, data axis 1 under a planar limb axis.
        r_ax = 1 if first else 0
        if axis is None:
            if first:
                w = data.shape[0]
                flat = data.reshape((w, -1))
            else:
                flat = data.reshape((-1,) + data.shape[data.ndim - storage_nd :])
        else:
            flat = jnp.moveaxis(data, axis + (1 if first else 0), r_ax)

        @jax.jit
        def run(x):
            out = x
            while out.shape[r_ax] > 1:
                half = out.shape[r_ax] // 2
                a = jax.lax.slice_in_dim(out, 0, half, axis=r_ax)
                b = jax.lax.slice_in_dim(out, half, 2 * half, axis=r_ax)
                rem = jax.lax.slice_in_dim(out, 2 * half, out.shape[r_ax], axis=r_ax)
                combined = getattr(ops, opname)(a, b)
                out = jnp.concatenate([combined, rem], axis=r_ax)
            return jnp.squeeze(out, axis=r_ax)

        return cls._view(run(flat), self._dtype)

    def sum(self, axis=None):
        return self._reduce("add", axis)

    def prod(self, axis=None):
        return self._reduce("multiply", axis)

    def dot(self, other):
        from ..ops._linalg import matmul

        o = self._coerce(other)
        if self.ndim == 1 and o.ndim == 1:
            return matmul(self, o)
        return matmul(self, o)

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        if method == "reduce" and ufunc.__name__ in ("add", "multiply") and not kwargs.get("keepdims"):
            recv = next(x for x in inputs if isinstance(x, FieldArray))
            return recv._reduce(ufunc.__name__, kwargs.get("axis", None))
        if method != "__call__":
            return _ufunc_method(self, ufunc, method, *inputs, **kwargs)
        name = ufunc.__name__
        if name in ("add", "subtract", "true_divide", "divide", "floor_divide"):
            # same-field contract (see _binary): int scalars/arrays raise
            if not all(isinstance(x, FieldArray) for x in inputs):
                raise TypeError(
                    f"Operation {name!r} requires both operands to be instances of "
                    f"{type(self).name}, not {[type(x).__name__ for x in inputs]}. "
                    "Integer operands are only allowed for 'multiply' (repeated "
                    "addition) and 'power'."
                )
        handlers = {
            "add": lambda a, b: a._binary(b, "add"),
            "subtract": lambda a, b: a._binary(b, "subtract"),
            "multiply": lambda a, b: a._binary(b, "multiply", for_multiply=True),
            "true_divide": lambda a, b: a.__truediv__(b),
            "divide": lambda a, b: a.__truediv__(b),
            "floor_divide": lambda a, b: a.__truediv__(b),
            "negative": lambda a: -a,
            "positive": lambda a: +a,
            "reciprocal": lambda a: a.multiplicative_inverse(),
            "power": lambda a, b: a.__pow__(b),
            "square": lambda a: a * a,
            "sqrt": lambda a: a.sqrt(),
            "log": lambda a: a.log(),
            "matmul": lambda a, b: a.__matmul__(b),
        }
        if name in handlers:
            args = []
            for x in inputs:
                args.append(x)
            # normalize: first FieldArray becomes self-like receiver
            recv = next(x for x in args if isinstance(x, FieldArray))
            if name in ("add", "subtract", "multiply", "true_divide", "divide",
                        "floor_divide", "power", "matmul"):
                a, b = args
                if not isinstance(a, FieldArray):
                    a = recv._coerce(a, for_multiply=(name == "multiply"))
                return handlers[name](a, b)
            return handlers[name](recv)
        raise NotImplementedError(
            f"NumPy ufunc {name!r} is not supported on {type(self).name} arrays. "
            "Convert to a plain array with np.asarray(x) first if this is intentional."
        )

    def __array_function__(self, func, types, args, kwargs):
        from . import _np_functions

        return _np_functions.dispatch(self, func, args, kwargs)

    # ------------------------------------------------------------------
    # Display
    # ------------------------------------------------------------------

    def _format_element(self, x: int) -> str:
        cls = type(self)
        if cls._element_repr == "int":
            return str(x)
        if cls._element_repr == "poly":
            return poly_to_str(integer_to_poly(x, self._meta.characteristic), poly_var="α")
        # power repr: x = α^i
        if x == 0:
            return "0"
        from ._hostfield import get_host_field

        from ..ops._dlog import host_log

        i = host_log(self._meta, x)
        return "1" if i == 0 else ("α" if i == 1 else f"α^{i}")

    def __repr__(self) -> str:
        return self._to_string(repr_mode=True)

    def __str__(self) -> str:
        return self._to_string(repr_mode=False)

    def _to_string(self, repr_mode: bool) -> str:
        ints = _storage_to_ints(self._meta, np.asarray(self._data))
        arr = np.asarray(ints)
        if not arr.shape:
            body = self._format_element(int(arr))
        elif type(self)._element_repr == "int":
            body = np.array2string(arr, separator=", ")
        else:
            strs = np.empty(arr.shape, dtype=object)
            for idx in np.ndindex(arr.shape):
                strs[idx] = self._format_element(int(arr[idx]))
            body = np.array2string(strs, separator=", ", formatter={"all": str})
        if repr_mode:
            return f"GF({body}, order={self._meta.order})"
        return body


# ----------------------------------------------------------------------
# Power with arbitrary (multi-word) integer exponents
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=256)  # bounded: see codes/_decoder.py::make_decoder
def _power_words_kernel(meta: FieldMeta, mode: str, nwords: int):
    from ..ops._kernels import get_ops

    ops = get_ops(meta, mode)

    @jax.jit
    def run(a, e_nonzero_mask, *words):
        r = ops.power_words(a, words)
        # 0^e = 0 for e != 0 (word reduction mod q-1 may have zeroed e).
        zero_base = jnp.asarray(ops.is_zero(a))
        r = ops._select(jnp.logical_and(zero_base, e_nonzero_mask), ops.zero_like(r), r)
        return r

    return run


def _power_array(x: "FieldArray", e: np.ndarray) -> "FieldArray":
    """x ** e for an integer ndarray exponent (any magnitude/sign)."""
    cls = type(x)
    meta = cls._meta
    q1 = meta.order - 1
    e_obj = e.astype(object)
    e_nonzero = np.asarray(e_obj != 0, dtype=bool)

    if (np.asarray(e_obj) < 0).any():
        _check_div_by_zero(x)

    needs_reduce = (
        e.dtype == object
        or (np.asarray(e_obj) < 0).any()
        or (np.asarray([int(v) for v in np.atleast_1d(e_obj).reshape(-1)], dtype=object).max() if e_obj.size else 0) >= 2**62
    )
    if needs_reduce:
        red = np.frompyfunc(lambda v: int(v) % q1, 1, 1)(e_obj)
    else:
        red = e_obj

    # Decompose into 63-bit little-endian words.
    nwords = max(1, -(-max(1, q1.bit_length() if needs_reduce else 63) // 63))
    words = []
    rem = np.frompyfunc(int, 1, 1)(red)
    for _ in range(nwords):
        words.append(
            jnp.asarray(
                np.frompyfunc(lambda v: v & ((1 << 63) - 1), 1, 1)(rem).astype(np.int64)
            )
        )
        rem = np.frompyfunc(lambda v: v >> 63, 1, 1)(rem)

    mode = cls._mode
    out = _power_words_kernel(meta, mode, nwords)(
        x._data, jnp.asarray(e_nonzero), *words
    )
    return cls._view(out, x._dtype)


# ----------------------------------------------------------------------
# Helpers
# ----------------------------------------------------------------------

def _as_shape(shape) -> Tuple[int, ...]:
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def _full_shape(cls, shape) -> Tuple[int, ...]:
    if cls._storage_first():
        return (cls._meta.storage_width,) + tuple(shape)
    return tuple(shape) + ((cls._meta.storage_width,) if cls._storage_ndim() else ())


def _validate_dtype(cls, dtype):
    if dtype is None:
        return cls.default_dtype
    if dtype is np.object_ or dtype == np.dtype(object):
        if np.object_ not in cls._meta.dtypes:
            raise TypeError(f"Argument 'dtype' must be in {cls.dtypes}, not object.")
        return np.object_
    dt = np.dtype(dtype)
    if not any(dt == np.dtype(d) for d in cls._meta.dtypes if d is not np.object_):
        raise TypeError(
            f"Argument 'dtype' must be in {[np.dtype(d).name if d is not np.object_ else 'object' for d in cls._meta.dtypes]}, not {dt.name!r}."
        )
    return dt


def _is_integer_like(x) -> bool:
    if isinstance(x, (int, np.integer)):
        return True
    if isinstance(x, np.ndarray):
        if np.issubdtype(x.dtype, np.integer):
            return True
        if x.dtype == object:
            return all(isinstance(v, (int, np.integer)) for v in x.reshape(-1))
    return False


def _convert_to_storage(cls, x) -> jnp.ndarray:
    """Convert ArrayLike input to a verified internal-storage jnp array."""
    meta = cls._meta
    if isinstance(x, FieldArray):
        if type(x)._meta != meta:
            raise TypeError(f"Cannot convert {type(x).name} array to {cls.name}.")
        return x._data
    if isinstance(x, jax.Array) and not isinstance(x, np.ndarray):
        # Trusted device input (possibly a tracer): must already be in
        # internal storage layout for digit/limb fields, or int repr for
        # int-storage fields. No host verification possible under trace.
        if meta.storage == STORAGE_INT:
            return x.astype(meta.internal_dtype)
        if meta.storage_first:
            if x.ndim >= 1 and x.shape[0] == meta.storage_width:
                return x.astype(meta.internal_dtype)
            raise ValueError(
                f"jax.Array input to {cls.name} must have a LEADING (planar) "
                f"limb axis of length {meta.storage_width}."
            )
        if x.ndim >= 1 and x.shape[-1] == meta.storage_width:
            return x.astype(meta.internal_dtype)
        raise ValueError(
            f"jax.Array input to {cls.name} must have trailing storage axis "
            f"of length {meta.storage_width}."
        )
    # Host input: parse strings, verify ranges exactly.
    arr = _parse_host(cls, x)
    return _ints_to_storage(meta, arr)


def _parse_host(cls, x) -> np.ndarray:
    meta = cls._meta
    if isinstance(x, str):
        return np.array(str_to_integer(x, meta.characteristic), dtype=object)
    if isinstance(x, (list, tuple)):
        conv = _parse_nested(cls, x)
        arr = np.array(conv, dtype=object)
    elif isinstance(x, (int, np.integer)):
        arr = np.array(int(x), dtype=object)
    elif isinstance(x, np.ndarray):
        if x.dtype == object or np.issubdtype(x.dtype, np.integer):
            arr = x.astype(object)
        else:
            # Float dtypes are rejected CATEGORICALLY (even whole-valued) —
            # reference contract: tests/fields/test_assignment.py requires
            # a[0:2] = np.array([1.0, 1]) to raise TypeError.
            raise TypeError(
                f"{cls.name} arrays must have integer dtypes, not {x.dtype}."
            )
    elif isinstance(x, FieldArray):
        arr = np.asarray(x).astype(object)
    else:
        raise TypeError(f"Cannot convert {type(x)} to {cls.name}.")
    flat = arr.reshape(-1) if arr.ndim else arr.reshape(1)
    for v in flat:
        v = int(v)
        if not 0 <= v < meta.order:
            raise ValueError(
                f"{cls.name} arrays must have values in [0, {meta.order}), not {v}."
            )
    return arr


def _parse_nested(cls, x):
    if isinstance(x, (list, tuple)):
        return [_parse_nested(cls, v) for v in x]
    if isinstance(x, str):
        return str_to_integer(x, cls._meta.characteristic)
    if isinstance(x, FieldArray):
        return int(x)
    if isinstance(x, (int, np.integer)):
        return int(x)
    if isinstance(x, np.ndarray):
        return x.astype(object).tolist()
    raise TypeError(f"Cannot convert element {type(x)} to {cls.name}.")


def _check_div_by_zero(x: "FieldArray"):
    """Host-side divide-by-zero check (only when data is concrete)."""
    data = x._data
    if isinstance(data, jax.core.Tracer):
        return
    meta = x._meta
    if meta.storage == STORAGE_INT:
        any_zero = bool(jnp.any(data == 0))
    else:
        any_zero = bool(jnp.any(jnp.all(data == 0, axis=0 if meta.storage_first else -1)))
    if any_zero:
        raise ZeroDivisionError("Cannot compute the multiplicative inverse of 0 in a Galois field.")


def _ufunc_method(self, ufunc, method, *inputs, **kwargs):
    """reduce / accumulate / reduceat / outer / at for the four arithmetic
    ufuncs (reference: tests/fields/test_numpy_ufuncs.py). These are
    utility paths, not hot loops, so they run on exact host integers via a
    real np.frompyfunc ufunc — every NumPy method semantics (axis,
    indices, in-place `at`) comes for free and divide-by-zero raises from
    the host field. add/multiply `reduce` stays on the device tree path
    (__array_ufunc__ above)."""
    name = ufunc.__name__
    if name in ("true_divide", "floor_divide", "divide"):
        opname = "divide"
    elif name in ("add", "subtract", "multiply"):
        opname = name
    else:
        raise ValueError(
            f"Ufunc method {method!r} is not supported on {name!r}. "
            "Only '__call__' is supported."
        )
    if method not in ("reduce", "accumulate", "reduceat", "outer", "at"):
        raise ValueError(
            f"Ufunc method {method!r} is not supported on {name!r}. "
            "Only '__call__' is supported."
        )
    cls = type(self)
    from ._hostfield import get_host_field

    hf = get_host_field(cls._meta)
    fn = np.frompyfunc(getattr(hf, opname), 2, 1)

    def conv(x):
        return np.asarray(cls(x) if not isinstance(x, FieldArray) else x, dtype=object)

    if method == "at":
        a, idx = inputs[0], inputs[1]
        arr = conv(a)
        if len(inputs) > 2:
            fn.at(arr, idx, conv(inputs[2]))
        else:
            fn.at(arr, idx)
        a[...] = cls(arr)  # write back: numpy's `at` mutates in place
        return None
    if method == "reduceat":
        a, idx = inputs[0], np.asarray(inputs[1], dtype=np.intp)
        out = fn.reduceat(conv(a), idx, **kwargs)
    elif method == "outer":
        out = fn.outer(conv(inputs[0]), conv(inputs[1]), **kwargs)
    else:  # reduce / accumulate
        out = getattr(fn, method)(conv(inputs[0]), **kwargs)
    return cls(out if isinstance(out, np.ndarray) else int(out))


# ----------------------------------------------------------------------
# python-calculate mode: exact host arithmetic
# ----------------------------------------------------------------------

def _python_op(meta: FieldMeta, opname: str):
    from ._hostfield import get_host_field

    hf = get_host_field(meta)

    def run(*arrays):
        if opname == "power":
            base = _storage_to_ints(meta, np.asarray(arrays[0])).astype(object)
            exps = np.asarray(arrays[1]).astype(object)  # plain integers
            out = np.frompyfunc(hf.power, 2, 1)(base, exps)
            return _ints_to_storage(meta, np.asarray(out, dtype=object))
        np_arrays = [
            _storage_to_ints(meta, np.asarray(a)).astype(object) for a in arrays
        ]
        if opname in ("add", "subtract", "multiply", "divide"):
            fn = getattr(hf, opname)
            out = np.frompyfunc(fn, 2, 1)(*np_arrays)
        elif opname in ("negative", "reciprocal", "sqrt"):
            if opname == "sqrt":
                fn = lambda a: _host_sqrt(hf, a)
            else:
                fn = getattr(hf, opname)
            out = np.frompyfunc(fn, 1, 1)(np_arrays[0])
        else:
            raise NotImplementedError(opname)
        return _ints_to_storage(meta, np.asarray(out, dtype=object))

    return run


def _python_power(meta: FieldMeta, data: np.ndarray, e: int):
    from ._hostfield import get_host_field

    hf = get_host_field(meta)
    ints = _storage_to_ints(meta, data).astype(object)
    out = np.frompyfunc(lambda a: hf.power(a, e), 1, 1)(ints)
    return _ints_to_storage(meta, np.asarray(out, dtype=object))


def _host_sqrt(hf, a: int) -> int:
    """Exact sqrt via exponentiation/Tonelli-Shanks on host ints."""
    q = hf.q
    if a == 0:
        return 0
    if hf.p == 2:
        return hf.power(a, q // 2)
    if q % 4 == 3:
        r = hf.power(a, (q + 1) // 4)
    elif q % 8 == 5:
        # Atkin: t = (2a)^((q-5)/8), i = 2a t^2, root = a t (i - 1)
        a2 = hf.add(a, a)
        t = hf.power(a2, (q - 5) // 8)
        i_val = hf.multiply(a2, hf.multiply(t, t))
        r = hf.multiply(hf.multiply(a, t), hf.subtract(i_val, 1))
    else:
        Q, S = q - 1, 0
        while Q % 2 == 0:
            Q //= 2
            S += 1
        z = hf.find_non_square()
        c = hf.power(z, Q)
        t = hf.power(a, Q)
        r = hf.power(a, (Q + 1) // 2)
        M = S
        while t != 1:
            i, tt = 0, t
            while tt != 1:
                tt = hf.multiply(tt, tt)
                i += 1
            b = c
            for _ in range(M - i - 1):
                b = hf.multiply(b, b)
            r = hf.multiply(r, b)
            c = hf.multiply(b, b)
            t = hf.multiply(t, c)
            M = i
    neg_r = hf.negative(r)
    return min(r, neg_r)
