"""Finite-field convolution (np.convolve replacement).

Strategies (reference counterpart: src/galois/_domains/_function.py:111-167):
- prime fields: an exact elementwise shift-multiply-accumulate in 64-bit
  lanes;
- any field: scan of shifted field multiply-adds;
- large same-length inputs over NTT-friendly fields: via the field FFT
  (poly mul via NTT — SURVEY §7 M3).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..fields._meta import STORAGE_INT, FieldMeta
from ._kernels import get_ops

__all__ = ["convolve"]


def convolve(a, b, mode: str = "full"):
    from ..fields._array import FieldArray

    if not isinstance(a, FieldArray) and not isinstance(b, FieldArray):
        raise TypeError("At least one argument must be a FieldArray.")
    cls = type(a) if isinstance(a, FieldArray) else type(b)
    a = a if isinstance(a, FieldArray) else cls(a)
    b = b if isinstance(b, FieldArray) else cls(b)
    if mode != "full":
        raise ValueError(f"Argument 'mode' must be 'full', not {mode!r} (matching the reference).")
    if a.ndim != 1 or b.ndim != 1:
        raise ValueError("Arguments must be 1-D arrays.")

    meta = cls._meta
    kmode = cls._mode if cls._mode != "python-calculate" else meta.default_ufunc_mode
    out = _convolve_data(meta, kmode, a._data, b._data)
    return cls._view(out, a._dtype)


def _ntt_size(meta: FieldMeta, out_len: int):
    """Smallest NTT-friendly transform size N >= out_len with N | q-1 and
    largest radix <= 64, or None."""
    from ..nt import factors as int_factors

    q1 = meta.order - 1
    best = None
    # search among divisors of q-1 built from its small prime factors
    primes, exps = int_factors(q1)
    small = [(p, e) for p, e in zip(primes, exps) if p <= 64]
    divs = [1]
    for p, e in small:
        divs = [d * p**k for d in divs for k in range(e + 1)]
    for d in sorted(divs):
        if d >= out_len:
            best = d
            break
    return best


@functools.partial(jax.jit, static_argnums=(0, 1))
def _convolve_data(meta: FieldMeta, mode: str, a, b):
    ops = get_ops(meta, mode)
    # coefficient axis within the storage array: axis 1 under a planar
    # leading limb axis, else axis 0
    ax = 1 if meta.storage_first else 0
    n = a.shape[ax]
    m = b.shape[ax]
    if m > n:
        a, b = b, a
        n, m = m, n

    # NTT fast path: for large inputs over NTT-friendly fields, multiply in
    # the frequency domain (poly mul via NTT — SURVEY §7 M3).
    out_len = n + m - 1
    if m >= 64 and meta.storage == STORAGE_INT:
        N = _ntt_size(meta, out_len)
        if N is not None and N * (N.bit_length() + 4) < n * m:
            from ._ntt import fft_data
            from ..fields import _factory

            cls = _factory._make_class(
                meta.characteristic, meta.degree,
                meta.irreducible_poly_int, meta.primitive_element_int,
            )
            pad_a = jnp.concatenate([a, jnp.zeros((N - n,) + a.shape[1:], a.dtype)])
            pad_b = jnp.concatenate([b, jnp.zeros((N - m,) + b.shape[1:], b.dtype)])
            A = fft_data(cls, pad_a, N)
            B = fft_data(cls, pad_b, N)
            C = ops.multiply(A, B)
            out = fft_data(cls, C, N, inverse=True)
            return out[:out_len]

    p = meta.characteristic
    if meta.degree == 1 and p != 2 and meta.storage == STORAGE_INT and m * (p - 1) ** 2 < 2**63:
        # Exact integer accumulation, one shifted MAC per tap of the shorter
        # input — m elementwise fused ops (vs the reference's BLAS + overflow
        # check, src/galois/_domains/_function.py:111-167).
        a64 = a.astype(jnp.int64)
        b64 = b.astype(jnp.int64)
        acc = jnp.zeros(n + m - 1, dtype=jnp.int64)
        for j in range(m):
            acc = acc.at[j : j + n].add(a64 * b64[j])
        return (acc % p).astype(a.dtype)

    # Generic path: field multiply-accumulate of shifted copies.
    out_shape = list(a.shape)
    out_shape[ax] = n + m - 1
    acc = jnp.zeros(tuple(out_shape), dtype=a.dtype)
    for j in range(m):
        bj = b[:, j] if ax else b[j]
        prod = ops.multiply(a, bj)
        seg = jax.lax.dynamic_slice_in_dim(acc, j, n, axis=ax)
        acc = jax.lax.dynamic_update_slice_in_dim(acc, ops.add(seg, prod), j, axis=ax)
    return acc
