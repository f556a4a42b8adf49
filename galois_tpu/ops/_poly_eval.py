"""Batched polynomial evaluation on device.

Horner's rule as a lax.scan over the (static-length) coefficient sequence —
the device counterpart of the reference's prange-parallel elementwise kernel
(reference: src/galois/_polys/_dense.py:404-440). Coefficients travel as a
small device array; the element array can be arbitrarily large/sharded.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..fields._meta import STORAGE_INT, FieldMeta
from ._kernels import get_ops

__all__ = ["evaluate", "evaluate_data"]


@functools.lru_cache(maxsize=None)
def _eval_kernel(meta: FieldMeta, mode: str):
    ops = get_ops(meta, mode)
    storage_nd = 0 if meta.storage == STORAGE_INT else 1

    @jax.jit
    def run(coeffs, x):
        # coeffs arrive in storage layout; normalize to SCAN layout with the
        # coefficient axis leading (planar limb arrays are (w, n) — move the
        # limb axis behind the scanned axis so lax.scan slices coefficients).
        # x: storage layout. All scan carries go through the limb-tuple
        # protocol (identity for int storage) so limb fields keep full-lane
        # layouts across steps.
        if meta.storage_first:
            coeffs = jnp.moveaxis(coeffs, 0, -1)  # (n, w)

            def split_scan(c):
                return ops.split_limbs(jnp.moveaxis(c, -1, 0))
        else:
            split_scan = ops.split_limbs
        n = coeffs.shape[0]
        xt = ops.split_limbs(x)
        if n < 64:
            def body(acc, c):
                return ops.add_t(ops.multiply_t(acc, xt), split_scan(c)), None

            acc0 = ops.split_limbs(ops.zero_like(x))
            acc, _ = jax.lax.scan(body, acc0, coeffs)
            return ops.join_limbs(acc)

        # Two-level Horner: f(x) = sum_i C_i(x) * (x^c)^i with k chunks of c
        # coefficients. Sequential depth drops from n to ~c + k + 2 log2 c
        # (~2 sqrt(n)); the inner scan is batched over all k chunks, so each
        # step does k times the elementwise work — same total FLOPs, far
        # fewer latency-bound scan steps.
        import math

        c = max(1, math.isqrt(n))
        k = -(-n // c)
        m = k * c
        asc = jnp.flip(coeffs, axis=0)  # ascending degrees
        pad = [(0, m - n)] + [(0, 0)] * storage_nd
        asc = jnp.pad(asc, pad)  # high-degree zero padding
        B = asc.reshape((k, c) + asc.shape[1:])  # B[i, j] = coeff of x^(i*c+j)
        Bj = jnp.flip(jnp.moveaxis(B, 1, 0), axis=0)  # (c, k, [w]) descending j

        elem_nd = x.ndim - storage_nd
        xb = ops.tmap(lambda L: L[None], xt)  # (1, ..., [w]) broadcast vs k

        def inner(acc, cj):
            # acc: (k, ...[, w]) tuple-limbs; cj: (k, [w]) -> broadcast over x dims
            cjb = ops.tmap(
                lambda L: L[(slice(None),) + (None,) * elem_nd], split_scan(cj)
            )
            return ops.add_t(ops.multiply_t(acc, xb), cjb), None

        acc0 = ops.tmap(lambda L: jnp.zeros((k,) + L.shape, dtype=L.dtype), xt)
        A, _ = jax.lax.scan(inner, acc0, Bj)  # (k, ...) tuple: chunk values

        # y = x^c by square-and-multiply on the static exponent
        y = None
        sq = xt
        e = c
        while e:
            if e & 1:
                y = sq if y is None else ops.multiply_t(y, sq)
            e >>= 1
            if e:
                sq = ops.multiply_t(sq, sq)

        def outer(out, Ai):
            return ops.add_t(ops.multiply_t(out, y), Ai), None

        out0 = ops.split_limbs(ops.zero_like(x))
        out, _ = jax.lax.scan(
            outer, out0, ops.tmap(lambda L: jnp.flip(L, axis=0), A)
        )
        return ops.join_limbs(out)

    return run


def evaluate(poly, x):
    """Evaluate `poly` at FieldArray `x` elementwise; returns a FieldArray."""
    cls = type(x)
    meta = cls._meta
    mode = cls._mode
    if mode == "python-calculate":
        from ..fields._hostfield import get_host_field
        from ..polys import _hostpoly as hp

        hf = get_host_field(meta)
        asc = poly._asc()
        xi = np.asarray(x, dtype=object)
        out = np.frompyfunc(lambda v: hp.evaluate(hf, asc, int(v)), 1, 1)(xi)
        return cls(out if xi.ndim else int(out))

    poly._ensure_terms()
    coeffs_desc = [0] * (poly.degree + 1)
    for d, c in zip(poly._degrees, poly._coeffs):
        coeffs_desc[poly.degree - d] = c
    carr = _coeffs_to_device(meta, coeffs_desc)
    scalar = x.ndim == 0
    data = x._data
    if scalar:
        data = data[:, None] if meta.storage_first else data[None]
    out = _eval_kernel(meta, mode)(carr, data)
    if scalar:
        out = out[:, 0] if meta.storage_first else out[0]
    return cls._view(out, x._dtype)


def evaluate_data(meta, mode, coeffs_desc, data):
    """Raw-data variant for internal callers."""
    carr = _coeffs_to_device(meta, list(coeffs_desc))
    return _eval_kernel(meta, mode)(carr, data)


def _coeffs_to_device(meta: FieldMeta, coeffs_desc):
    from ..fields._array import _ints_to_storage

    return _ints_to_storage(meta, np.asarray(coeffs_desc, dtype=object))
