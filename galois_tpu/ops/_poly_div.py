"""Batched polynomial floor-division by a static monic divisor.

Synthetic division with a fixed trip count — the device analogue of the
reference's divmod_jit (reference: src/galois/_polys/_dense.py:126-198),
used for non-systematic cyclic-code message recovery."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..fields._meta import FieldMeta
from ._kernels import get_ops


@functools.lru_cache(maxsize=64)  # bounded: see codes/_decoder.py::make_decoder
def _floordiv_kernel(meta: FieldMeta, mode: str, n: int, g_coeffs: tuple, ks: int):
    """Divide descending-coefficient rows (B, n) by monic g (len deg+1)."""
    ops = get_ops(meta, mode)
    from ..fields._array import _ints_to_storage_np

    g = np.asarray(
        _ints_to_storage_np(meta, np.asarray(list(g_coeffs), dtype=object))
    )  # (deg+1, [w]) descending

    @jax.jit
    def run(c):
        # c: (B, n) int / (B, n, m) digits / (w, B, n) planar limbs,
        # coefficients descending. Quotient has n - deg coeffs; return
        # the last `ks` of them... quotient degree = n-1-deg -> ks = n-deg.
        deg = len(g_coeffs) - 1
        ax = 2 if meta.storage_first else 1  # coefficient axis of r
        r = c
        qs = []
        gk = jnp.asarray(g)
        for i in range(n - deg):
            if meta.storage == "int":
                qi, qe = r[:, i], r[:, i][:, None]
            elif meta.storage_first:
                qi, qe = r[:, :, i], r[:, :, i][:, :, None]
            else:
                qi, qe = r[:, i, :], r[:, i, :][:, None, :]
            qs.append(qi)
            # r[i:i+deg+1] -= qi * g
            prod = ops.multiply(qe, gk)
            seg = jax.lax.dynamic_slice_in_dim(r, i, deg + 1, axis=ax)
            seg = ops.subtract(seg, prod)
            r = jax.lax.dynamic_update_slice_in_dim(r, seg, i, axis=ax)
        q = jnp.stack(qs, axis=ax)
        if ks >= q.shape[ax]:
            return q
        return jax.lax.slice_in_dim(q, q.shape[ax] - ks, q.shape[ax], axis=ax)

    return run


# bounded: see codes/_decoder.py::make_decoder — a Euclidean gcd chain over
# large dense polys shrinks degrees every iteration, so an unbounded cache
# would pin one executable per degree pair and exhaust vm.max_map_count
@functools.lru_cache(maxsize=64)
def _divmod_kernel(meta: FieldMeta, mode: str, n: int, m: int):
    """Synthetic division of one descending (n,[w]) poly by a monic
    descending (m,[w]) divisor, as a lax.scan with a fixed trip count —
    the device analogue of reference divmod_jit
    (src/galois/_polys/_dense.py:126-198) for large single polynomials.
    Returns (quotient (n-m+1,[w]), remainder (m-1 or 1,[w]))."""
    ops = get_ops(meta, mode)

    @jax.jit
    def run(a, b, inv_lead):
        # All scan state in limb-tuple form (identity for int storage): a
        # stacked (n, w) carry would relayout its w-limb minor axis at
        # every step.
        bt = ops.split_limbs(b)
        invt = ops.split_limbs(inv_lead)

        def step(r, i):
            qi = ops.tmap(
                lambda L: jax.lax.dynamic_index_in_dim(L, i, axis=0, keepdims=False), r
            )
            prod = ops.multiply_t(ops.tmap(lambda L: L[None], qi), bt)
            seg = ops.tmap(lambda L: jax.lax.dynamic_slice_in_dim(L, i, m, axis=0), r)
            seg = ops.subtract_t(seg, prod)
            r = ops.tmap(
                lambda L, S: jax.lax.dynamic_update_slice_in_dim(L, S, i, axis=0), r, seg
            )
            return r, qi

        r, qs = jax.lax.scan(step, ops.split_limbs(a), jnp.arange(n - m + 1))
        # b was normalized monic; un-scale the quotient by the true leading
        # coefficient's inverse: a = (q * lead) * b_monic + r.
        q = ops.multiply_t(qs, ops.tmap(lambda L: L[None], invt))
        rem = ops.tmap(
            (lambda L: L[n - m + 1 :]) if m > 1 else (lambda L: L[:1] * 0), r
        )
        return ops.join_limbs(q), ops.join_limbs(rem)

    return run


def poly_divmod_device(a_poly, b_poly):
    """Divmod of two Polys on device (dense, any storage kind).

    Used by Poly.__divmod__/__mod__/__floordiv__ above a degree threshold;
    the host synthetic division (polys/_hostpoly.py) stays authoritative
    for small polys and python-calculate mode.
    """
    from ..polys._poly import Poly

    field = a_poly.field
    meta = field._meta
    mode = field._mode if field._mode != "python-calculate" else meta.default_ufunc_mode
    ops = get_ops(meta, mode)
    deg_a, deg_b = a_poly.degree, b_poly.degree
    if deg_a < deg_b:
        return Poly.Zero(field), a_poly
    a = field(a_poly.coefficients())  # descending dense
    b = field(b_poly.coefficients())
    lead = b[0]
    lead_data = b._data[:, 0] if meta.storage_first else b._data[0]
    inv_lead = ops.reciprocal(lead_data)
    if int(lead) != 1:
        # inv_lead broadcasts against the coefficient axis elementwise in
        # every storage layout (scalar / (m,) digit vector / (w,) planar).
        b_monic = field._view(ops.multiply(b._data, inv_lead), b._dtype)
    else:
        b_monic = b
    q_data, r_data = _divmod_kernel(meta, mode, deg_a + 1, deg_b + 1)(
        a._data, b_monic._data, inv_lead
    )
    q = Poly(field._view(q_data, a._dtype))
    r = Poly(field._view(r_data, a._dtype))
    return q, r


def batched_floordiv(codeword, g_poly, ks: int):
    """codeword: FieldArray (B, n); returns quotient messages (B, ks)."""
    cls = type(codeword)
    meta = cls._meta
    mode = cls._mode if cls._mode != "python-calculate" else meta.default_ufunc_mode
    n = codeword.shape[-1]
    g_desc = tuple(int(v) for v in np.asarray(g_poly.coefficients(), dtype=object))
    out = _floordiv_kernel(meta, mode, n, g_desc, ks)(codeword._data)
    return cls._view(out, codeword._dtype)
